"""The mesh's entry points on the card and over NCCL
(pocket_tts_tpu_torch/parallel/launch.py, parallel/dryrun.py), on a machine
with no card: how a group resolves its backend and device, what it refuses
before spawning a process, how a rank takes its card and its process group
(driven in process, torch.distributed stubbed), that the ranks load the
kernel library from the caller's build directory, that `close` ends a rank
stuck in a job; and a data 4 x model 1 mesh of gloo CPU ranks (the
data-only shape, which tests/test_torch_sharding.py does not run) against
the JAX package's `make_mesh(data=4, model=1)` GSPMD mesh on the virtual
CPU devices conftest.py sets.

The 4 x 1 group is module-scoped: four ranks, each priming, prefilling and
serving its own lanes at tiny_config(64); the module takes ~60-90 s of one
worker. Inputs come from numpy seeds, f32, temp 0. Tolerances: 1e-4
absolute with float caches (the port's end-to-end tolerance and the JAX
sharded tests'); 1e-3 relative to max |pcm| with int8 KV caches (a value
within an ulp of an int8 rounding boundary quantizes one step apart when
a sum runs in another order); 2e-3 absolute for the shared-prefix server
(the JAX package's own bound, tests/test_sharding.py)."""
import dataclasses
import datetime
import inspect
import time

import numpy as np
import jax
import pytest
import torch

import _torch_mesh_ranks as ranks
import chip_smoke
from pocket_tts_tpu.config import tiny_config
from pocket_tts_tpu.io.params import params_from_flat, random_flat
from pocket_tts_tpu.parallel.sharding import make_mesh as jmake_mesh
from pocket_tts_tpu.runtime.engine import TTSEngine as JEngine
from pocket_tts_tpu.runtime.server import ContinuousBatchingServer as JCBS
from pocket_tts_tpu_torch.config import tiny_config as ttiny_config
from pocket_tts_tpu_torch.io.params import from_jax_numpy
from pocket_tts_tpu_torch.io.params import params_from_flat as tparams
from pocket_tts_tpu_torch.io.params import random_flat as trandom_flat
from pocket_tts_tpu_torch.io.params import random_voice_prompt
from pocket_tts_tpu_torch.ops import cuda_lib
from pocket_tts_tpu_torch.parallel import dryrun, launch, sharding
from pocket_tts_tpu_torch.text.tokenizer import MockTokenizer

torch.set_num_threads(1)
ATOL = 1e-4
KV8_REL = 1e-3
SERVER_ATOL = 2e-3


# ------------------------------------------- resolution and refusals ---

ENTRY_POINTS = {"RankGroup": launch.RankGroup, "launch": launch.launch,
                "dryrun_multichip": dryrun.dryrun_multichip}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_points_default_to_the_card_and_nccl(name, monkeypatch):
    """device "cuda" and backend None, which resolves to NCCL there (to
    gloo on the CPU)."""
    params = inspect.signature(ENTRY_POINTS[name]).parameters
    assert params["device"].default == "cuda"
    assert params["backend"].default is None
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert launch.resolve(1, 1) == ("nccl", "cuda")
    assert launch.resolve(1, 1, None, "cpu") == ("gloo", "cpu")


@pytest.fixture
def no_spawn(monkeypatch):
    """Fail the test if anything starts a rank or builds the kernels."""
    def spawn(*a, **k):
        raise AssertionError("a rank was spawned")

    def build():
        raise AssertionError("the kernel library was built")

    monkeypatch.setattr(launch.mp, "get_context", spawn)
    monkeypatch.setattr(cuda_lib, "library", build)


@pytest.mark.parametrize("call", [
    lambda: launch.RankGroup(2, 2),
    lambda: launch.launch(ranks.fail_on_rank1, 2, 2),
    lambda: dryrun.dryrun_multichip(4)], ids=sorted(ENTRY_POINTS))
def test_the_default_raises_before_spawning_without_cards(no_spawn, call):
    """Without a card, NCCL on "cuda" (the default) refuses the four
    ranks, naming the counts, before any process starts."""
    assert torch.cuda.device_count() == 0
    with pytest.raises(ValueError, match="4 ranks and this machine 0 cards"):
        call()


def test_nccl_on_the_cpu_raises(no_spawn):
    with pytest.raises(ValueError, match="2 x 2 mesh of 4 ranks on device "
                                         "'cpu' takes backend 'gloo'"):
        launch.RankGroup(2, 2, backend="nccl", device="cpu")


@pytest.mark.parametrize("shape", [(2, 2), (1, 4), (4, 1), (1, 3)])
def test_more_ranks_than_cards_raise(no_spawn, monkeypatch, shape):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    world = shape[0] * shape[1]
    with pytest.raises(ValueError, match=f"{shape[0]} x {shape[1]} mesh has "
                                         f"{world} ranks and this machine "
                                         "2 cards"):
        launch.resolve(*shape)
    with pytest.raises(ValueError, match=f"{world} ranks"):
        launch.launch(ranks.fail_on_rank1, *shape, backend="nccl")


@pytest.mark.parametrize("shape", [(1, 1), (2, 2), (1, 4), (4, 1)])
def test_nccl_with_a_card_a_rank_resolves(monkeypatch, shape):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert launch.resolve(*shape) == ("nccl", "cuda")


def test_gloo_on_the_card_is_accepted_as_named():
    """Several ranks on one card (chip_smoke.py's phase 11) name gloo; no
    card is needed to resolve it, and nothing switches it to NCCL."""
    assert launch.resolve(2, 2, "gloo", "cuda") == ("gloo", "cuda")
    assert launch.resolve(4, 2, "gloo", "cpu") == ("gloo", "cpu")


@pytest.mark.parametrize("kw,match", [
    (dict(backend="mpi"), "backend 'mpi'"),
    (dict(device="cuda:1"), "device 'cuda:1'")])
def test_unknown_backend_or_device_raises(kw, match):
    with pytest.raises(ValueError, match=match):
        launch.resolve(1, 2, **kw)


def test_a_failed_build_raises_before_spawning(monkeypatch):
    """With device "cuda" the caller builds the kernels once before the
    ranks start; nvcc's failure is raised there and no rank starts."""
    def spawn(*a, **k):
        raise AssertionError("a rank was spawned")

    def build():
        raise RuntimeError("nvcc failed:\nerror: something")

    monkeypatch.setattr(launch.mp, "get_context", spawn)
    monkeypatch.setattr(cuda_lib, "library", build)
    with pytest.raises(RuntimeError, match="nvcc failed:\nerror: something"):
        launch.RankGroup(2, 2, backend="gloo", device="cuda")


class _Conn:
    """The rank's end of its pipe: no job, then the close signal."""
    def __init__(self):
        self.sent = []

    def send(self, x):
        self.sent.append(x)

    def recv(self):
        return None


def _rank_in_process(monkeypatch, rank, world, backend, device, cards):
    calls = {}
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    monkeypatch.setattr(torch.cuda, "set_device",
                        lambda d: calls.setdefault("card", d))
    monkeypatch.setattr(torch.distributed, "init_process_group",
                        lambda b, **kw: calls.update(backend=b, **kw))
    monkeypatch.setattr(torch.distributed, "destroy_process_group",
                        lambda: calls.setdefault("destroyed", True))
    monkeypatch.setattr(sharding, "make_mesh",
                        lambda d, m, device_type: ("mesh", d, m,
                                                   device_type))
    monkeypatch.setattr(cuda_lib, "set_build_dir",
                        lambda p: calls.setdefault("build_dir", p))
    conn = _Conn()
    launch._rank_main(rank, world, world, 1, backend, device, "/x/rdv", 0,
                      123.0, "/x/build", conn)
    return calls, conn.sent


@pytest.mark.parametrize("rank", range(4))
def test_an_nccl_rank_takes_its_card(monkeypatch, rank):
    """Under NCCL rank r sets card r before the process group, hands it
    device_id (NCCL's communicator then forms at start), a timeout, the
    caller's build directory; it destroys the group on close."""
    calls, sent = _rank_in_process(monkeypatch, rank, 4, "nccl", "cuda", 4)
    assert calls["card"] == rank
    assert calls["device_id"] == torch.device("cuda", rank)
    assert calls["backend"] == "nccl" and calls["rank"] == rank
    assert calls["world_size"] == 4
    assert calls["timeout"] == datetime.timedelta(seconds=123.0)
    assert calls["init_method"] == "file:///x/rdv"
    assert calls["build_dir"] == "/x/build" and calls["destroyed"]
    assert sent == [("ready", None)]


def test_gloo_ranks_share_the_cards(monkeypatch):
    """gloo on "cuda": rank r on card r % cards, no device_id."""
    calls, sent = _rank_in_process(monkeypatch, 3, 4, "gloo", "cuda", 2)
    assert calls["card"] == 1 and "device_id" not in calls
    assert sent == [("ready", None)]


class _FakeProcess:
    started = []

    def __init__(self, target, daemon, args):
        self.args = args

    def start(self):
        _FakeProcess.started.append(self.args)


class _FakeContext:
    Process = _FakeProcess

    @staticmethod
    def Pipe():
        return _Conn(), _Conn()


@pytest.mark.parametrize("timeout", [60.0, 300.0, 900.0])
def test_the_ranks_get_a_shorter_timeout_and_the_build_dir(monkeypatch,
                                                           timeout):
    """Each rank's process group times out before the caller's deadline
    (a collective a failed rank never joins then ends as an error on the
    others, not as a kill), and every rank is handed the caller's build
    directory; the ranks' arguments as the group spawns them."""
    _FakeProcess.started.clear()
    monkeypatch.setattr(launch.mp, "get_context", lambda m: _FakeContext)
    monkeypatch.setattr(launch.RankGroup, "_collect", lambda self, w: [])
    monkeypatch.setattr(_Conn, "close", lambda self: None, raising=False)
    grp = launch.RankGroup(1, 4, device="cpu", timeout=timeout)
    grp._procs = []
    grp.close()
    assert [a[0] for a in _FakeProcess.started] == [0, 1, 2, 3]
    for args in _FakeProcess.started:
        rank, world, data, model, backend, device = args[:6]
        assert (world, data, model, backend, device) == (4, 1, 4, "gloo",
                                                         "cpu")
        pg_timeout, build_dir = args[8], args[9]
        assert 0 < pg_timeout < timeout
        assert build_dir == cuda_lib.build_dir()


def test_close_ends_a_rank_stuck_in_a_job(monkeypatch):
    """A rank that never leaves its job (as one waiting in a collective)
    is killed by close after the grace period; close(kill=True) kills at
    once."""
    monkeypatch.setattr(launch, "CLOSE_GRACE", 2.0)
    grp = launch.RankGroup(1, 2, device="cpu", timeout=120)
    procs = list(grp._procs)
    for conn in grp._conns:
        conn.send((ranks.stall_job, (600,)))
    t0 = time.monotonic()
    grp.close()
    assert time.monotonic() - t0 < 60
    assert not any(p.is_alive() for p in procs)
    grp = launch.RankGroup(1, 2, device="cpu", timeout=120)
    procs = list(grp._procs)
    for conn in grp._conns:
        conn.send((ranks.stall_job, (600,)))
    grp.close(kill=True)
    assert not any(p.is_alive() for p in procs)
    assert all(p.exitcode == -9 for p in procs)


# -------------------------------------------------- the 4 x 1 mesh ---

def models(width):
    cfg0 = tiny_config(width)
    pj, cfg = params_from_flat(random_flat(cfg0, seed=13, scale=0.05), cfg0)
    pnp = ranks.to_numpy(from_jax_numpy(jax.tree.map(np.asarray, pj)))
    _, tcfg = tparams(trandom_flat(ttiny_config(width), seed=13),
                      ttiny_config(width))
    return pj, cfg, pnp, tcfg


PJ, CFG, PNP, TCFG = models(64)
BUILD_DIR = "/nonexistent/ptt_build_for_the_ranks"


@pytest.fixture(scope="module")
def mesh41():
    """data 4 x model 1 gloo ranks, started while the caller's build
    directory is BUILD_DIR (restored after)."""
    old = cuda_lib.build_dir()
    cuda_lib.set_build_dir(BUILD_DIR)
    try:
        group = launch.RankGroup(4, 1, device="cpu", timeout=300)
    finally:
        cuda_lib.set_build_dir(old)
    with group:
        yield group


def test_the_ranks_take_the_callers_build_directory(mesh41):
    assert mesh41.run(ranks.build_dir_job) == [BUILD_DIR] * 4


def test_mesh_cfg_on_a_data_only_mesh(mesh41):
    """model 1: both parts carry the mesh at their full head counts, the
    kernels keep their routes (no part pinned plain), and the fused layer
    kernels stay off (`sharding.fusable`, JAX's `mesh is None`)."""
    for got in mesh41.run(ranks.mesh_cfg_job, PNP, TCFG):
        assert got["backbone_mesh"] and got["mimi_mesh"]
        assert got["backbone_pallas"] is None and got["mimi_pallas"] is None
        assert got["heads"] == (TCFG.backbone.num_heads,
                                TCFG.mimi.transformer.num_heads)
        assert got["on_mesh"] and got["seanet_mesh"]
        assert got["servers_through_mesh_cfg"]


VOICES = {"va": random_voice_prompt(TCFG, 12, seed=1),
          "vb": random_voice_prompt(TCFG, 16, seed=2)}
# eight lanes, two a rank: six requests, one chunk, then four more (two
# into the free lanes at once, two when the shortest finish)
REQS = [("A mesh lane decodes this.", "va"), ("Another voice joins.", "vb"),
        ("Short.", "va"), ("Tiny one.", "vb"),
        ("A longer request keeps its lane.", "va"), ("Two words.", "vb"),
        ("A seventh joins mid decode.", "va"), ("And an eighth.", "vb"),
        ("Ninth waits for a lane.", "va"), ("Tenth as well.", "vb")]
SERVING = dict(quantize="int4", quantize_kv=True)


def cap256(cfg):
    return dataclasses.replace(cfg, backbone=dataclasses.replace(
        cfg.backbone, kv_capacity=256))


def _jax_server(engine_kw):
    """The JAX package's shared-prefix server on make_mesh(data=4,
    model=1) (GSPMD over four virtual CPU devices), eight lanes, REQS at
    temp 0 as server_job submits them."""
    jeng = JEngine(params=PJ, cfg=cap256(CFG), seed=0,
                   tokenizer=MockTokenizer(CFG.lut.n_bins), **engine_kw)
    mesh = jmake_mesh(data=4, model=1, devices=jax.devices()[:4])
    jsrv = JCBS(jeng, lanes=8, chunk_frames=4, text_bucket=32, mesh=mesh,
                share_prefix=True)
    jsrv.register_voices({k: np.asarray(v) for k, v in VOICES.items()})
    jreqs = [jsrv.submit(t, v, temp=0.0) for t, v in REQS[:6]]
    jsrv.step()
    jreqs += [jsrv.submit(t, v, temp=0.0) for t, v in REQS[6:]]
    jsrv.run_pending()
    return jreqs


@pytest.mark.parametrize("engine_kw", [{}, SERVING],
                         ids=["float", "serving-mode"])
def test_data4_server_matches_jax(mesh41, engine_kw):
    """The shared-prefix continuous server on the 4 x 1 mesh (two lanes a
    rank, four requests admitted after the first chunk, two of them once
    lanes free) against the JAX package's server on its 4 x 1 mesh: the
    same admissions, every rank the same audio; float weights within
    2e-3 (the JAX package's bound for the shared server), the serving
    mode (int4 weights, int8 KV) also within 1e-3 of the peak. No fused
    kernel runs, and model 1 adds no collective but the chunk's
    gathers."""
    jreqs = _jax_server(engine_kw)
    outs = mesh41.run(ranks.server_job, PNP, cap256(TCFG), VOICES, REQS, 6,
                      8, dict(share_prefix=True), engine_kw)
    late = [r.admit_step for r in jreqs if r.admit_step]
    assert len(late) >= 4 and max(late) > 1
    for o in outs:
        assert o["lanes"] == 2 and o["width"] == CFG.backbone.d_model
        assert o["admit"] == [r.admit_step for r in jreqs]
        for i, (a, r) in enumerate(zip(o["pcm"], jreqs)):
            want = np.asarray(r.pcm)
            assert a.shape == want.shape and a.size, (i, a.shape, want.shape)
            np.testing.assert_allclose(a, want, atol=SERVER_ATOL, rtol=0,
                                       err_msg=f"req {i}")
            if engine_kw:
                scale = np.abs(want).max()
                np.testing.assert_allclose(a / scale, want / scale,
                                           atol=KV8_REL, rtol=0)
        for a, b in zip(o["pcm"], outs[0]["pcm"]):
            np.testing.assert_array_equal(a, b)   # every rank, same audio
        assert all(o["calls"][k] == 0 for k in ("K5a", "K5b", "K5c", "K8",
                                                "K6")), o["calls"]
        if engine_kw:
            assert o["calls"]["K4b"] > 0


def test_data4_frame_steps_match_jax(mesh41):
    """Three batched frame steps of four lanes, one a rank, against JAX's
    sharded step on its 4 x 1 mesh (the whole batch primed and prefilled,
    then sharded): no "model" collective, no gather inside a step."""
    from test_torch_sharding_quant import jax_steps, port_steps
    want_pcm, want_valid = jax_steps(PJ, CFG, "int8", (4, 1), 3)
    pcm, valid, outs = port_steps(mesh41, PNP, TCFG, "int8", 3)
    np.testing.assert_array_equal(valid, want_valid)
    np.testing.assert_allclose(pcm, want_pcm, atol=ATOL, rtol=0)
    for o in outs:
        assert o["block"][1] - o["block"][0] == 1
        assert o["reduces_per_frame"] == 0 and o["gathers_per_frame"] == 0
        assert o["calls_per_frame"]["K4a"] == chip_smoke.mesh_k4_calls(
            ranks.params(PNP, "int8"))[0]
