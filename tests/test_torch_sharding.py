"""Sharded serving in the port (pocket_tts_tpu_torch/parallel/) on a CPU
mesh of gloo ranks, against the JAX package's GSPMD mesh on the 8 virtual
CPU devices conftest.py sets.

One group of four ranks (data 2 x model 2) serves the module, and one of
1 x 4 the cases where the tiny mimi's 2 heads do not divide "model"
(parallel.launch.RankGroup; the jobs are in tests/_torch_mesh_ranks.py,
which loads no JAX). Inputs are made from numpy seeds at tiny_config,
f32, temp 0 (the two packages draw noise apart). Tolerances: 1e-4
absolute with float caches (the port's end-to-end tolerance, and the JAX
sharded tests'); 1e-3 relative to max |pcm| with int8 KV caches (a value
within an ulp of an int8 rounding boundary quantizes one step apart when
the sums run in another order: ROADMAP, "checks each slice's parity tests
keep"); 2e-3 absolute for the shared-prefix server (the JAX package's own
bound, tests/test_sharding.py)."""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import _torch_mesh_ranks as ranks
from pocket_tts_tpu.config import tiny_config
from pocket_tts_tpu.io.params import params_from_flat, random_flat
from pocket_tts_tpu.models import backbone as jbackbone
from pocket_tts_tpu.models import mimi as jmimi
from pocket_tts_tpu.parallel.sharding import make_mesh as jmake_mesh
from pocket_tts_tpu.parallel.sharding import \
    shard_batched_state as jshard_state
from pocket_tts_tpu.parallel.sharding import shard_params as jshard_params
from pocket_tts_tpu.runtime import batched as jb
from pocket_tts_tpu.runtime.engine import TTSEngine as JEngine
from pocket_tts_tpu.runtime.server import ContinuousBatchingServer as JCBS
from pocket_tts_tpu.text.tokenizer import MockTokenizer as JMock
from pocket_tts_tpu_torch.config import tiny_config as ttiny_config
from pocket_tts_tpu_torch.io.params import from_jax_numpy
from pocket_tts_tpu_torch.io.params import params_from_flat as tparams
from pocket_tts_tpu_torch.io.params import random_flat as trandom_flat
from pocket_tts_tpu_torch.io.params import random_voice_prompt
from pocket_tts_tpu_torch.parallel import launch, sharding
from pocket_tts_tpu_torch.parallel.sharding import Shard
from pocket_tts_tpu_torch.runtime import batched as tb
from pocket_tts_tpu_torch.runtime.engine import TTSEngine
from pocket_tts_tpu_torch.runtime.server import (ContinuousBatchingServer,
                                                 MultiStreamServer)
from pocket_tts_tpu_torch.text.tokenizer import MockTokenizer

torch.set_num_threads(1)
ATOL = 1e-4
KV8_REL = 1e-3
SERVER_ATOL = 2e-3
CFG0 = tiny_config()
PJ, CFG = params_from_flat(random_flat(CFG0, seed=13), CFG0)
PT = from_jax_numpy(jax.tree.map(np.asarray, PJ))
PNP = ranks.to_numpy(PT)
_, TCFG = tparams(trandom_flat(ttiny_config(), seed=13), ttiny_config())
B = 4
PROMPT_LENS = np.asarray([16, 12, 9, 16], np.int32)
TOKEN_LENS = np.asarray([12, 7, 12, 10], np.int32)
FAE = np.asarray([3, 3, 2, 4], np.int32)
MAX_STEPS = np.asarray([50, 2, 50, 50], np.int32)   # lane 1 stops early


def quantize_kv(cfg):
    """int8 KV on both transformers, mimi capacity 64 (the JAX test's);
    the packages' cfgs alike."""
    return dataclasses.replace(
        cfg, backbone=dataclasses.replace(cfg.backbone, quantize_kv=True),
        mimi=dataclasses.replace(cfg.mimi, transformer=dataclasses.replace(
            cfg.mimi.transformer, quantize_kv=True, capacity=64)))


def pallas_cfg(cfg):
    """The JAX cfg with its kernels on (interpret mode on the CPU), as
    tests/test_sharding.py runs its sharded reference."""
    return dataclasses.replace(
        cfg, backbone=dataclasses.replace(cfg.backbone, use_pallas_attn=True),
        mimi=dataclasses.replace(
            cfg.mimi, transformer=dataclasses.replace(
                cfg.mimi.transformer, use_pallas_attn=True),
            seanet=dataclasses.replace(cfg.mimi.seanet, use_pallas=True)))


def inputs(cfg):
    rng = np.random.RandomState(7)
    prompts = np.zeros((B, 16, cfg.backbone.d_model), np.float32)
    for i, n in enumerate(PROMPT_LENS):
        prompts[i, :n] = rng.randn(n, cfg.backbone.d_model) * 0.05
    tokens = np.zeros((B, 16), np.int64)
    for i, n in enumerate(TOKEN_LENS):
        tokens[i, :n] = rng.randint(0, cfg.lut.n_bins, n)
    return prompts, tokens


def jax_steps(cfg, mesh_shape, n_frames):
    """JAX: the whole batch primed and prefilled, then sharded
    (shard_params, shard_batched_state) with mesh_cfg on its kernels, and
    n_frames of batched_frame_step at temp 0."""
    prompts, tokens = inputs(cfg)
    st = jb.stack_states([jbackbone.init_state(cfg.backbone)
                          for _ in range(B)])
    vs = jb.batched_prime_voice(PJ, cfg, st, jnp.asarray(prompts),
                                jnp.asarray(PROMPT_LENS))
    states = jb.batched_sentence_prefill(
        PJ, cfg, vs, jmimi.init_state(cfg.mimi),
        jnp.asarray(tokens, jnp.int32), jnp.asarray(TOKEN_LENS))
    data, model = mesh_shape
    mesh = jmake_mesh(data=data, model=model,
                      devices=jax.devices()[:data * model])
    cfg_m = jb.mesh_cfg(pallas_cfg(cfg), mesh)
    p_sh, st_sh = jshard_params(PJ, mesh), jshard_state(states, mesh)
    rngs = jnp.stack([jax.random.PRNGKey(i) for i in range(B)])
    args = (jnp.zeros((B,), jnp.float32), jnp.asarray(FAE),
            jnp.asarray(MAX_STEPS))
    pcms, valids = [], []
    for _ in range(n_frames):
        st_sh, pcm, valid = jb.batched_frame_step(p_sh, cfg_m, st_sh, rngs,
                                                  *args)
        pcms.append(np.asarray(pcm))
        valids.append(np.asarray(valid))
    return np.stack(pcms), np.stack(valids)


def port_steps(group, cfg, n_frames):
    prompts, tokens = inputs(cfg)
    outs = group.run(ranks.frame_steps_job, PNP, cfg, prompts,
                     tokens, PROMPT_LENS, TOKEN_LENS, FAE, MAX_STEPS,
                     n_frames)
    pcm = np.zeros((n_frames, B, CFG.mimi.frame_size), np.float32)
    valid = np.zeros((n_frames, B), bool)
    for o in outs:
        lo, hi = o["block"]
        pcm[:, lo:hi], valid[:, lo:hi] = o["pcm"], o["valid"]
    return pcm, valid, outs


def same_within_model_groups(outs):
    """The ranks of each "model" group returned the same bits."""
    by_data = {}
    for o in outs:
        by_data.setdefault(o["coords"][1], []).append(o)
    for group in by_data.values():
        for o in group[1:]:
            np.testing.assert_array_equal(o["pcm"], group[0]["pcm"])


@pytest.fixture(scope="module")
def mesh22():
    with launch.RankGroup(2, 2, timeout=300) as group:
        yield group


@pytest.fixture(scope="module")
def mesh14():
    with launch.RankGroup(1, 4, timeout=300) as group:
        yield group


# ------------------------------------------------------------- layouts ---

@pytest.mark.parametrize("path,ndim,want", [
    ("/layers/in_proj/w", 3, Shard(dim=2, groups=3)),
    ("/layers/in_proj/b", 2, Shard(dim=1, groups=3)),
    ("/layers/linear1/w", 3, Shard(dim=2)),
    ("/layers/linear1/b", 2, Shard(dim=1)),
    ("/layers/out_proj/w", 3, Shard(dim=1, float32=True)),
    ("/layers/out_proj/b", 2, Shard()),
    ("/layers/linear2/w", 3, Shard(dim=1, float32=True)),
    ("/layers/linear2/b", 2, Shard()),
    ("/layers/norm1/scale", 2, Shard()),
    ("/mimi/decoder_transformer/layers/layer_scale_1/scale", 2, Shard()),
    ("/mimi/decoder_transformer/layers/gating/linear_in/w", 4, Shard()),
    ("/layers/cross_attention/in_proj/w", 3, Shard()),
])
def test_param_layout_by_name(path, ndim, want):
    """The JAX package's name rule: in_proj (by heads, q | k | v apart)
    and linear1 column-parallel, out_proj / linear2 weights row-parallel
    (kept in float32), their biases, norms, layer scales, gating and
    cross-attention whole."""
    assert sharding._spec_for_param(path, ndim) == want


@pytest.mark.parametrize("path,shape,split_bb,split_mimi,want", [
    ("flow.k[0]", (4, 64, 64), True, True, Shard(lanes=True, dim=2)),
    ("flow.v[1]", (4, 64, 64), False, True, Shard(lanes=True)),
    ("mimi.transformer.k[0]", (4, 48, 32), True, True,
     Shard(lanes=True, dim=2)),
    ("mimi.transformer.k[0]", (4, 48, 32), True, False, Shard(lanes=True)),
    ("flow.k_scale[0]", (4, 64), True, True, Shard(lanes=True)),
    ("flow.pos", (4, 64), True, True, Shard(lanes=True)),
    ("flow.next_pos", (4,), True, True, Shard(lanes=True)),
    ("flow.ppos", (4, 32), True, True, Shard(lanes=True)),
    ("mimi.transformer.start", (4,), True, True, Shard(lanes=True)),
    ("done", (4,), True, True, Shard(lanes=True)),
    ("flow.end", None, True, True, Shard()),
    ("mimi.transformer.offset", None, True, True, Shard()),
    ("flow.pk[0]", (4, 32, 16), True, True, Shard(dim=0)),
    ("flow.pv[0]", (4, 32, 16), False, True, Shard()),
])
def test_state_layout_by_name(path, shape, split_bb, split_mimi, want):
    """Lanes over "data"; flat caches also head columns over "model" when
    their part splits; host cursors whole; the shared-prefix tables whole
    over "data" and head-sliced when the backbone splits."""
    assert sharding._spec_for_state(path, shape, 2, split_bb,
                                    split_mimi) == want


@pytest.mark.parametrize("heads,model,want", [(4, 2, Shard(dim=0)),
                                              (3, 2, Shard()),
                                              (4, 4, Shard(dim=0)),
                                              (2, 4, Shard())])
def test_prefix_tables_split_only_when_heads_divide(heads, model, want):
    assert sharding._spec_for_state("flow.pk[0]", (heads, 32, 16), model,
                                    True, True) == want


def test_head_aligned_split_rebuilds_the_whole_tree(mesh22):
    """Each rank's in_proj block is its heads' columns of q, of k and of
    v (not a contiguous half of the fused 3 * d); the shards rebuild the
    whole tree, and the leaves that stay whole are the same on every
    rank."""
    outs = mesh22.run(ranks.shard_params_job, PNP, TCFG)
    by_model = {c[2]: tree for c, tree in outs if c[1] == 0}
    dm, h = CFG.backbone.d_model, CFG.backbone.num_heads
    w = PNP["layers"]["in_proj"]["w"]
    half = dm // 2
    for r in (0, 1):
        got = by_model[r]["layers"]["in_proj"]["w"]
        want = np.concatenate([w[..., j * dm + r * half:
                                 j * dm + (r + 1) * half]
                               for j in range(3)], -1)
        np.testing.assert_array_equal(got, want)
        assert got.shape[-1] == 3 * dm // 2 == 3 * (h // 2) * (dm // h)

    def rebuild(path, a, b, whole):
        if path.endswith("in_proj/w"):
            g, c = whole.shape[-1] // 3, a.shape[-1] // 3
            return np.concatenate(sum(([a[..., j * c:(j + 1) * c],
                                        b[..., j * c:(j + 1) * c]]
                                       for j in range(3)), []), -1)
        for axis in range(whole.ndim):
            if a.shape[axis] != whole.shape[axis]:
                return np.concatenate([a, b], axis)
        np.testing.assert_array_equal(a, b)
        return a

    def walk(a, b, whole, path=""):
        if isinstance(whole, dict):
            for k in whole:
                walk(a[k], b[k], whole[k], f"{path}/{k}")
        elif isinstance(whole, (list, tuple)):
            for i, v in enumerate(whole):
                walk(a[i], b[i], v, f"{path}[{i}]")
        elif isinstance(whole, np.ndarray):
            np.testing.assert_array_equal(rebuild(path, a, b, whole), whole,
                                          err_msg=path)

    walk(by_model[0], by_model[1], PNP)
    # the data ranks hold the same blocks
    for c, tree in outs:
        np.testing.assert_array_equal(
            tree["layers"]["linear2"]["w"],
            by_model[c[2]]["layers"]["linear2"]["w"])


# ------------------------------------------------------------ mesh_cfg ---

def test_mesh_cfg_threads_the_mesh_when_model_divides(mesh22):
    """data 2 x model 2: both transformers (4 and 2 heads) keep their
    kernels with the mesh, on_mesh and the SEANet's mesh are set, the
    result passes check_supported, both servers build their cfg through
    mesh_cfg, and without a mesh only fuse_insert changes."""
    for got in mesh22.run(ranks.mesh_cfg_job, PNP, TCFG):
        assert got["backbone_mesh"] and got["mimi_mesh"]
        assert got["backbone_pallas"] is None and got["mimi_pallas"] is None
        assert got["seanet_mesh"] and got["on_mesh"]
        assert got["fuse_insert"] is True
        assert got["heads"] == (2, 1)
        assert got["servers_through_mesh_cfg"]
        assert got["no_mesh_only_fuse_insert"]
        assert got["no_mesh_on_mesh"] is False


def test_mesh_cfg_pins_a_part_off_when_model_does_not_divide(mesh14):
    """model 4: the backbone's 4 heads divide (one head a rank keeps the
    kernels: K1, K2 and K7 take any local head count), the mimi's 2 do
    not: it takes the plain route with no mesh, whole on every rank;
    on_mesh is still set."""
    for got in mesh14.run(ranks.mesh_cfg_job, PNP, TCFG):
        assert got["backbone_mesh"] and got["backbone_pallas"] is None
        assert not got["mimi_mesh"] and got["mimi_pallas"] is False
        assert got["on_mesh"] and got["seanet_mesh"]
        assert got["heads"] == (1, 2)
        assert got["servers_through_mesh_cfg"]


# ------------------------------------------------------- against JAX ---

def test_sharded_frame_steps_match_jax_float(mesh22):
    want_pcm, want_valid = jax_steps(CFG, (2, 2), 3)
    pcm, valid, outs = port_steps(mesh22, TCFG, 3)
    np.testing.assert_array_equal(valid, want_valid)
    np.testing.assert_allclose(pcm, want_pcm, atol=ATOL, rtol=0)
    assert not valid[:, 1].all()            # lane 1 stopped
    same_within_model_groups(outs)
    # per frame: 2 backbone layers and 2 mimi layers, 2 sums each
    assert all(o["reduces_per_frame"] == 8 for o in outs)


def _close_rel(got, want, rel):
    scale = np.abs(want).max()
    assert scale > 0
    np.testing.assert_allclose(got / scale, want / scale, atol=rel, rtol=0)


def test_sharded_frame_steps_match_jax_int8_kv(mesh22):
    """int8 KV caches on both transformers: each new row's scale is the
    whole row's absmax (an all-reduce max over "model" per layer, K and V
    together), as the JAX package hands the full-row scales to its head
    shards."""
    want_pcm, want_valid = jax_steps(quantize_kv(CFG), (2, 2), 3)
    pcm, valid, outs = port_steps(mesh22, quantize_kv(TCFG), 3)
    np.testing.assert_array_equal(valid, want_valid)
    _close_rel(pcm, want_pcm, KV8_REL)
    same_within_model_groups(outs)
    # per frame and layer: 2 sums and 1 max of the new rows' absmax
    assert all(o["reduces_per_frame"] == 12 for o in outs)


def test_sharded_frame_steps_match_jax_model4(mesh14):
    """data 1 x model 4: one backbone head a rank, the mimi whole on every
    rank on its plain route."""
    want_pcm, want_valid = jax_steps(CFG, (1, 4), 2)
    pcm, valid, outs = port_steps(mesh14, TCFG, 2)
    np.testing.assert_array_equal(valid, want_valid)
    np.testing.assert_allclose(pcm, want_pcm, atol=ATOL, rtol=0)
    same_within_model_groups(outs)
    assert all(o["reduces_per_frame"] == 4 for o in outs)


@pytest.mark.parametrize("kv8", [False, True])
def test_own_lane_prefill_is_the_sharded_whole_prefill(mesh22, kv8):
    """A rank that primes and prefills only its own lanes at its own
    heads (BatchedEngine, the servers) holds what shard_batched_state
    takes of the whole prefill: the same positions, the same rows (int8:
    bytes one quantization step apart at most, scales within 1e-5) and
    the width of its heads."""
    cfg = quantize_kv(TCFG) if kv8 else TCFG
    prompts, tokens = inputs(CFG)
    for got in mesh22.run(ranks.own_prefill_job, PNP, cfg, prompts, tokens,
                          PROMPT_LENS, TOKEN_LENS):
        assert got["pos"]
        assert got["width"] == CFG.backbone.d_model // 2
        if kv8:
            assert got["scales"] <= 1e-5 and got["steps"] <= 1
        else:
            assert got["rows"] <= 1e-5


VOICES = {"va": random_voice_prompt(TCFG, 12, seed=1),
          "vb": random_voice_prompt(TCFG, 16, seed=2)}
REQS = [("A mesh lane decodes this.", "va"),
        ("Another voice joins.", "vb"),
        ("And a third one joins mid decode.", "va")]


def cap256(cfg):
    return dataclasses.replace(cfg, backbone=dataclasses.replace(
        cfg.backbone, kv_capacity=256))


def test_sharded_shared_prefix_server_matches_jax(mesh22):
    """The shared-prefix continuous server on the 2 x 2 mesh (head-sliced
    prefix tables, one request admitted mid-decode) against the JAX
    package's unsharded shared server."""
    jeng = JEngine(params=PJ, cfg=cap256(CFG), seed=0,
                   tokenizer=JMock(CFG.lut.n_bins))
    jsrv = JCBS(jeng, lanes=4, chunk_frames=4, text_bucket=32,
                share_prefix=True)
    jsrv.register_voices({k: np.asarray(v) for k, v in VOICES.items()})
    jreqs = [jsrv.submit(t, v, temp=0.0) for t, v in REQS[:2]]
    jsrv.step()
    jreqs += [jsrv.submit(t, v, temp=0.0) for t, v in REQS[2:]]
    jsrv.run_pending()
    outs = mesh22.run(ranks.server_job, PNP, cap256(TCFG), VOICES, REQS, 2,
                      4, dict(share_prefix=True))
    for o in outs:
        assert o["width"] == CFG.backbone.d_model // 2 and o["lanes"] == 2
        assert o["admit"] == [r.admit_step for r in jreqs]
        assert o["admit"][2] == 1                 # admitted mid-decode
        for i, (a, r) in enumerate(zip(o["pcm"], jreqs)):
            want = np.asarray(r.pcm)
            assert a.shape == want.shape and a.size, (i, a.shape, want.shape)
            np.testing.assert_allclose(a, want, atol=SERVER_ATOL, rtol=0,
                                       err_msg=f"req {i}")
        for a, b in zip(o["pcm"], outs[0]["pcm"]):
            np.testing.assert_array_equal(a, b)   # every rank, same audio


# ------------------------------------------------ within the port ---

def _engine(cfg, **kw):
    return TTSEngine(params=PT, cfg=cfg, seed=0, device="cpu",
                     tokenizer=MockTokenizer(CFG.lut.n_bins), **kw)


def test_linear_cursor_server_compacts_alike_on_the_mesh(mesh22):
    """ring=False (the epoch design) with eager compaction: the cursor
    after compact_batch is the longest live lane's over every "data"
    rank, so the sharded server compacts when and as the unsharded one
    does and gives its audio."""
    kw = dict(ring=False, compact_margin=8)
    reqs = [("Short.", "va"), ("A longer one to keep going.", "vb"),
            ("Tiny.", "va"), ("Another one.", "vb")]
    eng = _engine(cap256(TCFG))
    srv = ContinuousBatchingServer(eng, lanes=4, chunk_frames=4,
                                   text_bucket=32, **kw)
    srv.register_voices(VOICES)
    want = [srv.submit(t, v, temp=0.0) for t, v in reqs[:2]]
    srv.step()
    want += [srv.submit(t, v, temp=0.0) for t, v in reqs[2:]]
    srv.run_pending()
    outs = mesh22.run(ranks.server_job, PNP, cap256(TCFG), VOICES, reqs, 2,
                      4, kw)
    assert srv.compactions > 0
    for o in outs:
        assert o["compactions"] == srv.compactions
        for a, r in zip(o["pcm"], want):
            assert a.shape == r.pcm.shape
            np.testing.assert_allclose(a, r.pcm, atol=ATOL, rtol=0)


def test_multistream_server_on_the_mesh_matches_unsharded(mesh22):
    reqs = [("Hello there.", "va"), ("Second voice here.", "vb"),
            ("Third.", "va")]
    srv = MultiStreamServer(_engine(TCFG), max_batch=4, chunk_frames=5)
    srv.register_voices(VOICES)
    want = [srv.submit(t, v, temp=0.0) for t, v in reqs]
    srv.run_pending()
    for got in mesh22.run(ranks.multistream_job, PNP, TCFG, VOICES, reqs,
                          4):
        for a, r in zip(got, want):
            assert a.shape == r.pcm.shape and a.size
            np.testing.assert_allclose(a, r.pcm, atol=ATOL, rtol=0)


def test_batched_engine_on_the_mesh_matches_unsharded(mesh22):
    """BatchedEngine(mesh=): each rank primes, prefills and decodes its own
    two lanes; every rank returns all four streams' audio."""
    prompts = [random_voice_prompt(TCFG, n, seed=i)
               for i, n in enumerate((12, 9, 16, 10))]
    texts = ["Hello there.", "A second stream.", "Third voice.",
             "Short one."]
    be = tb.BatchedEngine(_engine(TCFG))
    want = be.synthesize_batch(texts, be.prime_voices(prompts), temp=0.0)
    for got in mesh22.run(ranks.batched_engine_job, PNP, TCFG, prompts,
                          texts):
        assert len(got) == 4
        for a, w in zip(got, want):
            assert a.shape == w.shape and a.size
            np.testing.assert_allclose(a, w, atol=ATOL, rtol=0)


def test_quantized_weights_on_a_mesh_raise(mesh22):
    """Quantized weights on a mesh are not ported (ROADMAP): shard_params,
    BatchedEngine and both servers raise NotImplementedError."""
    for msgs in mesh22.run(ranks.quantized_refusal_job, PNP, TCFG):
        assert all(m is not None and "quantized" in m for m in msgs), msgs


def test_solo_decode_with_the_mesh_cfg_matches_unsharded(mesh22):
    """A solo stream primed and prefilled with the mesh cfg (the servers'
    register_voices route) and decoded with tts.decode_sentence at its
    heads gives the unsharded port's frames."""
    from pocket_tts_tpu_torch.models import backbone, tts
    prompt = random_voice_prompt(TCFG, 16, seed=3)
    tokens = np.zeros(16, np.int64)
    tokens[:10] = np.arange(3, 13)
    st = tts.prime_voice(PT, TCFG, backbone.init_state(TCFG.backbone),
                         torch.from_numpy(prompt), 16)
    st = tts.sentence_prefill(PT, TCFG, st, torch.from_numpy(tokens), 10)
    _, want_pcm, want_valid = tts.decode_sentence(
        PT, TCFG, st, lambda i: torch.zeros(CFG.latent_dim), 3, 6, 9)
    for pcm, valid in mesh22.run(ranks.tts_decode_job, PNP, TCFG, prompt,
                                 tokens, 10, 3, 6, 9):
        np.testing.assert_array_equal(valid, want_valid.numpy())
        np.testing.assert_allclose(pcm, want_pcm.numpy(), atol=ATOL, rtol=0)


def test_launch_raises_a_rank_failure():
    """A rank's exception fails the job in the caller, with the rank's
    traceback, and stops the group."""
    with pytest.raises(RuntimeError, match="mesh rank 1 failed"):
        launch.launch(ranks.fail_on_rank1, 1, 2)


def test_launch_raises_a_rank_that_dies():
    """A rank that exits without replying fails the job in the caller with
    its exit code."""
    with pytest.raises(RuntimeError, match="mesh rank 1 exited with code 3"):
        launch.launch(ranks.die_on_rank1, 1, 2)


def test_dryrun_multichip_tiny():
    """dryrun_multichip's phases on four CPU ranks at tiny_config (the
    full-width run is test_dryrun_multichip_full, marked slow)."""
    from pocket_tts_tpu_torch.parallel.dryrun import dryrun_multichip
    report = dryrun_multichip(4, "cpu", cfg=cap256(TCFG))
    assert report["mesh"] == (2, 2) and report["batch"] == 4
    assert report["server_frames"] > 0 and report["active"] >= 2


@pytest.mark.slow
def test_dryrun_multichip_full():
    """The dry run at the full reference width on four CPU ranks (each
    holds the whole model: several GB of host memory, minutes)."""
    from pocket_tts_tpu_torch.parallel.dryrun import dryrun_multichip
    report = dryrun_multichip(4, "cpu")
    assert report["mesh"] == (2, 2)
