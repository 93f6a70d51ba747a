"""Quantized weights on a ("data", "model") mesh in the port
(pocket_tts_tpu_torch/parallel/sharding.py) on gloo CPU ranks, against the
JAX package's GSPMD mesh on the 8 virtual CPU devices conftest.py sets.

The JAX layout: the `q` / `q4` / `scale` leaves of `in_proj` (by heads)
and `linear1` split on their output axis, a quantized `out_proj` /
`linear2` whole on every rank, its input gathered over "model"
(`row_linear`), and no fused layer kernel (K5a / K5b, K5c, K8, K6) on a
mesh (`sharding.fusable`): each linear is one K4a / K4b call on the block
the rank holds. The jobs are in tests/_torch_mesh_ranks.py (no JAX).

At tiny_config(64) every linear of both transformers quantizes (at
tiny_config() the out_proj / linear2 stay float); tiny_config(32) is the
mixed case: the mimi's in_proj / linear1 quantize, its out_proj / linear2
stay float, so one layer takes the float sum beside a quantized column
product. f32, temp 0. Tolerances as tests/test_torch_sharding.py: 1e-4
absolute with float caches, 1e-3 relative to max |pcm| with int8 KV
caches, 2e-3 absolute for the shared-prefix server (the JAX package's
own bound)."""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import _torch_mesh_ranks as ranks
import chip_smoke
from pocket_tts_tpu.config import tiny_config
from pocket_tts_tpu.io.params import params_from_flat, random_flat
from pocket_tts_tpu.io.quant import quantize_params as jquantize
from pocket_tts_tpu.models import backbone as jbackbone
from pocket_tts_tpu.models import mimi as jmimi
from pocket_tts_tpu.parallel.sharding import make_mesh as jmake_mesh
from pocket_tts_tpu.parallel.sharding import \
    shard_batched_state as jshard_state
from pocket_tts_tpu.parallel.sharding import shard_params as jshard_params
from pocket_tts_tpu.runtime import batched as jb
from pocket_tts_tpu.runtime.engine import TTSEngine as JEngine
from pocket_tts_tpu.runtime.server import ContinuousBatchingServer as JCBS
from pocket_tts_tpu_torch.config import tiny_config as ttiny_config
from pocket_tts_tpu_torch.io.params import from_jax_numpy
from pocket_tts_tpu_torch.io.params import params_from_flat as tparams
from pocket_tts_tpu_torch.io.params import random_flat as trandom_flat
from pocket_tts_tpu_torch.io.params import random_voice_prompt
from pocket_tts_tpu_torch.io.quant import quantize_params, save_params_cache
from pocket_tts_tpu_torch.parallel import launch, sharding
from pocket_tts_tpu_torch.parallel.sharding import WHOLE, Shard
from pocket_tts_tpu_torch.runtime import batched as tb
from pocket_tts_tpu_torch.runtime.engine import TTSEngine
from pocket_tts_tpu_torch.runtime.server import MultiStreamServer
from pocket_tts_tpu_torch.text.tokenizer import MockTokenizer

torch.set_num_threads(1)
ATOL = 1e-4
KV8_REL = 1e-3
SERVER_ATOL = 2e-3
QUANTIZE = ranks.QUANTIZE
FUSED = ("K5a", "K5b", "K5c", "K8", "K6")


def models(width):
    """(JAX params, JAX cfg, the port's params as numpy, the port's cfg)
    of one random checkpoint at tiny_config(width)."""
    cfg0 = tiny_config(width)
    pj, cfg = params_from_flat(random_flat(cfg0, seed=13, scale=0.05), cfg0)
    pnp = ranks.to_numpy(from_jax_numpy(jax.tree.map(np.asarray, pj)))
    _, tcfg = tparams(trandom_flat(ttiny_config(width), seed=13),
                      ttiny_config(width))
    return pj, cfg, pnp, tcfg


PJ, CFG, PNP, TCFG = models(64)
B = 4
PROMPT_LENS = np.asarray([16, 12, 9, 16], np.int32)
TOKEN_LENS = np.asarray([12, 7, 12, 10], np.int32)
FAE = np.asarray([3, 3, 2, 4], np.int32)
MAX_STEPS = np.asarray([50, 2, 50, 50], np.int32)   # lane 1 stops early


def quantize_kv(cfg):
    """int8 KV on both transformers, mimi capacity 64; the packages' cfgs
    alike."""
    return dataclasses.replace(
        cfg, backbone=dataclasses.replace(cfg.backbone, quantize_kv=True),
        mimi=dataclasses.replace(cfg.mimi, transformer=dataclasses.replace(
            cfg.mimi.transformer, quantize_kv=True, capacity=64)))


def inputs(cfg):
    rng = np.random.RandomState(7)
    prompts = np.zeros((B, 16, cfg.backbone.d_model), np.float32)
    for i, n in enumerate(PROMPT_LENS):
        prompts[i, :n] = rng.randn(n, cfg.backbone.d_model) * 0.05
    tokens = np.zeros((B, 16), np.int64)
    for i, n in enumerate(TOKEN_LENS):
        tokens[i, :n] = rng.randint(0, cfg.lut.n_bins, n)
    return prompts, tokens


def jax_steps(pj, cfg, quantize, mesh_shape, n_frames):
    """JAX: the weights quantized (quantize_params), the whole batch
    primed and prefilled, then sharded (shard_params, shard_batched_state)
    with mesh_cfg, and n_frames of batched_frame_step at temp 0. On the
    CPU the JAX package runs its plain (XLA) attention under the mesh, and
    its quantized linears unfused, as on the chip."""
    pq = jquantize(pj, **QUANTIZE[quantize])
    prompts, tokens = inputs(cfg)
    st = jb.stack_states([jbackbone.init_state(cfg.backbone)
                          for _ in range(B)])
    vs = jb.batched_prime_voice(pq, cfg, st, jnp.asarray(prompts),
                                jnp.asarray(PROMPT_LENS))
    states = jb.batched_sentence_prefill(
        pq, cfg, vs, jmimi.init_state(cfg.mimi),
        jnp.asarray(tokens, jnp.int32), jnp.asarray(TOKEN_LENS))
    data, model = mesh_shape
    mesh = jmake_mesh(data=data, model=model,
                      devices=jax.devices()[:data * model])
    cfg_m = jb.mesh_cfg(cfg, mesh)
    p_sh, st_sh = jshard_params(pq, mesh), jshard_state(states, mesh)
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


def port_steps(group, pnp, cfg, quantize, n_frames):
    prompts, tokens = inputs(cfg)
    outs = group.run(ranks.frame_steps_job, pnp, cfg, prompts, tokens,
                     PROMPT_LENS, TOKEN_LENS, FAE, MAX_STEPS, n_frames,
                     quantize)
    pcm = np.zeros((n_frames, B, cfg.mimi.frame_size), np.float32)
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


def close_rel(got, want, rel):
    scale = np.abs(want).max()
    assert scale > 0 and got.shape == want.shape
    np.testing.assert_allclose(got / scale, want / scale, atol=rel, rtol=0)


def step_k4(pnp, quantize):
    """K4a / K4b calls of a batch frame step on a mesh, from the tree."""
    tree = ranks.params(pnp, quantize)
    return chip_smoke.mesh_k4_calls(tree)[0]


def assert_unfused(calls, quantize, k4=None):
    """No fused kernel ran; K4a or K4b (by the weights' bits) did, k4
    times when given, and the other not at all."""
    assert all(calls[k] == 0 for k in FUSED), calls
    mine, other = ("K4a", "K4b") if quantize == "int8" else ("K4b", "K4a")
    assert calls[other] == 0 and calls[mine] > 0, calls
    if k4 is not None:
        assert calls[mine] == k4, (calls, k4)


@pytest.fixture(scope="module")
def mesh22():
    with launch.RankGroup(2, 2, device="cpu", timeout=300) as group:
        yield group


@pytest.fixture(scope="module")
def mesh14():
    with launch.RankGroup(1, 4, device="cpu", timeout=300) as group:
        yield group


# ------------------------------------------------------------- layouts ---

def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}[{i}]")
    else:
        yield path, tree


@pytest.mark.parametrize("quantize", list(QUANTIZE))
def test_quantized_tree_layout(quantize):
    """param_shardings of a quantized tiny_config(64) tree under the 2 x 2
    mesh cfg: every leaf of the four linears of both transformers by its
    name (q4_0's (L, K/32, N) scales on their last axis), no float32
    copy of a quantized leaf, and the flow net whole."""
    tree = quantize_params(ranks.to_torch(PNP), **QUANTIZE[quantize])
    mesh = _FakeMesh()
    cfg = _mesh_cfg(TCFG, mesh)
    specs = dict(_leaves(sharding.param_shardings(tree, mesh, cfg)))
    leaves = dict(_leaves(tree))
    key = "q" if quantize == "int8" else "q4"
    want = {"in_proj": Shard(dim=2, groups=3), "linear1": Shard(dim=2),
            "out_proj": WHOLE, "linear2": WHOLE}
    for pre in ("/layers/", "/mimi/decoder_transformer/layers/"):
        for lin, spec in want.items():
            for leaf in (key, "scale"):
                path = f"{pre}{lin}/{leaf}"
                ndim = leaves[path].dim()
                assert specs[path] == dataclasses.replace(
                    spec, dim=None if spec.dim is None else ndim - 1), path
            if quantize == "q4_0":
                assert leaves[f"{pre}{lin}/scale"].dim() == 3
    assert all(s == WHOLE for p, s in specs.items()
               if p.startswith("/flow_net"))


class _FakeMesh:
    """A stand-in for a 2 x 2 DeviceMesh, for the layout functions that
    read only the dims' names and sizes."""
    mesh_dim_names = ("data", "model")
    shape = (2, 2)
    device_type = "cpu"


def _mesh_cfg(cfg, mesh):
    return dataclasses.replace(
        cfg, on_mesh=True,
        backbone=dataclasses.replace(cfg.backbone, mesh=mesh),
        mimi=dataclasses.replace(cfg.mimi, transformer=dataclasses.replace(
            cfg.mimi.transformer, mesh=mesh)))


@pytest.mark.parametrize("quantize", ["int8", "q4_0"])
def test_rank_blocks_rebuild_the_quantized_tree(mesh22, quantize):
    """Each rank's in_proj leaves are its heads' columns of q, k and v;
    the blocks rebuild the whole quantized tree bit for bit, and the
    quantized out_proj / linear2 are the whole leaves on every rank."""
    whole = ranks.to_numpy(sharding._tree_map(
        lambda path, t: t.float() if isinstance(t, torch.Tensor)
        and t.dtype == torch.bfloat16 else t,
        ranks.params(PNP, quantize)))
    outs = mesh22.run(ranks.shard_params_job, PNP, TCFG, quantize)
    by_model = {c[2]: tree for c, tree in outs if c[1] == 0}

    def rebuild(path, a, b, full):
        if "in_proj" in path and a.shape != full.shape:
            c = a.shape[-1] // 3
            return np.concatenate(sum(([a[..., j * c:(j + 1) * c],
                                        b[..., j * c:(j + 1) * c]]
                                       for j in range(3)), []), -1)
        if a.shape != full.shape:
            assert "linear1" in path, path
            return np.concatenate([a, b], -1)
        np.testing.assert_array_equal(a, b)
        return a

    a, b = dict(_leaves(by_model[0])), dict(_leaves(by_model[1]))
    for path, full in _leaves(whole):
        if isinstance(full, np.ndarray):
            np.testing.assert_array_equal(rebuild(path, a[path], b[path],
                                                  full), full, err_msg=path)
    for c, tree in outs:
        for lin in ("out_proj", "linear2"):
            np.testing.assert_array_equal(
                tree["layers"][lin]["scale"],
                whole["layers"][lin]["scale"])


# ------------------------------------------------------- against JAX ---

@pytest.mark.parametrize("quantize", list(QUANTIZE))
def test_sharded_quantized_frame_steps_match_jax(mesh22, quantize):
    """2 x 2, f32: the sharded frame step against JAX's sharded one; per
    frame and layer two gathers (the quantized out_proj and linear2) and
    no sum; the ranks of a "model" group equal; one K4 call per quantized
    linear a step runs and no fused kernel."""
    want_pcm, want_valid = jax_steps(PJ, CFG, quantize, (2, 2), 3)
    pcm, valid, outs = port_steps(mesh22, PNP, TCFG, quantize, 3)
    np.testing.assert_array_equal(valid, want_valid)
    np.testing.assert_allclose(pcm, want_pcm, atol=ATOL, rtol=0)
    assert not valid[:, 1].all()            # lane 1 stopped
    same_within_model_groups(outs)
    layers = TCFG.backbone.num_layers + TCFG.mimi.transformer.num_layers
    for o in outs:
        assert o["gathers_per_frame"] == 2 * layers
        assert o["reduces_per_frame"] == 0
        assert_unfused(o["calls_per_frame"], quantize,
                       step_k4(PNP, quantize))


def test_sharded_int4_kv8_frame_steps_match_jax(mesh22):
    """The serving mode's weights and caches (int4, int8 KV on both
    transformers) at 2 x 2: per frame and layer two gathers and one max
    of the new rows' absmax."""
    cfg = quantize_kv(CFG)
    want_pcm, want_valid = jax_steps(PJ, cfg, "int4", (2, 2), 3)
    pcm, valid, outs = port_steps(mesh22, PNP, quantize_kv(TCFG), "int4", 3)
    np.testing.assert_array_equal(valid, want_valid)
    close_rel(pcm, want_pcm, KV8_REL)
    same_within_model_groups(outs)
    layers = TCFG.backbone.num_layers + TCFG.mimi.transformer.num_layers
    for o in outs:
        assert o["gathers_per_frame"] == 2 * layers
        assert o["reduces_per_frame"] == layers
        assert_unfused(o["calls_per_frame"], "int4")


def test_sharded_int4_frame_steps_match_jax_model4(mesh14):
    """1 x 4: one backbone head a rank (its out_proj / linear2 gathered
    from four ranks), the mimi whole on every rank on its plain route
    (no collective)."""
    want_pcm, want_valid = jax_steps(PJ, CFG, "int4", (1, 4), 2)
    pcm, valid, outs = port_steps(mesh14, PNP, TCFG, "int4", 2)
    np.testing.assert_array_equal(valid, want_valid)
    np.testing.assert_allclose(pcm, want_pcm, atol=ATOL, rtol=0)
    same_within_model_groups(outs)
    for o in outs:
        assert o["gathers_per_frame"] == 2 * TCFG.backbone.num_layers
        assert o["reduces_per_frame"] == 0
        assert_unfused(o["calls_per_frame"], "int4", step_k4(PNP, "int4"))


def test_mixed_float_and_quantized_mimi_layers_match_jax(mesh22):
    """tiny_config(32): the mimi's in_proj / linear1 quantize (int8)
    while its out_proj / linear2 stay float: those layers sum float
    partial products (two all-reduces a layer) beside the backbone's
    gathers."""
    pj, cfg, pnp, tcfg = models(32)
    tree = ranks.params(pnp, "int8")
    mt = tree["mimi"]["decoder_transformer"]["layers"]
    assert "q" in mt["in_proj"] and "q" in mt["linear1"]
    assert "w" in mt["out_proj"] and "w" in mt["linear2"]
    want_pcm, want_valid = jax_steps(pj, cfg, "int8", (2, 2), 3)
    pcm, valid, outs = port_steps(mesh22, pnp, tcfg, "int8", 3)
    np.testing.assert_array_equal(valid, want_valid)
    np.testing.assert_allclose(pcm, want_pcm, atol=ATOL, rtol=0)
    same_within_model_groups(outs)
    for o in outs:
        assert o["gathers_per_frame"] == 2 * tcfg.backbone.num_layers
        assert o["reduces_per_frame"] == 2 * tcfg.mimi.transformer.num_layers
        assert_unfused(o["calls_per_frame"], "int8", step_k4(pnp, "int8"))


VOICES = {"va": random_voice_prompt(TCFG, 12, seed=1),
          "vb": random_voice_prompt(TCFG, 16, seed=2)}
REQS = [("A mesh lane decodes this.", "va"),
        ("Another voice joins.", "vb"),
        ("And a third one joins mid decode.", "va")]
SERVING = dict(quantize="int4", quantize_kv=True)


def cap256(cfg):
    return dataclasses.replace(cfg, backbone=dataclasses.replace(
        cfg.backbone, kv_capacity=256))


def test_serving_mode_server_on_the_mesh_matches_jax(mesh22):
    """The JAX package's serving mode (int4 weights, int8 KV, shared
    prefix) in the continuous server on the 2 x 2 mesh, one request
    admitted mid-decode, against the JAX package's server (within 2e-3,
    and within 1e-3 of the peak as the int8 cache allows); every rank
    returns the same audio and runs no fused kernel."""
    jeng = JEngine(params=PJ, cfg=cap256(CFG), seed=0,
                   tokenizer=MockTokenizer(CFG.lut.n_bins), **SERVING)
    jsrv = JCBS(jeng, lanes=4, chunk_frames=4, text_bucket=32,
                share_prefix=True)
    jsrv.register_voices({k: np.asarray(v) for k, v in VOICES.items()})
    jreqs = [jsrv.submit(t, v, temp=0.0) for t, v in REQS[:2]]
    jsrv.step()
    jreqs += [jsrv.submit(t, v, temp=0.0) for t, v in REQS[2:]]
    jsrv.run_pending()
    outs = mesh22.run(ranks.server_job, PNP, cap256(TCFG), VOICES, REQS, 2,
                      4, dict(share_prefix=True), SERVING)
    for o in outs:
        assert o["admit"] == [r.admit_step for r in jreqs]
        assert o["admit"][2] == 1                 # admitted mid-decode
        for i, (a, r) in enumerate(zip(o["pcm"], jreqs)):
            want = np.asarray(r.pcm)
            assert a.shape == want.shape and a.size, (i, a.shape, want.shape)
            np.testing.assert_allclose(a, want, atol=SERVER_ATOL, rtol=0,
                                       err_msg=f"req {i}")
            close_rel(a, want, KV8_REL)
        for a, b in zip(o["pcm"], outs[0]["pcm"]):
            np.testing.assert_array_equal(a, b)   # every rank, same audio
        assert_unfused(o["calls"], "int4")


# ------------------------------------------------ within the port ---

def _engine(cfg, **kw):
    return TTSEngine(params=ranks.to_torch(PNP), cfg=cfg, seed=0,
                     device="cpu", tokenizer=MockTokenizer(CFG.lut.n_bins),
                     **kw)


PROMPTS = [random_voice_prompt(TCFG, n, seed=i)
           for i, n in enumerate((12, 9, 16, 10))]
TEXTS = ["Hello there.", "A second stream.", "Third voice.", "Short one."]


@pytest.mark.parametrize("engine_kw", [
    dict(quantize="q4_0"), dict(quantize="int8", quantize_kv=True),
    dict(quantize="int8", quantize_convs=True)],
    ids=["q4_0", "int8-kv8", "int8-convs"])
def test_batched_engine_quantized_on_the_mesh_matches_unsharded(mesh22,
                                                               engine_kw):
    """BatchedEngine(mesh=) with quantized weights (with the int8 KV
    cache; with quantized convs, whole on every rank) gives the unsharded
    port's audio."""
    eng = _engine(TCFG, **engine_kw)
    if engine_kw.get("quantize_convs"):
        dec = eng.params["mimi"]["decoder"]
        assert any("qc" in v or "qt" in v for v in dec.values()
                   if isinstance(v, dict)), "no conv quantized"
    be = tb.BatchedEngine(eng)
    want = be.synthesize_batch(TEXTS, be.prime_voices(PROMPTS), temp=0.0)
    for got in mesh22.run(ranks.batched_engine_job, PNP, TCFG, PROMPTS,
                          TEXTS, engine_kw):
        assert len(got) == 4
        for a, w in zip(got, want):
            assert a.shape == w.shape and a.size
            if engine_kw.get("quantize_kv"):
                close_rel(a, w, KV8_REL)
            else:
                np.testing.assert_allclose(a, w, atol=ATOL, rtol=0)


def test_multistream_server_quantized_on_the_mesh_matches_unsharded(mesh22):
    reqs = [("Hello there.", "va"), ("Second voice here.", "vb"),
            ("Third.", "va")]
    srv = MultiStreamServer(_engine(TCFG, quantize="int4"), max_batch=4,
                            chunk_frames=5)
    srv.register_voices(VOICES)
    want = [srv.submit(t, v, temp=0.0) for t, v in reqs]
    srv.run_pending()
    for got in mesh22.run(ranks.multistream_job, PNP, TCFG, VOICES, reqs, 4,
                          dict(quantize="int4")):
        for a, r in zip(got, want):
            assert a.shape == r.pcm.shape and a.size
            np.testing.assert_allclose(a, r.pcm, atol=ATOL, rtol=0)


_MESH_PCM = {}   # the engine's own q4_0 tree on the mesh, run once


@pytest.mark.parametrize("suffix", [".safetensors", ".gguf"])
def test_params_cache_shards_as_the_engine_does(mesh22, tmp_path, suffix):
    """A quantized params cache loaded into a meshed BatchedEngine shards
    as the engine's own quantized tree does: the same audio, bit for
    bit."""
    path = str(tmp_path / f"q4_0{suffix}")
    save_params_cache(ranks.params(PNP, "q4_0"), path)
    got = mesh22.run(ranks.cache_engine_job, path, TCFG, PROMPTS, TEXTS)
    if "q4_0" not in _MESH_PCM:
        _MESH_PCM["q4_0"] = mesh22.run(ranks.batched_engine_job, PNP, TCFG,
                                       PROMPTS, TEXTS, dict(quantize="q4_0"))
    for g, w in zip(got, _MESH_PCM["q4_0"]):
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("quantize,flag", [("int8", "use_megalayer"),
                                           ("int4", "use_bilayer")])
def test_no_fused_kernel_on_a_mesh(mesh22, quantize, flag):
    """The solo route on a mesh (register_voices' prime and prefill, then
    tts.decode_sentence) with K8 or K5c asked for: no layer takes K5a /
    K5b / K5c / K8 / K6, every linear is one K4 call on the rank's
    block, and the frames are the unsharded port's."""
    from pocket_tts_tpu_torch.models import backbone, tts
    cfg = dataclasses.replace(TCFG, backbone=dataclasses.replace(
        TCFG.backbone, fuse_insert=True, **{flag: True}))
    p = ranks.params(PNP, quantize)
    prompt = random_voice_prompt(TCFG, 16, seed=3)
    tokens = np.zeros(16, np.int64)
    tokens[:10] = np.arange(3, 13)
    st = tts.prime_voice(p, cfg, backbone.init_state(cfg.backbone),
                         torch.from_numpy(prompt), 16)
    st = tts.sentence_prefill(p, cfg, st, torch.from_numpy(tokens), 10)
    _, want_pcm, want_valid = tts.decode_sentence(
        p, cfg, st, lambda i: torch.zeros(CFG.latent_dim), 3, 6, 9)
    for pcm, valid, calls in mesh22.run(ranks.tts_decode_job, PNP, cfg,
                                        prompt, tokens, 10, 3, 6, 9,
                                        quantize):
        np.testing.assert_array_equal(valid, want_valid.numpy())
        np.testing.assert_allclose(pcm, want_pcm.numpy(), atol=ATOL, rtol=0)
        assert_unfused(calls, quantize)


@pytest.mark.parametrize("quantize", list(QUANTIZE))
def test_fusable_only_without_a_mesh(quantize):
    """sharding.fusable: a quantized layer the fused kernels take fuses
    without a mesh and never with one; a float layer never."""
    from pocket_tts_tpu_torch.ops.basic import slice_layer_params
    tree = ranks.params(PNP, quantize)
    for layers in (tree["layers"],
                   tree["mimi"]["decoder_transformer"]["layers"]):
        layer = slice_layer_params(layers, 0)
        assert sharding.fusable(layer, None)
        assert not sharding.fusable(layer, _FakeMesh())
    float_layer = slice_layer_params(ranks.to_torch(PNP)["layers"], 0)
    assert not sharding.fusable(float_layer, None)


def test_k4_calls_a_step_from_the_tree():
    """chip_smoke.mesh_k4_calls counts each quantized linear a step runs
    once a layer: at tiny_config(64) the backbone's and the mimi's four
    linears a layer and the flow net's res-block and final linears, its
    time_embed not; a prefill call the backbone's."""
    tree = ranks.params(PNP, "int4")
    nb, nm = TCFG.backbone.num_layers, TCFG.mimi.transformer.num_layers
    depth = TCFG.flow.depth
    # flow net: cond_embed, 3 linears a res block, final.adaln
    assert chip_smoke.mesh_k4_calls(tree) == (
        4 * nb + 4 * nm + 1 + 3 * depth + 1, 4 * nb)
