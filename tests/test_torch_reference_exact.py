"""The reference-exact mode (`reference_exact_config`: tanh GELU, -1e5
masks, a mimi ring of capacity == context, `use_pallas_attn=False`) in the
port against the JAX package, on one random checkpoint at tiny_config, f32,
atol 1e-4 (tests/test_torch_e2e.py's tolerance): the mimi ring before and
after it wraps inside a 16-step block (capacity 40), solo and over lanes;
the backbone's plain decode; `synthesize` and the batched engine at
temp 0. The route comes from the cfg: on the plain routes no fused kernel
wrapper is called (K1, K2, K5a/K5b/K5c, K7, K8), while K4a keeps the
quantized linears; the kernel routes call them (test_torch_models.py
holds those against JAX)."""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pocket_tts_tpu.config import reference_exact_config as jexact
from pocket_tts_tpu.config import tiny_config
from pocket_tts_tpu.io.params import params_from_flat, random_flat
from pocket_tts_tpu.models import backbone as jbb
from pocket_tts_tpu.models import mimi_transformer as jmt
from pocket_tts_tpu.runtime.batched import BatchedEngine as JBatched
from pocket_tts_tpu.runtime.engine import TTSEngine as JEngine
from pocket_tts_tpu.text.tokenizer import MockTokenizer
from pocket_tts_tpu_torch.config import reference_exact_config as texact
from pocket_tts_tpu_torch.io.params import from_jax_numpy, random_voice_prompt
from pocket_tts_tpu_torch.models import backbone as tbb
from pocket_tts_tpu_torch.models import mimi_transformer as tmt
from pocket_tts_tpu_torch.ops import quant_matmul
from pocket_tts_tpu_torch.runtime.batched import BatchedEngine
from pocket_tts_tpu_torch.runtime.engine import TTSEngine

torch.set_num_threads(1)
ATOL = 1e-4
CFG0 = tiny_config()
PJ, CFG = params_from_flat(random_flat(CFG0, seed=61), CFG0)
PT = from_jax_numpy(jax.tree.map(np.asarray, PJ))
JEX, TEX = jexact(CFG), texact(CFG)
VOICE = random_voice_prompt(CFG, 16)
TEXT = "The switchboard enumerates every divergence in one run."


def close(got, want, atol=ATOL, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol,
                               rtol=0, err_msg=msg)


def test_port_config_is_the_jax_one():
    assert dataclasses.asdict(TEX) == dataclasses.asdict(JEX)
    assert TEX.mimi.transformer.capacity == TEX.mimi.transformer.context
    assert TEX.mimi.transformer.capacity % CFG.mimi.upsample_stride


# ------------------------------------------------------------ mimi ring --

@pytest.mark.parametrize("kv8", [False, True])
def test_mimi_ring_matches_jax_before_and_after_the_wrap(kv8):
    """Six 16-step blocks through a 40-slot ring (the first wrap inside
    block 2): y and the ring (bytes and scales with kv8) match the JAX
    package's XLA route at every block."""
    mcfg = dataclasses.replace(TEX.mimi.transformer, quantize_kv=kv8)
    pj = PJ["mimi"]["decoder_transformer"]
    pt = PT["mimi"]["decoder_transformer"]
    sj, st = jmt.init_state(mcfg), tmt.init_state(mcfg)
    rng = np.random.RandomState(3 + kv8)
    for step in range(6):
        x = (rng.randn(16, mcfg.d_model) * 0.5).astype(np.float32)
        sj, yj = jmt.forward(pj, mcfg, sj, jnp.asarray(x), True)
        st, yt = tmt.forward(pt, mcfg, st, torch.from_numpy(x), True)
        close(yt, yj, msg=f"block {step}")
        for l in range(mcfg.num_layers):
            close(st.k[l].float(), np.asarray(sj.k[l], np.float32),
                  msg=f"k{l}")
            if kv8:
                close(st.k_scale[l], sj.k_scale[l], msg=f"k_scale{l}")
    assert st.offset == int(sj.offset) == 96


def test_mimi_exact_ring_matches_rounded_until_the_wrap():
    """The JAX contract (tests/test_config_variants.py): the 40-slot ring
    equals the 48-slot one until its first wrap and differs after."""
    pt = PT["mimi"]["decoder_transformer"]
    rounded = dataclasses.replace(TEX.mimi.transformer, capacity=48,
                                  mask_value=-1e9, use_pallas_attn=None)
    exact = dataclasses.replace(TEX.mimi.transformer, mask_value=-1e9)
    s_r, s_e = tmt.init_state(rounded), tmt.init_state(exact)
    rng = np.random.RandomState(7)
    diverged = False
    for step in range(4):
        x = torch.from_numpy((rng.randn(16, exact.d_model) * 0.1)
                             .astype(np.float32))
        s_r, y_r = tmt.forward(pt, rounded, s_r, x)
        s_e, y_e = tmt.forward(pt, exact, s_e, x)
        same = torch.allclose(y_r, y_e, atol=1e-6)
        if step * 16 + 16 <= exact.context:
            assert same, step
        diverged |= not same
    assert diverged


def test_mimi_ring_lanes_match_jax_streams():
    """Two lanes of the exact ring, the second joining at offset 16: each
    lane's y equals the JAX stream fed the same blocks from its start."""
    mcfg = TEX.mimi.transformer
    pj = PJ["mimi"]["decoder_transformer"]
    pt = PT["mimi"]["decoder_transformer"]
    rng = np.random.RandomState(5)
    xs = (rng.randn(5, 2, 16, mcfg.d_model) * 0.5).astype(np.float32)
    st = tmt.init_state(mcfg)
    st.k = [k[None].repeat(2, 1, 1) for k in st.k]
    st.v = [v[None].repeat(2, 1, 1) for v in st.v]
    st.offset = 16
    st.start = torch.tensor([16, 32], dtype=torch.int32)
    lanes = []
    for i in range(5):
        st, y = tmt.forward(pt, mcfg, st, torch.from_numpy(xs[i]), True)
        lanes.append(y.numpy())
    for b, first in ((0, 0), (1, 1)):
        sj = jmt.init_state(mcfg)
        sj = sj.replace(offset=jnp.int32(16 * (b + 1)),
                        start=jnp.int32(16 * (b + 1)))
        for i in range(first, 5):
            sj, yj = jmt.forward(pj, mcfg, sj, jnp.asarray(xs[i, b]), True)
            close(lanes[i][b], yj, msg=f"lane {b} block {i}")


# -------------------------------------------------------------- backbone --

@pytest.mark.parametrize("quantize", [None, "int8"])
def test_backbone_plain_decode_matches_jax(quantize):
    """Padded prefill (T=12, 10 valid) then 4 decode steps on the plain
    route under the -1e5 mask: y and the cache match the JAX package's."""
    from pocket_tts_tpu.io.quant import quantize_params as jq
    from pocket_tts_tpu_torch.io.quant import quantize_params as tq
    cfg = TEX.backbone
    pj = jq(PJ, bits=8) if quantize else PJ
    pt = tq(PT, bits=8) if quantize else PT
    rng = np.random.RandomState(11)
    sj, st = jbb.init_state(cfg), tbb.init_state(cfg)
    x = (rng.randn(12, cfg.d_model) * 0.5).astype(np.float32)
    sj, yj = jbb.forward(pj, cfg, sj, jnp.asarray(x), 10)
    sj = jbb.advance(sj, 12, 10)
    st, yt = tbb.forward(pt, cfg, st, torch.from_numpy(x), 10)
    tbb.advance(st, 12, 10)
    close(yt, yj, msg="prefill")
    for i in range(4):
        xi = (rng.randn(1, cfg.d_model) * 0.5).astype(np.float32)
        sj, yj = jbb.forward(pj, cfg, sj, jnp.asarray(xi), 1)
        sj = jbb.advance(sj, 1, 1)
        st, yt = tbb.forward(pt, cfg, st, torch.from_numpy(xi), 1)
        tbb.advance(st, 1, 1)
        close(yt, yj, msg=f"decode {i}")
    for l in range(cfg.num_layers):
        close(st.k[l], sj.k[l], msg=f"k{l}")
        close(st.v[l], sj.v[l], msg=f"v{l}")


# ------------------------------------------------------------ end to end --

def jengine(cfg):
    return JEngine(params=PJ, cfg=cfg, tokenizer=MockTokenizer(
        CFG.lut.n_bins))


def tengine(cfg, **kw):
    return TTSEngine(params=PT, cfg=cfg, device="cpu",
                     tokenizer=MockTokenizer(CFG.lut.n_bins), **kw)


def test_synthesize_matches_jax_and_differs_from_default():
    want = jengine(JEX).synthesize(TEXT, VOICE, temp=0.0)
    got = tengine(TEX).synthesize(TEXT, VOICE, temp=0.0)
    assert got.shape == want.shape and got.size > 0
    close(got, want)
    default = tengine(CFG).synthesize(TEXT, VOICE, temp=0.0)
    assert default.shape == got.shape and not np.array_equal(default, got)


def test_batched_engine_matches_jax():
    texts = ["Hello there.", TEXT]
    jbe = JBatched(jengine(JEX))
    want = jbe.synthesize_batch(texts, jbe.prime_voices([VOICE] * 2), 0.0)
    tbe = BatchedEngine(tengine(TEX))
    got = tbe.synthesize_batch(texts, tbe.prime_voices([VOICE] * 2), 0.0)
    for g, w in zip(got, want):
        assert g.shape == np.asarray(w).shape
        close(g, w)


FUSED = [("pocket_tts_tpu_torch.models.backbone", n) for n in (
    "decode_attention", "decode_insert_attention")] + [
    ("pocket_tts_tpu_torch.models.mimi_transformer", "ring_insert_attention"),
    ("pocket_tts_tpu_torch.ops.fused_layer", "pre_attention"),
    ("pocket_tts_tpu_torch.ops.fused_layer", "post_attention"),
    ("pocket_tts_tpu_torch.ops.fused_layer", "bilayer_post_pre"),
    ("pocket_tts_tpu_torch.ops.fused_step", "megalayer")]


def _forbid_fused(monkeypatch):
    import importlib

    def boom(*a, **k):
        raise AssertionError("a fused kernel wrapper ran on the plain route")
    for mod, name in FUSED:
        monkeypatch.setattr(importlib.import_module(mod), name, boom)


@pytest.mark.parametrize("opts", [
    dict(quantize="int8"),
    dict(quantize="int4", quantize_kv=True, use_bilayer=True),
    dict(quantize="int8", use_megalayer=True, fuse_insert=True),
])
def test_route_comes_from_the_cfg(opts, monkeypatch):
    """With the reference-exact cfg the port calls no fused wrapper, solo
    and batched, whatever K7/K8/K5c option is set, and its quantized
    linears still go through K4a/K4b's wrappers; with the default cfg the
    same engine calls the fused wrappers."""
    opts = dict(opts)
    bb = {k: opts.pop(k) for k in ("use_bilayer", "use_megalayer",
                                   "fuse_insert") if k in opts}
    tm = tiny_config(64)
    pj, cfg64 = params_from_flat(random_flat(tm, seed=62), tm)
    pt = from_jax_numpy(jax.tree.map(np.asarray, pj))
    cfg = dataclasses.replace(texact(cfg64), backbone=dataclasses.replace(
        texact(cfg64).backbone, **bb))
    voice = random_voice_prompt(cfg64, 16)
    calls = {"n": 0}
    for name in ("int8_matmul", "int4_matmul"):
        real = getattr(quant_matmul, name)

        def spy(*a, _real=real, **k):
            calls["n"] += 1
            return _real(*a, **k)
        monkeypatch.setattr("pocket_tts_tpu_torch.ops.basic." + name, spy)
    with monkeypatch.context() as m:
        _forbid_fused(m)
        eng = TTSEngine(params=pt, cfg=cfg, device="cpu",
                        tokenizer=MockTokenizer(cfg64.lut.n_bins), **opts)
        pcm = eng.synthesize("Hi there.", voice, temp=0.0)
        be = BatchedEngine(eng)
        be.synthesize_batch(["Hi.", "Two words."],
                            be.prime_voices([voice] * 2), 0.0)
    assert pcm.size > 0 and np.isfinite(pcm).all() and calls["n"] > 0
    default = TTSEngine(params=pt, cfg=cfg64, device="cpu",
                        tokenizer=MockTokenizer(cfg64.lut.n_bins), **opts)
    with monkeypatch.context() as m:
        _forbid_fused(m)
        with pytest.raises(AssertionError, match="fused kernel wrapper"):
            default.synthesize("Hi there.", voice, temp=0.0)


def test_q4_0_with_megalayer_runs_on_the_plain_route():
    """q4_0 weights with backbone.use_megalayer raise on the kernel route
    (K8 takes no K-grouped scales) but run on the plain route, which
    launches no K8."""
    tm = tiny_config(64)
    pj, cfg64 = params_from_flat(random_flat(tm, seed=63), tm)
    pt = from_jax_numpy(jax.tree.map(np.asarray, pj))
    kw = dict(params=pt, device="cpu", quantize="q4_0",
              tokenizer=MockTokenizer(cfg64.lut.n_bins))

    def mega(cfg):
        return dataclasses.replace(cfg, backbone=dataclasses.replace(
            cfg.backbone, use_megalayer=True, fuse_insert=True))
    with pytest.raises(NotImplementedError, match="q4_0"):
        TTSEngine(cfg=mega(cfg64), **kw)
    eng = TTSEngine(cfg=mega(texact(cfg64)), **kw)
    pcm = eng.synthesize("Hi.", random_voice_prompt(cfg64, 16), temp=0.0)
    assert pcm.size > 0 and np.isfinite(pcm).all()
