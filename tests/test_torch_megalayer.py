"""K8, the whole-layer megakernel (`ops/fused_step.megalayer`), against the
JAX package, f32, at tiny_config(32) (d_model 128: io/quant.py's size gate
quantizes all four backbone linears only at >= 128-wide outputs, as the
JAX package's tests/test_fused_step.py says):

- `megalayer_plain` vs the JAX `fused_step.megalayer(..., interpret=True)`
  for int8 and int4 weights, caches of the working type and int8 caches:
  y, the caches and the scale rows after the insert within 5e-5 (the JAX
  test's own tolerance; int8 bytes therefore equal), with the write slot
  mid-block and at the end of the cache;
- five decode steps carried through the port's `backbone.forward` with
  `use_megalayer` vs the JAX `backbone.forward` with `use_megalayer` (its
  Pallas kernel, interpret mode): 1e-4;
- the port's forward with `use_megalayer` vs without it (the 3-call path
  K5a + K1 + K5b): 1e-5, both cache kinds (every rounding point of K8 is
  exact in f32);
- q4_0 weights with `use_megalayer` raise (engine and wrapper);
- end to end, `TTSEngine.synthesize` at temp 0 at tiny_config(64) vs the
  JAX engine on the same cfg: int8 weights + megalayer (1e-4 relative to
  max |pcm|), and int4 weights + the int8 KV cache + megalayer + the int8
  mimi ring (1e-3: a K/V value within an f32 ulp of an int8 rounding
  boundary quantizes one step apart when the packages sum in another
  order).
"""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pocket_tts_tpu.config import tiny_config
from pocket_tts_tpu.io.params import params_from_flat, random_flat
from pocket_tts_tpu.io.quant import quantize_params as jquantize
from pocket_tts_tpu.models import backbone as jbb
from pocket_tts_tpu.ops import fused_step as jfs
from pocket_tts_tpu.ops.basic import slice_layer_params as jslice
from pocket_tts_tpu.ops.rope import rope_cos_sin as jrope
from pocket_tts_tpu.runtime.engine import TTSEngine as JEngine
from pocket_tts_tpu_torch.io.params import from_jax_numpy, random_voice_prompt
from pocket_tts_tpu_torch.io.quant import quantize_params
from pocket_tts_tpu_torch.models import backbone as tbb
from pocket_tts_tpu_torch.ops import fused_step
from pocket_tts_tpu_torch.ops.basic import quantize_rows, slice_layer_params
from pocket_tts_tpu_torch.ops.rope import rope_cos_sin
from pocket_tts_tpu_torch.runtime.engine import TTSEngine
from pocket_tts_tpu_torch.text.tokenizer import MockTokenizer

torch.set_num_threads(1)
ATOL = 5e-5
CFG0 = tiny_config(32)
PJ, CFG = params_from_flat(random_flat(CFG0, seed=3), CFG0)
PT = from_jax_numpy(jax.tree.map(np.asarray, PJ))
QUANT = {8: dict(bits=8), 4: dict(bits=4), "q4_0": dict(bits=4, group=32)}
_TREES = {}


def trees(bits):
    """(JAX, port) params quantized the same way."""
    if bits not in _TREES:
        _TREES[bits] = (jquantize(PJ, **QUANT[bits]),
                        quantize_params(PT, **QUANT[bits]))
    return _TREES[bits]


def t(a):
    return torch.from_numpy(np.array(a))


def layer_case(seed, kvq, ws):
    """x (1, dm), caches (S, dm) pre-insert with rows 0..ws-1 live (a few
    padding holes) and a stale row at ws, pos (S,) post-insert."""
    bb = CFG.backbone
    s, dm = bb.kv_capacity, bb.d_model
    r = np.random.RandomState(seed)
    x = (r.randn(1, dm) * 0.5).astype(np.float32)
    if kvq:
        k, ks = quantize_rows(t(r.randn(s, dm).astype(np.float32)))
        v, vs = quantize_rows(t(r.randn(s, dm).astype(np.float32)))
        k, ks, v, vs = (a.numpy() for a in (k, ks, v, vs))
        ks[ws] = vs[ws] = 1e3                # stale scales: never read
    else:
        k, v = (r.randn(s, dm).astype(np.float32) for _ in range(2))
        ks = vs = None
        k[ws], v[ws] = 1e3, -1e3             # stale row: never read
    pos = np.arange(s, dtype=np.int32) + 3
    pos[ws + 1:] = -1
    pos[5:9] = -1
    return x, k, v, ks, vs, pos, int(pos[ws])


@pytest.mark.parametrize("ws", [37, 127])
@pytest.mark.parametrize("kvq", [False, True])
@pytest.mark.parametrize("bits", [8, 4])
def test_megalayer_plain_matches_pallas(bits, kvq, ws):
    qj, qt = trees(bits)
    x, k, v, ks, vs, pos, cur = layer_case(bits + ws, kvq, ws)
    bb = CFG.backbone
    for l in range(bb.num_layers):
        cj, sj = jrope(jnp.asarray([cur], jnp.int32), bb.head_dim,
                       bb.max_period)
        kw = (dict(k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs))
              if kvq else {})
        want = jfs.megalayer(jslice(qj["layers"], l), jnp.asarray(x), cj, sj,
                             jnp.int32(cur), jnp.asarray(k), jnp.asarray(v),
                             jnp.asarray(pos), ws, ws, interpret=True, **kw)
        ct, st = rope_cos_sin(t(np.array([cur], np.int32)), bb.head_dim,
                              bb.max_period)
        caches = [t(k.copy()), t(v.copy())]
        if kvq:
            caches += [t(ks.copy()), t(vs.copy())]
        y = fused_step.megalayer(
            slice_layer_params(qt["layers"], l), t(x), ct, st,
            t(np.array([cur], np.int32)), caches[0], caches[1], t(pos), ws,
            ws, *caches[2:])
        np.testing.assert_allclose(y.numpy(), np.asarray(want[0]),
                                   atol=ATOL, rtol=0)
        for got, w in zip(caches, want[1:]):
            assert got.numpy().dtype == np.asarray(w).dtype
            np.testing.assert_allclose(got.numpy().astype(np.float32),
                                       np.asarray(w).astype(np.float32),
                                       atol=ATOL, rtol=0)


def _warm(bits, kvq):
    """(JAX state, port state, backbone cfg) after a 10-row prefill."""
    qj, qt = trees(bits)
    cfgb = dataclasses.replace(CFG.backbone, quantize_kv=kvq)
    rng = np.random.RandomState(0)
    x = rng.randn(10, cfgb.d_model).astype(np.float32) * 0.3
    sj, _ = jbb.forward(qj, cfgb, jbb.init_state(cfgb), jnp.asarray(x))
    st, _ = tbb.forward(qt, cfgb, tbb.init_state(cfgb), t(x))
    return jbb.advance(sj, 10, 10), tbb.advance(st, 10, 10), cfgb


@pytest.mark.parametrize("kvq", [False, True])
@pytest.mark.parametrize("bits", [8, 4])
def test_five_steps_match_jax_megalayer(bits, kvq):
    qj, qt = trees(bits)
    sj, st, cfgb = _warm(bits, kvq)
    cj = dataclasses.replace(cfgb, use_pallas_attn=True, fuse_insert=True,
                             use_megalayer=True)
    ct = dataclasses.replace(cfgb, use_megalayer=True)
    rng = np.random.RandomState(7)
    for i in range(5):
        step = rng.randn(1, cfgb.d_model).astype(np.float32) * 0.3
        sj, yj = jbb.forward(qj, cj, sj, jnp.asarray(step))
        sj = jbb.advance(sj, 1, 1)
        st, yt = tbb.forward(qt, ct, st, t(step))
        st = tbb.advance(st, 1, 1)
        np.testing.assert_allclose(yt.numpy(), np.asarray(yj), atol=1e-4,
                                   rtol=0, err_msg=f"step {i}")


@pytest.mark.parametrize("kvq", [False, True])
def test_megalayer_forward_matches_three_call(kvq):
    _, qt = trees(4)
    _, s0, cfgb = _warm(4, kvq)
    rng = np.random.RandomState(11)
    steps = [t(rng.randn(1, cfgb.d_model).astype(np.float32) * 0.3)
             for _ in range(3)]
    ys = []
    for mega in (False, True):
        st = tbb.shrink_state(s0, s0.pos.shape[0])
        cfg = dataclasses.replace(cfgb, use_megalayer=mega)
        out = []
        for x in steps:
            st, y = tbb.forward(qt, cfg, st, x)
            tbb.advance(st, 1, 1)
            out.append(y)
        ys.append(torch.cat(out))
    np.testing.assert_allclose(ys[1].numpy(), ys[0].numpy(), atol=1e-5,
                               rtol=0)


def test_q4_0_with_megalayer_raises():
    cfg = dataclasses.replace(CFG, backbone=dataclasses.replace(
        CFG.backbone, use_megalayer=True))
    with pytest.raises(NotImplementedError, match="K-grouped"):
        TTSEngine(params=PT, cfg=cfg, quantize="q4_0", device="cpu",
                  tokenizer=MockTokenizer(cfg.lut.n_bins))
    for quantize in ("int8", "int4", None):     # these run
        TTSEngine(params=PT, cfg=cfg, quantize=quantize, device="cpu",
                  tokenizer=MockTokenizer(cfg.lut.n_bins))
    _, qt = trees("q4_0")
    p = slice_layer_params(qt["layers"], 0)
    assert not fused_step.supported(p)
    x, k, v, _, _, pos, cur = layer_case(1, False, 20)
    cos, sin = rope_cos_sin(t(np.array([cur], np.int32)), 32, 10000)
    with pytest.raises(ValueError, match="grouped"):
        fused_step.megalayer(p, t(x), cos, sin, t(np.array([cur], np.int32)),
                             t(k), t(v), t(pos), 20, 20)


def test_megalayer_counts_nothing_on_cpu_and_refuses_other_devices():
    _, qt = trees(8)
    p = slice_layer_params(qt["layers"], 0)
    n = (fused_step.megalayer.launches, fused_step.megalayer.launches_int4,
         fused_step.megalayer.launches_kv8)
    x, k, v, _, _, pos, cur = layer_case(2, False, 20)
    cos, sin = rope_cos_sin(t(np.array([cur], np.int32)), 32, 10000)
    fused_step.megalayer(p, t(x), cos, sin, t(np.array([cur], np.int32)),
                         t(k), t(v), t(pos), 20, 20)
    assert n == (fused_step.megalayer.launches,
                 fused_step.megalayer.launches_int4,
                 fused_step.megalayer.launches_kv8)
    meta = {key: {kk: vv.to("meta") for kk, vv in val.items()}
            for key, val in p.items()}
    m = torch.empty(1, 128, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        fused_step.megalayer(meta, m, m, m, m, m, m, m, 0, 0)


# ------------------------------------------------------------ end to end --

CFG64 = tiny_config(64)
CFG64 = dataclasses.replace(CFG64, backbone=dataclasses.replace(
    CFG64.backbone, kv_capacity=256))
P64J, CFG64 = params_from_flat(random_flat(CFG64, seed=13, scale=0.05),
                               CFG64)
P64 = from_jax_numpy(jax.tree.map(np.asarray, P64J))
TEXT = "Hello world there. A second sentence."


@pytest.mark.parametrize("quantize,kv8,rel", [("int8", False, 1e-4),
                                              ("int4", True, 1e-3)])
def test_engine_megalayer_matches_jax(quantize, kv8, rel):
    cfg = dataclasses.replace(
        CFG64, backbone=dataclasses.replace(CFG64.backbone,
                                            use_megalayer=True,
                                            fuse_insert=True),
        mimi=dataclasses.replace(CFG64.mimi, transformer=dataclasses.replace(
            CFG64.mimi.transformer, quantize_kv=kv8)))
    voice = random_voice_prompt(cfg, 12, seed=1)
    kw = dict(cfg=cfg, seed=0, quantize=quantize, quantize_kv=kv8,
              tokenizer=MockTokenizer(cfg.lut.n_bins))
    want = JEngine(params=P64J, **kw).synthesize(TEXT, voice, temp=0.0)
    eng = TTSEngine(params=P64, device="cpu", **kw)
    assert eng.cfg.backbone.use_megalayer
    got = eng.synthesize(TEXT, voice, temp=0.0)
    want = np.asarray(want)
    assert got.shape == want.shape and want.size > 0
    scale = np.abs(want).max()
    np.testing.assert_allclose(got / scale, want / scale, atol=rel, rtol=0)
