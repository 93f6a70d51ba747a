"""K5c, the bilayer kernel (`ops/fused_layer.bilayer_post_pre`: K5b of
layer l with K5a of layer l + 1), against the JAX package, f32, at
tiny_config(32) (every backbone linear quantizes there):

- `bilayer_post_pre_plain` vs the JAX `fused_layer.bilayer_post_pre(...,
  interpret=True)` with per-channel int4 and q4_0 (K-grouped) weights:
  x_next and qkv within 1e-5 (both compute in f32 and differ in summation
  order only), for every layer pair;
- the port's solo `backbone.forward` with `use_bilayer` vs the JAX
  `backbone.forward` with `use_pallas_attn=True, use_bilayer=True` (its
  `_forward_bilayer`, interpret mode), `fuse_insert` off and on, three
  carried decode steps: 1e-4;
- the bilayer loop vs the unfused-boundary path within the port (1e-5),
  and its gate: int8 weights and shared-prefix states do not take it;
- end to end, `TTSEngine.synthesize` at temp 0 at tiny_config(64) with
  int4 weights + use_bilayer vs the JAX engine on the same cfg: 1e-4
  relative to max |pcm|.
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
from pocket_tts_tpu.ops import fused_layer as jfl
from pocket_tts_tpu.ops.basic import slice_layer_params as jslice
from pocket_tts_tpu.runtime.engine import TTSEngine as JEngine
from pocket_tts_tpu_torch.io.params import from_jax_numpy, random_voice_prompt
from pocket_tts_tpu_torch.io.quant import quantize_params
from pocket_tts_tpu_torch.models import backbone as tbb
from pocket_tts_tpu_torch.ops import fused_layer
from pocket_tts_tpu_torch.ops.basic import slice_layer_params
from pocket_tts_tpu_torch.runtime.engine import TTSEngine
from pocket_tts_tpu_torch.text.tokenizer import MockTokenizer

torch.set_num_threads(1)
ATOL = 1e-5
CFG0 = dataclasses.replace(tiny_config(32), backbone=dataclasses.replace(
    tiny_config(32).backbone, num_layers=3))
PJ, CFG = params_from_flat(random_flat(CFG0, seed=5), CFG0)
PT = from_jax_numpy(jax.tree.map(np.asarray, PJ))
QUANT = {"int4": dict(bits=4), "q4_0": dict(bits=4, group=32),
         "int8": dict(bits=8)}
_TREES = {}


def trees(name):
    if name not in _TREES:
        _TREES[name] = (jquantize(PJ, **QUANT[name]),
                        quantize_params(PT, **QUANT[name]))
    return _TREES[name]


def t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("approx", [False, True])
@pytest.mark.parametrize("name", ["int4", "q4_0"])
def test_bilayer_plain_matches_pallas(name, approx):
    qj, qt = trees(name)
    rng = np.random.RandomState(len(name) + approx)
    dm = CFG.backbone.d_model
    for l in range(CFG.backbone.num_layers - 1):
        pj, pj1 = jslice(qj["layers"], l), jslice(qj["layers"], l + 1)
        pt, pt1 = (slice_layer_params(qt["layers"], i) for i in (l, l + 1))
        assert jfl.bilayer_supported(pj, pj1)
        assert fused_layer.bilayer_supported(pt, pt1)
        x = (rng.randn(1, dm) * 0.5).astype(np.float32)
        a = (rng.randn(1, dm) * 0.5).astype(np.float32)
        want = jfl.bilayer_post_pre(pj, pj1, jnp.asarray(x), jnp.asarray(a),
                                    approx=approx, interpret=True)
        got = fused_layer.bilayer_post_pre(pt, pt1, t(x), t(a),
                                           approx=approx)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL,
                                       rtol=0)


def _warm(name):
    qj, qt = trees(name)
    cfgb = CFG.backbone
    rng = np.random.RandomState(0)
    x = rng.randn(10, cfgb.d_model).astype(np.float32) * 0.3
    sj, _ = jbb.forward(qj, cfgb, jbb.init_state(cfgb), jnp.asarray(x))
    st, _ = tbb.forward(qt, cfgb, tbb.init_state(cfgb), t(x))
    return jbb.advance(sj, 10, 10), tbb.advance(st, 10, 10)


@pytest.mark.parametrize("fuse_insert", [False, True])
@pytest.mark.parametrize("name", ["int4", "q4_0"])
def test_bilayer_forward_matches_jax(name, fuse_insert):
    qj, qt = trees(name)
    sj, st = _warm(name)
    cj = dataclasses.replace(CFG.backbone, use_pallas_attn=True,
                             use_bilayer=True, fuse_insert=fuse_insert)
    ct = dataclasses.replace(CFG.backbone, use_bilayer=True,
                             fuse_insert=fuse_insert)
    rng = np.random.RandomState(7)
    for i in range(3):
        step = rng.randn(1, CFG.backbone.d_model).astype(np.float32) * 0.3
        sj, yj = jbb.forward(qj, cj, sj, jnp.asarray(step))
        sj = jbb.advance(sj, 1, 1)
        st, yt = tbb.forward(qt, ct, st, t(step))
        st = tbb.advance(st, 1, 1)
        np.testing.assert_allclose(yt.numpy(), np.asarray(yj), atol=1e-4,
                                   rtol=0, err_msg=f"step {i}")


@pytest.mark.parametrize("name", ["int4", "int8"])
def test_bilayer_loop_and_gate(name, monkeypatch):
    """int4: the bilayer loop runs K5c at each of the L - 1 boundaries and
    matches the per-layer path; int8: the gate leaves it off."""
    _, qt = trees(name)
    _, s0 = _warm(name)
    calls = []
    real = fused_layer.bilayer_post_pre

    def counted(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(fused_layer, "bilayer_post_pre", counted)
    x = t(np.random.RandomState(3).randn(1, CFG.backbone.d_model).astype(
        np.float32) * 0.3)
    ys = []
    for bilayer in (False, True):
        st = tbb.shrink_state(s0, s0.pos.shape[0])
        cfg = dataclasses.replace(CFG.backbone, use_bilayer=bilayer)
        ys.append(tbb.forward(qt, cfg, st, x)[1])
    assert len(calls) == (CFG.backbone.num_layers - 1 if name == "int4"
                          else 0)
    np.testing.assert_allclose(ys[1].numpy(), ys[0].numpy(), atol=ATOL,
                               rtol=0)


def test_bilayer_counts_nothing_on_cpu_and_refuses_other_devices():
    _, qt = trees("int4")
    p0, p1 = (slice_layer_params(qt["layers"], i) for i in (0, 1))
    n = fused_layer.bilayer_post_pre.launches_bilayer
    x = torch.zeros(1, CFG.backbone.d_model)
    fused_layer.bilayer_post_pre(p0, p1, x, x)
    assert n == fused_layer.bilayer_post_pre.launches_bilayer
    m = torch.empty(1, CFG.backbone.d_model, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        fused_layer.bilayer_post_pre(p0, p1, m, m)


CFG64 = tiny_config(64)
CFG64 = dataclasses.replace(CFG64, backbone=dataclasses.replace(
    CFG64.backbone, kv_capacity=256, use_bilayer=True))
P64J, CFG64 = params_from_flat(random_flat(CFG64, seed=13, scale=0.05),
                               CFG64)
P64 = from_jax_numpy(jax.tree.map(np.asarray, P64J))


def test_engine_int4_bilayer_matches_jax():
    text = "Hello world there. A second sentence."
    voice = random_voice_prompt(CFG64, 12, seed=1)
    kw = dict(cfg=CFG64, seed=0, quantize="int4",
              tokenizer=MockTokenizer(CFG64.lut.n_bins))
    want = np.asarray(JEngine(params=P64J, **kw).synthesize(text, voice,
                                                            temp=0.0))
    got = TTSEngine(params=P64, device="cpu", **kw).synthesize(text, voice,
                                                               temp=0.0)
    assert got.shape == want.shape and want.size > 0
    scale = np.abs(want).max()
    np.testing.assert_allclose(got / scale, want / scale, atol=1e-4, rtol=0)
