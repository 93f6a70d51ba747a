"""The mimi transformer's checkpoint-driven variants in the port against the
JAX package, on the CPU: RMSNorm `alpha` norms, the cross-attention
sub-block and SwiGLU gating (shared, and weights-per-step), alone and
together, over several 16-row steps through the ring (the port on its
kernel route, K2's plain version here, and on its plain route; JAX on its
XLA route), float32 within 1e-5; int8 weights within 1e-5 of the output's
largest magnitude. The route of a quantized gated (or alpha, or cross)
layer: K2 and K4a, never K5a/K5b. Gating and alpha over 3 lanes that
joined at different steps equal solo streams with the same shared ring
offset; a cross state over lanes raises."""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pocket_tts_tpu.config import tiny_config
from pocket_tts_tpu.io import quant as jq
from pocket_tts_tpu.io.params import params_from_flat as jload
from pocket_tts_tpu.io.params import random_flat
from pocket_tts_tpu.models import mimi_transformer as jmt
from pocket_tts_tpu_torch.io import quant as tq
from pocket_tts_tpu_torch.io.params import from_jax_numpy
from pocket_tts_tpu_torch.io.params import params_from_flat as tload
from pocket_tts_tpu_torch.models import mimi_transformer as tmt

torch.set_num_threads(1)
STEPS = 4


def mimi_flat(cfg0, seed=7, cross=False, rms=False):
    """A tiny flat checkpoint whose mimi layers carry cross weights and/or
    RMSNorm alphas (the JAX package's tests/test_mimi_cross.py layout)."""
    flat = random_flat(cfg0, seed=seed)
    mc = cfg0.mimi.transformer
    rng = np.random.RandomState(seed + 1)
    d = mc.d_model
    for i in range(mc.num_layers):
        pre = f"mimi.decoder_transformer.transformer.layers.{i}."
        if cross:
            flat[pre + "norm_cross.weight"] = (
                1 + 0.1 * rng.randn(d)).astype(np.float32)
            flat[pre + "norm_cross.bias"] = (0.1 * rng.randn(d)).astype(
                np.float32)
            flat[pre + "cross_attention.in_proj.weight"] = (
                rng.randn(3 * d, d).astype(np.float32) * 0.1)
            flat[pre + "cross_attention.out_proj.weight"] = (
                rng.randn(d, d).astype(np.float32) * 0.1)
        if rms:
            for n in ("norm1", "norm2"):
                del flat[pre + n + ".weight"]
                del flat[pre + n + ".bias"]
                flat[pre + n + ".alpha"] = (
                    1.0 + 0.1 * rng.randn(d)).astype(np.float32)
    return flat


def gating_tree(mc, hdim, steps=0, seed=3):
    """numpy SwiGLU weights for every layer, stacked (L, d, 2h) /
    (L, h, d), or per step (L, steps, d, 2h) / (L, steps, h, d)."""
    rng = np.random.RandomState(seed)
    lead = (mc.num_layers,) + ((steps,) if steps else ())
    return {"linear_in": {"w": (rng.randn(*lead, mc.d_model, 2 * hdim)
                                * 0.2).astype(np.float32)},
            "linear_out": {"w": (rng.randn(*lead, hdim, mc.d_model)
                                 * 0.2).astype(np.float32)}}


def models(cross=False, rms=False, gating=None, cfg0=None, quant=None):
    """(JAX mimi-transformer params, port params, mt cfg); gating: None,
    "shared" or "steps" (weights-per-step, 64 modules)."""
    cfg0 = cfg0 or tiny_config()
    flat = mimi_flat(cfg0, cross=cross, rms=rms)
    pj, cfg = jload(flat, cfg0)
    pt, _ = tload(flat, cfg0)
    mc = cfg.mimi.transformer
    pj = pj["mimi"]["decoder_transformer"]
    pt = pt["mimi"]["decoder_transformer"]
    if gating:
        g = gating_tree(mc, 2 * mc.d_model, 64 if gating == "steps" else 0)
        pj = {"layers": dict(pj["layers"], gating=jax.tree.map(jnp.asarray,
                                                               g))}
        pt = {"layers": dict(pt["layers"], gating=from_jax_numpy(g))}
    if quant:
        pj = jq.quantize_params(pj, **quant)
        pt = tq.quantize_params(pt, **quant)
    return pj, pt, mc


def run_both(pj, pt, mc, kernels=True, cond=None, seed=5):
    """STEPS 16-row steps through both packages from fresh states; returns
    [(port y, JAX y)] per step."""
    mcj = dataclasses.replace(mc, use_pallas_attn=False)
    mct = dataclasses.replace(mc, use_pallas_attn=None if kernels
                              else False)
    sj, st = jmt.init_state(mcj), tmt.init_state(mct)
    if cond is not None:
        sj = jmt.init_cross(pj, mcj, sj, jnp.asarray(cond))
        st = tmt.init_cross(pt, mct, st, torch.from_numpy(cond))
        assert st.xk is not None
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(STEPS):
        x = (rng.randn(16, mc.d_model) * 0.5).astype(np.float32)
        sj, yj = jmt.forward(pj, mcj, sj, jnp.asarray(x))
        st, yt = tmt.forward(pt, mct, st, torch.from_numpy(x))
        out.append((yt, yj))
    assert st.offset == int(sj.offset)
    return out


VARIANTS = {"alpha": dict(rms=True), "cross": dict(cross=True),
            "gating": dict(gating="shared"),
            "gating_steps": dict(gating="steps"),
            "all": dict(rms=True, cross=True, gating="steps")}


def _cond(mc, kw):
    if not kw.get("cross"):
        return None
    return np.random.RandomState(11).randn(6, mc.d_model).astype(np.float32)


@pytest.mark.parametrize("kernels", [True, False])
@pytest.mark.parametrize("name", list(VARIANTS))
def test_variant_vs_jax(name, kernels):
    pj, pt, mc = models(**VARIANTS[name])
    for i, (yt, yj) in enumerate(run_both(pj, pt, mc, kernels,
                                          _cond(mc, VARIANTS[name]))):
        np.testing.assert_allclose(yt.numpy(), np.asarray(yj), atol=1e-5,
                                   rtol=0, err_msg=f"step {i}")


@pytest.mark.parametrize("name", ["alpha", "gating", "all"])
def test_variant_int8_vs_jax(name):
    kw = VARIANTS[name]
    pj, pt, mc = models(**kw, cfg0=tiny_config(64), quant={"bits": 8})
    assert "q" in pt["layers"]["in_proj"]
    for yt, yj in run_both(pj, pt, mc, True, _cond(mc, kw)):
        want = np.asarray(yj)
        assert np.abs(yt.numpy() - want).max() <= 1e-5 * np.abs(want).max()


@pytest.mark.parametrize("name,bits", [("gating", 8), ("gating", 4),
                                       ("alpha", 8), ("cross", 4)])
def test_quantized_variant_routes(monkeypatch, name, bits):
    """A quantized variant layer runs K2 once a layer and its linears on
    K4a (int8) / K4b (int4), never K5a/K5b; the same weights without the
    variant take K5a/K5b."""
    from pocket_tts_tpu_torch.ops import basic, fused_layer
    kw = VARIANTS[name]
    _, pt, mc = models(**kw, cfg0=tiny_config(64), quant={"bits": bits})
    calls = []

    def rec(mod, attr, label):
        fn = getattr(mod, attr)

        def wrapped(*a, **k):
            calls.append(label)
            return fn(*a, **k)
        monkeypatch.setattr(mod, attr, wrapped)

    rec(tmt, "ring_insert_attention", "K2")
    rec(fused_layer, "pre_attention", "K5a")
    rec(fused_layer, "post_attention", "K5b")
    rec(basic, "int8_matmul", "K4a")
    rec(basic, "int4_matmul", "K4b")
    st = tmt.init_state(mc)
    if kw.get("cross"):
        tmt.init_cross(pt, mc, st, torch.from_numpy(_cond(mc, kw)))
        calls.clear()
    x = torch.from_numpy(np.random.RandomState(2).randn(
        16, mc.d_model).astype(np.float32))
    tmt.forward(pt, mc, st, x)
    assert calls.count("K2") == mc.num_layers
    assert "K5a" not in calls and "K5b" not in calls
    assert calls.count("K4a" if bits == 8 else "K4b") >= 3 * mc.num_layers
    if name == "gating":
        plain = {"layers": {k: v for k, v in pt["layers"].items()
                            if k != "gating"}}
        calls.clear()
        tmt.forward(plain, mc, tmt.init_state(mc), x)
        assert calls.count("K5a") == calls.count("K5b") == mc.num_layers


@pytest.mark.parametrize("name", ["alpha", "gating_steps"])
def test_lanes_equal_solo_with_shared_offset(name):
    """Three solo streams that joined at offsets 0, 16 and 32 are stacked
    at the shared offset 48 and run 2 more steps as lanes: every lane equals
    its solo stream (gating steps keyed by the shared offset)."""
    _, pt, mc = models(**VARIANTS[name])
    rng = np.random.RandomState(8)
    solos = []
    for start in (0, 16, 32):
        st = tmt.init_state(mc)
        st.offset, st.start = start, start
        while st.offset < 48:
            tmt.forward(pt, mc, st, torch.from_numpy(
                rng.randn(16, mc.d_model).astype(np.float32)))
        solos.append(st)
    lanes = tmt.MimiTransformerState(
        k=[torch.stack([s.k[l] for s in solos]) for l in range(len(
            solos[0].k))],
        v=[torch.stack([s.v[l] for s in solos]) for l in range(len(
            solos[0].v))],
        offset=48, start=torch.tensor([0, 16, 32], dtype=torch.int32))
    for _ in range(2):
        x = torch.from_numpy(rng.randn(3, 16, mc.d_model).astype(
            np.float32))
        _, y = tmt.forward(pt, mc, lanes, x)
        for b, s in enumerate(solos):
            _, ys = tmt.forward(pt, mc, s, x[b])
            np.testing.assert_allclose(y[b].numpy(), ys.numpy(), atol=1e-6,
                                       rtol=0)


def test_cross_state_over_lanes_raises():
    _, pt, mc = models(cross=True)
    st = tmt.init_state(mc)
    tmt.init_cross(pt, mc, st, torch.zeros(4, mc.d_model))
    st.k = [k.expand(2, *k.shape).clone() for k in st.k]
    st.v = [v.expand(2, *v.shape).clone() for v in st.v]
    st.start = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="cross"):
        tmt.forward(pt, mc, st, torch.zeros(2, 16, mc.d_model))


def test_init_cross_without_weights_is_noop():
    _, pt, mc = models(rms=True)
    st = tmt.init_cross(pt, mc, tmt.init_state(mc), torch.zeros(4,
                                                               mc.d_model))
    assert st.xk is None
