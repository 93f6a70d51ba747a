"""Cross-attention in the port against the JAX package, on the CPU:

- `cross_attn_kv` / `cross_attention` (atol 2e-5);
- the backbone with cross weights (loaded by both packages' loaders from
  one flat checkpoint): `init_cross`, a padded prefill and decode steps,
  output and KV state within 1e-5, on the kernel route (K1's plain
  version here) and the plain route, float and int8 weights, bf16 and int8
  KV caches;
- the route: a cross state's decode step calls K1's wrapper and never
  K7's, K8's, K5a's, K5b's or K5c's, whatever cfg asks for (fuse_insert,
  use_megalayer, use_bilayer on int4 weights), with the int8 KV cache K1
  with its scales;
- a cross state is solo: shrink_state, split_prefix and the lane stacking
  raise ValueError."""
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
from pocket_tts_tpu.models import backbone as jbb
from pocket_tts_tpu.ops import attention as jatt
from pocket_tts_tpu_torch.io import quant as tq
from pocket_tts_tpu_torch.io.params import params_from_flat as tload
from pocket_tts_tpu_torch.models import backbone as tbb
from pocket_tts_tpu_torch.ops import attention as tatt

torch.set_num_threads(1)


def _close(got, want, atol=1e-5, msg=""):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=atol,
                               rtol=0, err_msg=msg)


def cross_flat(cfg0, seed=7):
    """A tiny flat checkpoint with per-layer backbone cross weights (the
    JAX package's tests/test_cross_attention.py layout)."""
    flat = random_flat(cfg0, seed=seed)
    rng = np.random.RandomState(seed + 1)
    d = cfg0.backbone.d_model
    for i in range(cfg0.backbone.num_layers):
        pre = f"flow_lm.transformer.layers.{i}."
        flat[pre + "norm_cross.weight"] = (
            1 + 0.1 * rng.randn(d)).astype(np.float32)
        flat[pre + "norm_cross.bias"] = (0.1 * rng.randn(d)).astype(
            np.float32)
        flat[pre + "cross_attention.in_proj.weight"] = (
            rng.randn(3 * d, d).astype(np.float32) * 0.1)
        flat[pre + "cross_attention.out_proj.weight"] = (
            rng.randn(d, d).astype(np.float32) * 0.1)
    return flat


def test_cross_attention_ops_vs_jax():
    rng = np.random.RandomState(0)
    d, t, s, h = 32, 5, 9, 4
    w_in = rng.randn(d, 3 * d).astype(np.float32) * 0.2
    b_in = rng.randn(3 * d).astype(np.float32) * 0.1
    w_out = rng.randn(d, d).astype(np.float32) * 0.2
    x = rng.randn(t, d).astype(np.float32)
    cond = rng.randn(s, d).astype(np.float32)
    pj = {"in_proj": {"w": jnp.asarray(w_in), "b": jnp.asarray(b_in)},
          "out_proj": {"w": jnp.asarray(w_out)}}
    pt = {"in_proj": {"w": torch.from_numpy(w_in),
                      "b": torch.from_numpy(b_in)},
          "out_proj": {"w": torch.from_numpy(w_out)}}
    kj, vj = jatt.cross_attn_kv(pj["in_proj"], jnp.asarray(cond), h)
    kt, vt = tatt.cross_attn_kv(pt["in_proj"], torch.from_numpy(cond), h)
    assert kt.shape == (s, h, d // h) and vt.shape == (s, h, d // h)
    _close(kt, kj, 2e-5)
    _close(vt, vj, 2e-5)
    _close(tatt.cross_attention(pt, torch.from_numpy(x), kt, vt, h),
           jatt.cross_attention(pj, jnp.asarray(x), kj, vj, h), 2e-5)


def test_loader_picks_up_backbone_cross():
    cfg0 = tiny_config()
    flat = cross_flat(cfg0)
    pj, _ = jload(flat, cfg0)
    pt, _ = tload(flat, cfg0)
    for key in ("norm_cross", "cross_attention"):
        assert key in pt["layers"]
    for path, leaf in jax.tree_util.tree_flatten_with_path(
            pj["layers"])[0]:
        got = pt["layers"]
        for k in path:
            got = got[k.key]
        np.testing.assert_array_equal(got.numpy(), np.asarray(leaf))


def _models(quant, kv8, cfg0=None):
    cfg0 = cfg0 or tiny_config()
    flat = cross_flat(cfg0)
    pj, cfg = jload(flat, cfg0)
    pt, _ = tload(flat, cfg0)
    if quant:
        pj = jq.quantize_params(pj, **quant)
        pt = tq.quantize_params(pt, **quant)
    bb = dataclasses.replace(cfg.backbone, quantize_kv=kv8)
    return pj, pt, bb


@pytest.mark.parametrize("kernels", [True, False])
@pytest.mark.parametrize("quant,kv8", [(None, False), ({"bits": 8}, False),
                                       (None, True)])
def test_backbone_cross_prefill_decode_vs_jax(kernels, quant, kv8):
    """init_cross, a padded 10-row prefill (8 valid), then 4 decode steps:
    each output and the caches at the end within 1e-5 of JAX (its XLA
    route)."""
    pj, pt, bb = _models(quant, kv8)
    bbj = dataclasses.replace(bb, use_pallas_attn=False)
    bbt = dataclasses.replace(bb, use_pallas_attn=None if kernels
                              else False)
    d = bb.d_model
    rng = np.random.RandomState(3)
    cond = rng.randn(6, d).astype(np.float32)
    xs = rng.randn(14, d).astype(np.float32) * 0.5
    sj = jbb.init_cross(pj, bbj, jbb.init_state(bbj), jnp.asarray(cond))
    st = tbb.init_cross(pt, bbt, tbb.init_state(bbt), torch.from_numpy(cond))
    assert len(st.xk) == bb.num_layers
    for l in range(bb.num_layers):
        _close(st.xk[l], sj.xk[l])
        _close(st.xv[l], sj.xv[l])
    sj, yj = jbb.forward(pj, bbj, sj, jnp.asarray(xs[:10]), n_valid=8)
    sj = jbb.advance(sj, 10, 8)
    st, yt = tbb.forward(pt, bbt, st, torch.from_numpy(xs[:10]), n_valid=8)
    st = tbb.advance(st, 10, 8)
    _close(yt, yj, msg="prefill")
    for i in range(10, 14):
        sj, yj = jbb.forward(pj, bbj, sj, jnp.asarray(xs[i:i + 1]))
        sj = jbb.advance(sj, 1, 1)
        st, yt = tbb.forward(pt, bbt, st, torch.from_numpy(xs[i:i + 1]))
        st = tbb.advance(st, 1, 1)
        _close(yt, yj, msg=f"decode {i}")
    for l in range(bb.num_layers):
        _close(st.k[l].float(), np.asarray(sj.k[l], np.float32), 1e-5)
        _close(st.v[l].float(), np.asarray(sj.v[l], np.float32), 1e-5)
        if kv8:
            _close(st.k_scale[l], sj.k_scale[l])


def _record(monkeypatch):
    """Replace the wrappers the backbone reaches with recorders that run
    the originals; returns the list of names called."""
    from pocket_tts_tpu_torch.ops import fused_layer, fused_step
    calls = []

    def rec(mod, name, label):
        fn = getattr(mod, name)

        def wrapped(*a, **k):
            calls.append(label)
            return fn(*a, **k)
        monkeypatch.setattr(mod, name, wrapped)

    rec(tbb, "decode_attention", "K1")
    rec(tbb, "decode_insert_attention", "K7")
    rec(fused_step, "megalayer", "K8")
    rec(fused_layer, "pre_attention", "K5a")
    rec(fused_layer, "post_attention", "K5b")
    rec(fused_layer, "bilayer_post_pre", "K5c")
    return calls


@pytest.mark.parametrize("opts", [
    dict(fuse_insert=True), dict(fuse_insert=True, use_megalayer=True),
    dict(fuse_insert=False, use_bilayer=True), dict(quantize_kv=True)])
def test_cross_decode_routes_to_k1(monkeypatch, opts):
    """A cross state's T = 1 step: K1 once a layer, no K7/K8/K5a/K5b/K5c.
    Without cross KV the same weights take K7 under fuse_insert (layers
    with cross weights never fuse: `fused_layer.supported` refuses them,
    as the JAX package's does)."""
    pj, pt, bb = _models({"bits": 4}, False, tiny_config(64))
    bb = dataclasses.replace(bb, **opts)
    d = bb.d_model
    rng = np.random.RandomState(1)
    x = torch.from_numpy(rng.randn(1, d).astype(np.float32))
    cond = torch.from_numpy(rng.randn(5, d).astype(np.float32))
    calls = _record(monkeypatch)
    st = tbb.init_cross(pt, bb, tbb.init_state(bb), cond)
    tbb.forward(pt, bb, st, x)
    assert calls == ["K1"] * bb.num_layers
    calls.clear()
    tbb.forward(pt, bb, tbb.init_state(bb), x)
    assert calls == ["K7" if bb.fuse_insert else "K1"] * bb.num_layers


def test_cross_state_is_solo():
    from pocket_tts_tpu_torch.runtime import batched
    _, pt, bb = _models(None, False)
    cond = torch.zeros(3, bb.d_model)
    st = tbb.init_cross(pt, bb, tbb.init_state(bb), cond)
    with pytest.raises(ValueError, match="cross"):
        tbb.shrink_state(st, 64)
    with pytest.raises(ValueError, match="cross"):
        tbb.split_prefix(st, 4, bb.num_heads)
    with pytest.raises(ValueError, match="cross"):
        batched.stack_states([st, st])
