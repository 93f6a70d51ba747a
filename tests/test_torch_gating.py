"""ops/gating.py of the port against `pocket_tts_tpu/ops/gating.py`, on
the CPU: every case of tests/test_gating.py (SwiGLU gating, the
weights-per-step linear with and without a schedule, M == 1 collapsing to
a shared linear, per-step gating) on the same numpy inputs, float32 within
1e-5; quantized layouts (int8, int4 stacked, M == 1 stacked) byte-identical
out of both packages' quantize_params and within 1e-5 of the largest
output magnitude."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pocket_tts_tpu.io import quant as jq
from pocket_tts_tpu.ops import gating as jg
from pocket_tts_tpu_torch.io import quant as tq
from pocket_tts_tpu_torch.ops import gating as tg

torch.set_num_threads(1)
ATOL = 1e-5


def _j(tree):
    return jax.tree.map(jnp.asarray, tree)


def _t(tree):
    if isinstance(tree, dict):
        return {k: _t(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol,
                               rtol=0)


def _rel(got, want, rel=1e-5):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= rel * max(np.abs(want).max(), 1e-30)


def test_activation_gating_vs_jax():
    rng = np.random.RandomState(0)
    d, hdim, t = 16, 24, 5
    p = {"linear_in": {"w": rng.randn(d, 2 * hdim).astype(np.float32) * 0.2,
                       "b": rng.randn(2 * hdim).astype(np.float32) * 0.1},
         "linear_out": {"w": rng.randn(hdim, d).astype(np.float32) * 0.2,
                        "b": rng.randn(d).astype(np.float32) * 0.1}}
    x = rng.randn(t, d).astype(np.float32)
    _close(tg.activation_gating(_t(p), torch.from_numpy(x)),
           jg.activation_gating(_j(p), jnp.asarray(x)))


@pytest.mark.parametrize("case", ["schedule", "no_schedule", "m1"])
def test_weights_per_step_linear_vs_jax(case):
    rng = np.random.RandomState(1)
    m, cin, cout, t, offset = 4, 8, 12, 6, 2
    w = rng.randn(m, cin, cout).astype(np.float32) * 0.3
    b = rng.randn(m, cout).astype(np.float32) * 0.1
    x = rng.randn(t, cin).astype(np.float32)
    schedule = (0, 1, 1, 2, 3, 3, 2, 0, 1, 3)
    p, kw = {"w": w, "b": b}, dict(offset=offset, schedule=schedule)
    if case == "no_schedule":
        x, kw = x[:2], dict(offset=1)
    elif case == "m1":
        p, kw = {"w": w[:1], "b": b[:1]}, {}
    _close(tg.weights_per_step_linear(_t(p), torch.from_numpy(x), **kw),
           jg.weights_per_step_linear(_j(p), jnp.asarray(x), **kw))


def test_weights_per_step_offset_clamps_like_jax():
    """Offsets past the schedule or the module count clamp as in JAX."""
    rng = np.random.RandomState(5)
    w = rng.randn(3, 6, 5).astype(np.float32)
    x = rng.randn(4, 6).astype(np.float32)
    for kw in (dict(offset=7), dict(offset=2, schedule=(2, 0, 1))):
        _close(tg.weights_per_step_linear(_t({"w": w}), torch.from_numpy(x),
                                          **kw),
               jg.weights_per_step_linear(_j({"w": w}), jnp.asarray(x), **kw))


@pytest.mark.parametrize("m", [3, 1])
def test_weights_per_step_gating_vs_jax(m):
    rng = np.random.RandomState(2)
    d, hdim, t = 10, 14, 3
    p = {"linear_in": {"w": rng.randn(3, d, 2 * hdim).astype(np.float32)
                       [:m] * 0.2},
         "linear_out": {"w": rng.randn(3, hdim, d).astype(np.float32)
                        [:m] * 0.2}}
    x = rng.randn(t, d).astype(np.float32)
    _close(tg.weights_per_step_gating(_t(p), torch.from_numpy(x), offset=0),
           jg.weights_per_step_gating(_j(p), jnp.asarray(x), offset=0))


def test_weights_per_step_gating_over_lanes():
    """Lanes (B, T, d) share the steps: each lane equals its solo call."""
    rng = np.random.RandomState(6)
    d, hdim, t = 8, 6, 3
    p = _t({"linear_in": {"w": rng.randn(4, d, 2 * hdim).astype(
        np.float32)}, "linear_out": {"w": rng.randn(4, hdim, d).astype(
            np.float32)}})
    x = torch.from_numpy(rng.randn(3, t, d).astype(np.float32))
    y = tg.weights_per_step_gating(p, x, offset=1)
    for b in range(3):
        _close(y[b], tg.weights_per_step_gating(p, x[b], offset=1))


def _quant_cases():
    rng = np.random.RandomState(4)
    d, hdim, m = 128, 128, 3
    p2 = {"linear_in": {"w": rng.randn(d, 2 * hdim).astype(np.float32) * .2},
          "linear_out": {"w": rng.randn(hdim, d).astype(np.float32) * .2}}
    pm = {"linear_in": {"w": rng.randn(m, d, 2 * hdim).astype(np.float32)
                        * .2},
          "linear_out": {"w": rng.randn(m, hdim, d).astype(np.float32) * .2}}
    p1 = {k: {"w": v["w"][:1]} for k, v in pm.items()}
    return {"int8 2-D": (p2, 8), "int4 stacked": (pm, 4),
            "int8 M=1": (p1, 8)}


@pytest.mark.parametrize("name", list(_quant_cases()))
def test_gating_quantized_layouts_vs_jax(name):
    """quantize_params gives the JAX package's bytes for the gating tree;
    the gating on them matches JAX within 1e-5 relative."""
    p, bits = _quant_cases()[name]
    x = np.random.RandomState(9).randn(5, 128).astype(np.float32)
    pj = jq.quantize_params(_j(p), bits=bits)
    pt = tq.quantize_params(_t(p), bits=bits)
    fj = {jax.tree_util.keystr(k): np.asarray(v) for k, v in
          jax.tree_util.tree_flatten_with_path(pj)[0]}
    ft = dict(tq._flatten(pt))
    assert sorted(fj) == sorted(ft)
    assert any(k.endswith(("['q']", "['q4']")) for k in ft)
    for k, v in fj.items():
        assert ft[k].numpy().dtype == v.dtype and \
            ft[k].numpy().tobytes() == v.tobytes(), k
    _rel(tg.weights_per_step_gating(pt, torch.from_numpy(x), offset=0),
         jg.weights_per_step_gating(pj, jnp.asarray(x), offset=0))
