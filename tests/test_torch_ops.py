"""Port ops vs the JAX ops on the same numpy inputs (f32, atol 1e-5):
basic, rope, attention and conv."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pocket_tts_tpu.ops import attention as ja
from pocket_tts_tpu.ops import basic as jb
from pocket_tts_tpu.ops import conv as jc
from pocket_tts_tpu.ops import rope as jr
from pocket_tts_tpu_torch.ops import attention as ta
from pocket_tts_tpu_torch.ops import basic as tb
from pocket_tts_tpu_torch.ops import conv as tc
from pocket_tts_tpu_torch.ops import rope as tr

torch.set_num_threads(1)
ATOL = 1e-5


def rnd(seed, *shape, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


def J(tree):
    if isinstance(tree, dict):
        return {k: J(v) for k, v in tree.items()}
    return jnp.asarray(tree)


def T(tree):
    if isinstance(tree, dict):
        return {k: T(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol,
                               rtol=0)


# --------------------------------------------------------------- basic ---

@pytest.mark.parametrize("bias", [True, False])
def test_linear(bias):
    p = {"w": rnd(0, 24, 40, scale=0.2)}
    if bias:
        p["b"] = rnd(1, 40)
    x = rnd(2, 5, 24)
    close(tb.linear(T(p), T(x)), jb.linear(J(p), J(x)))
    close(tb.linear(T(p), T(x[0])), jb.linear(J(p), J(x[0])))


@pytest.mark.parametrize("eps", [1e-5, 1e-6, 0.0])
def test_layer_norm(eps):
    p = {"scale": rnd(0, 32), "bias": rnd(1, 32)}
    x = rnd(2, 7, 32, scale=3.0)
    close(tb.layer_norm(T(p), T(x), eps), jb.layer_norm(J(p), J(x), eps))
    close(tb.layer_norm({}, T(x), eps), jb.layer_norm({}, J(x), eps))


def test_mlp_std_norm():
    p = {"alpha": rnd(0, 48)}
    x = rnd(1, 3, 48, scale=2.0) + 0.5
    close(tb.mlp_std_norm(T(p), T(x)), jb.mlp_std_norm(J(p), J(x)))


@pytest.mark.parametrize("approx", [False, True])
def test_gelu(approx):
    x = rnd(0, 200, scale=3.0)
    close(tb.gelu(T(x), approx), jb.gelu(J(x), approx))


@pytest.mark.parametrize("name", ["elu", "silu"])
def test_activations(name):
    x = rnd(0, 300, scale=4.0)
    close(getattr(tb, name)(T(x)), getattr(jb, name)(J(x)))


def test_modulate():
    x, s, h = rnd(0, 16), rnd(1, 16), rnd(2, 16)
    close(tb.modulate(T(x), T(s), T(h)), jb.modulate(J(x), J(s), J(h)))


# ---------------------------------------------------------------- rope ---

@pytest.mark.parametrize("start", [0, 37, 1000])
def test_rope(start):
    pos = np.arange(start, start + 6, dtype=np.int32)
    cj, sj = jr.rope_cos_sin(jnp.asarray(pos), 16, 10000)
    ct, st = tr.rope_cos_sin(torch.from_numpy(pos), 16, 10000)
    close(ct, cj)
    close(st, sj)
    x = rnd(3, 6, 4, 16)
    close(tr.apply_rope_halves(T(x), ct, st),
          jr.apply_rope_halves(J(x), cj, sj))


# ----------------------------------------------------------- attention ---

def test_sdpa_with_pos_bias():
    s, h, d = 40, 4, 16
    q, k, v = rnd(0, 6, h, d), rnd(1, s, h, d), rnd(2, s, h, d)
    pos = np.full(s, -1, np.int32)
    pos[:30] = np.arange(30)
    pos[5:8] = -1
    qpos = np.arange(24, 30, dtype=np.int32)
    bj = ja.pos_cache_bias(jnp.asarray(qpos), jnp.asarray(pos))
    bt = ta.pos_cache_bias(torch.from_numpy(qpos), torch.from_numpy(pos))
    close(bt, bj)
    close(ta.sdpa(T(q), T(k), T(v), bt), ja.sdpa(J(q), J(k), J(v), bj))


@pytest.mark.parametrize("t", [1, 16])
def test_sdpa_seg_flat_cache(t):
    s, h, d = 48, 2, 16
    q, k, v = rnd(0, t, h, d), rnd(1, s, h * d), rnd(2, s, h * d)
    bias = np.where(rnd(3, t, s) > -0.5, 0.0, -1e9).astype(np.float32)
    fn_j = ja.sdpa_decode_seg if t == 1 else ja.sdpa_seg
    fn_t = ta.sdpa_decode_seg if t == 1 else ta.sdpa_seg
    close(fn_t(T(q), T(k), T(v), T(bias)), fn_j(J(q), J(k), J(v), J(bias)))


@pytest.mark.parametrize("end_offset", [0, 5, 48, 50, 97, 4096])
def test_ring_positions(end_offset):
    np.testing.assert_array_equal(
        ta.ring_positions(end_offset, 48).numpy(),
        np.asarray(ja.ring_positions(jnp.int32(end_offset), 48)))


@pytest.mark.parametrize("offset,start", [(0, 0), (32, 0), (48, 16),
                                          (96, 32), (4096, 4000)])
def test_ring_cache_bias(offset, start):
    close(ta.ring_cache_bias(16, 48, offset, 40, start=start),
          ja.ring_cache_bias(16, 48, jnp.int32(offset), 40,
                             start=jnp.int32(start)), atol=0)


@pytest.mark.parametrize("offset", [0, 16, 32, 48, 112])
def test_cache_insert_ring(offset):
    cache, new = rnd(0, 48, 8), rnd(1, 16, 8)
    want = ja.cache_insert_ring(J(cache), J(new), jnp.int32(offset))
    got = T(cache)
    ta.cache_insert_ring(got, T(new), offset)   # in place
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------- conv ---

@pytest.mark.parametrize("k", [1, 3, 7])
def test_streaming_conv1d(k):
    p = {"w": rnd(0, 12, 8, k, scale=0.3), "b": rnd(1, 12)}
    prev = rnd(2, k - 1, 8)
    x = rnd(3, 16, 8)
    nj, yj = jc.streaming_conv1d(J(p), J(prev), J(x))
    nt, yt = tc.streaming_conv1d(T(p), T(prev), T(x))
    close(yt, yj)
    close(nt, nj)


@pytest.mark.parametrize("stride", [4, 5, 6])
def test_streaming_conv_transpose1d(stride):
    p = {"w": rnd(0, 8, 6, 2 * stride, scale=0.3), "b": rnd(1, 6)}
    prev = rnd(2, stride, 6)
    x = rnd(3, 16, 8)
    nj, yj = jc.streaming_conv_transpose1d(J(p), J(prev), J(x), stride)
    nt, yt = tc.streaming_conv_transpose1d(T(p), T(prev), T(x), stride)
    close(yt, yj)
    close(nt, nj)


def test_conv1d_blocked():
    s, cin = 4, 6
    p = {"w": rnd(0, 5, cin, 3, scale=0.3), "b": rnd(1, 5)}
    xb, prev = rnd(2, 10, s * cin), rnd(3, 1, s * cin)
    nj, yj = jc.conv1d_blocked(J(p), J(xb), J(prev))
    nt, yt = tc.conv1d_blocked(T(p), T(xb), T(prev))
    close(yt, yj)
    close(nt, nj)


def test_streaming_conv_transpose1d_blocked():
    s = 4
    p = {"w": rnd(0, 8, 5, 2 * s, scale=0.3), "b": rnd(1, 5)}
    prev, x = rnd(2, 1, s * 5), rnd(3, 12, 8)
    nj, yj = jc.streaming_conv_transpose1d_blocked(J(p), J(prev), J(x), s)
    nt, yt = tc.streaming_conv_transpose1d_blocked(T(p), T(prev), T(x), s)
    close(yt, yj)
    close(nt, nj)


def test_depthwise_upsample():
    p = {"w": rnd(0, 32, 1, 32, scale=0.2)}
    x = rnd(1, 1, 32)
    close(tc.depthwise_upsample(T(p), T(x), 32, 16),
          jc.depthwise_upsample(J(p), J(x), 32, 16))
