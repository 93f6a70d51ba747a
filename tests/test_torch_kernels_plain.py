"""The plain versions of kernels K1-K3 (what the port runs for CPU tensors)
against the JAX package's Pallas kernels in interpret mode, f32, atol 1e-5.

The CUDA kernels themselves run only on the card; `chip_smoke.py` holds
each against these plain versions there."""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pocket_tts_tpu.config import tiny_config
from pocket_tts_tpu.io.params import params_from_flat, random_flat
from pocket_tts_tpu.models import seanet as jseanet
from pocket_tts_tpu.ops.pallas_attn import decode_attention as j_decode
from pocket_tts_tpu.ops.pallas_mimi import ring_insert_attention as j_ring
from pocket_tts_tpu_torch.io.params import from_jax_numpy
from pocket_tts_tpu_torch.models import seanet as tseanet
from pocket_tts_tpu_torch.ops.decode_attn import decode_attention
from pocket_tts_tpu_torch.ops.ring_attn import ring_insert_attention
from pocket_tts_tpu_torch.ops.seanet_frame import kernel_ok, seanet_frame

torch.set_num_threads(1)
ATOL = 1e-5


def rnd(rng, *shape, scale=1.0):
    return (rng.randn(*shape) * scale).astype(np.float32)


# ------------------------------------------------------------------ K1 ---

@pytest.mark.parametrize("h,d,s,end", [
    (4, 16, 128, 0), (4, 16, 128, 63), (4, 16, 256, 128), (4, 16, 256, 255),
    (16, 64, 384, 127), (16, 64, 384, 300),
])
def test_k1_plain_matches_pallas(h, d, s, end):
    rng = np.random.RandomState(end + s)
    q = rnd(rng, h, d)
    k, v = rnd(rng, s, h * d), rnd(rng, s, h * d)
    pos = np.full(s, -1, np.int32)
    pos[: end + 1] = np.arange(end + 1)
    if end > 20:
        pos[3:9] = -1                       # padding rows mid-cache
    k[end + 1:] = 50.0                      # stale slots past `end`
    want = j_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                    jnp.asarray(pos), jnp.int32(end), interpret=True)
    got = decode_attention(torch.from_numpy(q), torch.from_numpy(k),
                           torch.from_numpy(v), torch.from_numpy(pos), end)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)


# ------------------------------------------------------------------ K2 ---

@pytest.mark.parametrize("h,d,cap,ctx,offset,start", [
    (2, 16, 48, 40, 0, 0),
    (2, 16, 48, 40, 32, 0),
    (2, 16, 48, 40, 48, 16),        # ring wrap, fence inside the ring
    (2, 16, 48, 40, 96, 32),
    (8, 64, 256, 250, 0, 0),
    (8, 64, 256, 250, 240, 32),
    (8, 64, 256, 250, 256, 32),     # first wrap
    (8, 64, 256, 250, 4096, 4000),
])
def test_k2_plain_matches_pallas(h, d, cap, ctx, offset, start):
    t = 16
    rng = np.random.RandomState(offset + cap)
    kc, vc = rnd(rng, cap, h * d), rnd(rng, cap, h * d)
    q, kn, vn = (rnd(rng, t, h * d) for _ in range(3))
    attn_j, kc_j, vc_j = j_ring(
        jnp.asarray(q), jnp.asarray(kn), jnp.asarray(vn), jnp.asarray(kc),
        jnp.asarray(vc), jnp.int32(offset), jnp.int32(start), num_heads=h,
        context=ctx, interpret=True)
    kc_t, vc_t = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
    attn_t = ring_insert_attention(
        torch.from_numpy(q), torch.from_numpy(kn), torch.from_numpy(vn),
        kc_t, vc_t, offset, start, h, ctx)
    np.testing.assert_allclose(attn_t.numpy(), np.asarray(attn_j), atol=ATOL,
                               rtol=0)
    np.testing.assert_array_equal(kc_t.numpy(), np.asarray(kc_j))
    np.testing.assert_array_equal(vc_t.numpy(), np.asarray(vc_j))


def test_k2_plain_across_frames_with_fence():
    """Consecutive frames through one ring (wrapping twice) with start > 0:
    the in-place plain step tracks the functional Pallas step."""
    h, d, cap, ctx, t, start = 2, 16, 48, 40, 16, 32
    rng = np.random.RandomState(0)
    kc = vc = np.zeros((cap, h * d), np.float32)
    kj, vj = jnp.asarray(kc), jnp.asarray(vc)
    kt, vt = torch.zeros(cap, h * d), torch.zeros(cap, h * d)
    for off in range(start, start + 8 * t, t):
        q, kn, vn = (rnd(rng, t, h * d) for _ in range(3))
        aj, kj, vj = j_ring(jnp.asarray(q), jnp.asarray(kn), jnp.asarray(vn),
                            kj, vj, jnp.int32(off), jnp.int32(start),
                            num_heads=h, context=ctx, interpret=True)
        at = ring_insert_attention(torch.from_numpy(q), torch.from_numpy(kn),
                                   torch.from_numpy(vn), kt, vt, off, start,
                                   h, ctx)
        np.testing.assert_allclose(at.numpy(), np.asarray(aj), atol=ATOL,
                                   rtol=0, err_msg=f"offset {off}")
        np.testing.assert_array_equal(kt.numpy(), np.asarray(kj))


# ------------------------------------------------------------- dispatch ---

def _call_on(device, name):
    z = lambda *shape: torch.zeros(*shape, device=device)  # noqa: E731
    if name == "decode_attention":
        pos = torch.zeros(128, dtype=torch.int32, device=device)
        return decode_attention(z(4, 16), z(128, 64), z(128, 64), pos, 5)
    if name == "ring_insert_attention":
        return ring_insert_attention(z(16, 32), z(16, 32), z(16, 32),
                                     z(48, 32), z(48, 32), 16, 0, 2, 40)
    return seanet_frame(DEC_T, SC, tseanet.init_state(SC, TPF, device=device),
                        z(TPF, SC.in_ch))


@pytest.mark.parametrize("name", ["decode_attention", "ring_insert_attention",
                                  "seanet_frame"])
def test_wrapper_takes_plain_version_only_for_cpu(name):
    """A wrapper runs its plain version for CPU tensors, without counting a
    kernel launch, and refuses any device other than the CPU and CUDA
    instead of computing another way."""
    wrapper = {"decode_attention": decode_attention, "seanet_frame":
               seanet_frame, "ring_insert_attention": ring_insert_attention
               }[name]
    launches = wrapper.launches
    assert torch.isfinite(_call_on("cpu", name)).all()
    assert wrapper.launches == launches
    with pytest.raises(ValueError, match="unsupported device"):
        _call_on("meta", name)


# ------------------------------------------------------------------ K3 ---

CFG0 = tiny_config()
PJ, CFG = params_from_flat(random_flat(CFG0, seed=44), CFG0)
SC = CFG.mimi.seanet
DEC_J = PJ["mimi"]["decoder"]
DEC_T = from_jax_numpy(jax.tree.map(np.asarray, DEC_J))
TPF = CFG.mimi.upsample_stride


def test_k3_shape_covered():
    assert kernel_ok(SC)


@pytest.mark.parametrize("scale", [0.3, 2.0])
def test_k3_plain_matches_pallas_over_frames(scale):
    """Six frames, carries threaded: the port's seanet_frame (plain on the
    CPU, carries updated in place) == the Pallas megakernel (interpret)."""
    rng = np.random.RandomState(int(scale * 10))
    sc_k = dataclasses.replace(SC, use_pallas=True)
    st_j = jseanet.init_state(sc_k, TPF)
    st_t = tseanet.init_state(SC, TPF)
    assert {k: tuple(v.shape) for k, v in st_t.items()} == \
        {k: tuple(v.shape) for k, v in st_j.items()}
    for f in range(6):
        x = rnd(rng, TPF, SC.in_ch, scale=scale)
        st_j, y_j = jseanet.forward(DEC_J, sc_k, st_j, jnp.asarray(x))
        y_t = seanet_frame(DEC_T, SC, st_t, torch.from_numpy(x))
        np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), atol=ATOL,
                                   rtol=0, err_msg=f"frame {f}")
        for key in st_j:
            np.testing.assert_allclose(
                st_t[key].numpy(), np.asarray(st_j[key]), atol=ATOL, rtol=0,
                err_msg=f"frame {f} carry {key}")
