"""K2: mimi ring-cache insert + T=16 attention, in place.

Replaces the TPU kernel `pocket_tts_tpu/ops/pallas_mimi.py:
ring_insert_attention`. The CUDA kernel is `csrc/ring_attn.cu` (its header
says what bounds it on the H100 and what the design does about it); the
plain version is the `ops/attention.py` composition the JAX package runs
off the TPU: `cache_insert_ring` + `ring_cache_bias` + `sdpa_seg`.

`ring_insert_attention` runs the plain version for tensors on the CPU and
the kernel for tensors on the card; there is no other switch. Both update
the caches IN PLACE (the JAX function returns new caches). Both take an
optional lane axis: B streams that share the ring offset, each with its own
start (continuous batching), in one launch.
"""
from __future__ import annotations

import torch

from . import cuda_lib
from .attention import cache_insert_ring, ring_cache_bias, sdpa_seg
from .basic import inv_sqrt


def ring_insert_attention_plain(q, k_new, v_new, k_cache, v_cache,
                                offset: int, start, num_heads: int,
                                context: int):
    """q/k_new/v_new: (T, H*D) post-rope rows; k/v_cache: (cap, H*D),
    PRE-insert, written in place; offset: timesteps written so far; start:
    the stream's first timestep. Returns attn (T, H*D).

    With a lane axis: q/k_new/v_new (B, T, H*D), caches (B, cap, H*D), the
    offset shared by the lanes and start a (B,) int32 tensor (each lane's
    first timestep); returns (B, T, H*D)."""
    if q.dim() == 3:
        return _ring_plain_lanes(q, k_new, v_new, k_cache, v_cache, offset,
                                 start, num_heads, context)
    t, hd = q.shape
    cap = k_cache.shape[0]
    cache_insert_ring(k_cache, k_new, offset)
    cache_insert_ring(v_cache, v_new, offset)
    bias = ring_cache_bias(t, cap, offset, context, start=start,
                           device=q.device)
    out = sdpa_seg(q.view(t, num_heads, hd // num_heads), k_cache, v_cache,
                   bias)
    return out.reshape(t, hd)


def _ring_plain_lanes(q, k_new, v_new, k_cache, v_cache, offset: int,
                      starts, num_heads: int, context: int):
    """The plain version over B lanes: the same rows of every lane's ring
    are written, and lane b's bias fences positions below starts[b]."""
    b, t, hd = q.shape
    cap = k_cache.shape[1]
    d = hd // num_heads
    idx = (offset + torch.arange(t, device=q.device)) % cap
    k_cache[:, idx] = k_new.to(k_cache.dtype)
    v_cache[:, idx] = v_new.to(v_cache.dtype)
    bias = ring_cache_bias(t, cap, offset, context,
                           start=starts[:, None, None],
                           device=q.device)                  # (B, T, cap)
    logits = torch.einsum("bthd,bshd->bhts",
                          q.view(b, t, num_heads, d).float(),
                          k_cache.view(b, cap, num_heads, d).float())
    w = torch.softmax(logits * inv_sqrt(d) + bias[:, None], -1)
    out = torch.einsum("bhts,bshd->bthd", w.to(v_cache.dtype).float(),
                       v_cache.view(b, cap, num_heads, d).float())
    return out.to(q.dtype).reshape(b, t, hd)


def ring_insert_attention(q, k_new, v_new, k_cache, v_cache, offset: int,
                          start, num_heads: int, context: int):
    """Same contract as ring_insert_attention_plain, solo or with a lane
    axis; launches the CUDA kernel for CUDA tensors (float32 or bfloat16,
    D = 64, T <= 16, cap and offset multiples of T), one launch for all
    lanes."""
    if q.device.type == "cpu":
        return ring_insert_attention_plain(q, k_new, v_new, k_cache, v_cache,
                                           offset, start, num_heads, context)
    if q.device.type != "cuda":
        raise ValueError(f"ring_insert_attention: unsupported device "
                         f"{q.device}")
    lanes = q.dim() == 3
    b = q.shape[0] if lanes else 1
    t, hd = q.shape[-2:]
    cap = k_cache.shape[-2]
    d = hd // num_heads
    ops = (q, k_new, v_new, k_cache, v_cache)
    shape = (b, t, hd) if lanes else (t, hd)
    cshape = (b, cap, hd) if lanes else (cap, hd)
    if lanes:
        start_ok = (isinstance(start, torch.Tensor) and start.shape == (b,)
                    and start.dtype == torch.int32
                    and start.device == q.device and start.is_contiguous())
    else:
        start_ok = 0 <= start <= offset
    if not (k_new.shape == v_new.shape == shape
            and k_cache.shape == v_cache.shape == cshape
            and all(x.dtype == q.dtype and x.is_contiguous()
                    and x.device == q.device for x in ops)
            and cap % t == 0 and offset % t == 0 and start_ok):
        raise ValueError("ring_insert_attention: bad operands "
                         f"q{tuple(q.shape)} cache{tuple(k_cache.shape)} "
                         f"offset={offset} start={start}")
    out = torch.empty_like(q)
    rc = cuda_lib.library().ptt_ring_attn(
        q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(), k_cache.data_ptr(),
        v_cache.data_ptr(), out.data_ptr(), start.data_ptr() if lanes else 0,
        b, t, num_heads, d, cap, int(offset), 0 if lanes else int(start),
        int(context), cuda_lib.dtype_code(q), cuda_lib.stream_ptr(q.device))
    cuda_lib.check(rc, "ptt_ring_attn")
    ring_insert_attention.launches += 1
    return out


ring_insert_attention.launches = 0
