"""K2: mimi ring-cache insert + T=16 attention, in place.

Replaces the TPU kernel `pocket_tts_tpu/ops/pallas_mimi.py:
ring_insert_attention`. The CUDA kernel is `csrc/ring_attn.cu` (its header
says what bounds it on the H100 and what the design does about it); the
plain version is the `ops/attention.py` composition the JAX package runs
off the TPU: `cache_insert_ring` + `ring_cache_bias` + `sdpa_seg`.

`ring_insert_attention` runs the plain version for tensors on the CPU and
the kernel for tensors on the card; there is no other switch. Both update
the caches IN PLACE (the JAX function returns new caches).
"""
from __future__ import annotations

import torch

from . import cuda_lib
from .attention import cache_insert_ring, ring_cache_bias, sdpa_seg


def ring_insert_attention_plain(q, k_new, v_new, k_cache, v_cache,
                                offset: int, start: int, num_heads: int,
                                context: int):
    """q/k_new/v_new: (T, H*D) post-rope rows; k/v_cache: (cap, H*D),
    PRE-insert, written in place; offset: timesteps written so far; start:
    the stream's first timestep. Returns attn (T, H*D)."""
    t, hd = q.shape
    cap = k_cache.shape[0]
    cache_insert_ring(k_cache, k_new, offset)
    cache_insert_ring(v_cache, v_new, offset)
    bias = ring_cache_bias(t, cap, offset, context, start=start,
                           device=q.device)
    out = sdpa_seg(q.view(t, num_heads, hd // num_heads), k_cache, v_cache,
                   bias)
    return out.reshape(t, hd)


def ring_insert_attention(q, k_new, v_new, k_cache, v_cache, offset: int,
                          start: int, num_heads: int, context: int):
    """Same contract as ring_insert_attention_plain; launches the CUDA
    kernel for CUDA tensors (float32 or bfloat16, D = 64, T <= 16, cap and
    offset multiples of T)."""
    if q.device.type == "cpu":
        return ring_insert_attention_plain(q, k_new, v_new, k_cache, v_cache,
                                           offset, start, num_heads, context)
    if q.device.type != "cuda":
        raise ValueError(f"ring_insert_attention: unsupported device "
                         f"{q.device}")
    t, hd = q.shape
    cap = k_cache.shape[0]
    d = hd // num_heads
    ops = (q, k_new, v_new, k_cache, v_cache)
    if not (k_new.shape == v_new.shape == (t, hd)
            and k_cache.shape == v_cache.shape == (cap, hd)
            and all(x.dtype == q.dtype and x.is_contiguous()
                    and x.device == q.device for x in ops)
            and cap % t == 0 and offset % t == 0 and 0 <= start <= offset):
        raise ValueError("ring_insert_attention: bad operands "
                         f"q{tuple(q.shape)} cache{tuple(k_cache.shape)} "
                         f"offset={offset} start={start}")
    out = torch.empty_like(q)
    rc = cuda_lib.library().ptt_ring_attn(
        q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(), k_cache.data_ptr(),
        v_cache.data_ptr(), out.data_ptr(), t, num_heads, d, cap, int(offset),
        int(start), int(context), cuda_lib.dtype_code(q),
        cuda_lib.stream_ptr(q.device))
    cuda_lib.check(rc, "ptt_ring_attn")
    ring_insert_attention.launches += 1
    return out


ring_insert_attention.launches = 0
