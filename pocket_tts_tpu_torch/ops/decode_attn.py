"""K1: T=1 decode attention over the backbone's flat KV cache.

Replaces the TPU kernel `pocket_tts_tpu/ops/pallas_attn.py:
decode_attention`. The CUDA kernel is `csrc/decode_attn.cu` (its header
says what bounds it on the H100 and what the design does about it); the
plain version is the `ops/attention.py` composition the JAX package runs
off the TPU: `sdpa_decode_seg` under a slot bias.

`decode_attention` runs the plain version for tensors on the CPU and the
kernel for tensors on the card; there is no other switch.
"""
from __future__ import annotations

import torch

from . import cuda_lib
from .attention import NEG_INF, sdpa_decode_seg


def live_slot_bias(pos, end: int):
    """(1, S) additive bias: slot s is attended iff s <= end and its
    recorded position pos[s] >= 0 (the kernel's mask: it reads only the live
    prefix and skips invalid slots)."""
    idx = torch.arange(pos.shape[0], device=pos.device)
    ok = (pos >= 0) & (idx <= end)
    return torch.where(ok, 0.0, NEG_INF).float()[None]


def decode_attention_plain(q, k_cache, v_cache, pos, end: int):
    """q: (H, D); k/v_cache: (S, H*D); pos: (S,) int32; end: last written
    slot. Returns (H, D)."""
    return sdpa_decode_seg(q[None], k_cache, v_cache,
                           live_slot_bias(pos, end))[0]


def decode_attention(q, k_cache, v_cache, pos, end: int):
    """Same contract as decode_attention_plain; launches the CUDA kernel for
    CUDA tensors (float32 or bfloat16, D = 64)."""
    if q.device.type == "cpu":
        return decode_attention_plain(q, k_cache, v_cache, pos, end)
    h, d = q.shape
    s, hd = k_cache.shape
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention: unsupported device {q.device}")
    if not (k_cache.shape == v_cache.shape and hd == h * d
            and pos.shape == (s,) and pos.dtype == torch.int32
            and q.dtype == k_cache.dtype == v_cache.dtype
            and all(t.is_contiguous() and t.device == q.device
                    for t in (q, k_cache, v_cache, pos))
            and 0 <= end < s):
        raise ValueError("decode_attention: bad operands "
                         f"q{tuple(q.shape)} k{tuple(k_cache.shape)} "
                         f"pos{tuple(pos.shape)} end={end}")
    out = torch.empty_like(q)
    rc = cuda_lib.library().ptt_decode_attn(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), pos.data_ptr(),
        out.data_ptr(), h, d, s, hd, int(end), cuda_lib.dtype_code(q),
        cuda_lib.stream_ptr(q.device))
    cuda_lib.check(rc, "ptt_decode_attn")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
