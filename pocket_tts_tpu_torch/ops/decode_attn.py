"""K1: T=1 decode attention over the backbone's flat KV cache.

Replaces the TPU kernel `pocket_tts_tpu/ops/pallas_attn.py:
decode_attention` (`_decode_attention_batched`), with caches of the
working type and, with `k_scale`/`v_scale`, int8 caches with per-row
float32 scales (`_make_decode_attention_q`, the solo int8-KV cache). The
CUDA kernel is `csrc/decode_attn.cu` (its header says what bounds it on
the H100 and what the design does about it); the plain version is the
`ops/attention.py` composition the JAX package runs off the TPU:
`sdpa_decode_seg` under a slot bias, and for int8 caches the TPU kernel's
arithmetic (`_flash_main_block` with `quant`): logits (q . k) * scale *
k_scale[s], softmax weights times v_scale[s] rounded to the working type
before the PV product with the int8 rows.

`decode_attention` runs the plain version for tensors on the CPU and the
kernel for tensors on the card; there is no other switch. Launches over
caches of the working type count in `decode_attention.launches`, over
int8 caches in `decode_attention.launches_kv8`.
"""
from __future__ import annotations

import torch

from . import cuda_lib
from .attention import NEG_INF, sdpa_decode_seg
from .basic import inv_sqrt


def live_slot_bias(pos, end: int):
    """(1, S) additive bias: slot s is attended iff s <= end and its
    recorded position pos[s] >= 0 (the kernel's mask: it reads only the live
    prefix and skips invalid slots)."""
    idx = torch.arange(pos.shape[0], device=pos.device)
    ok = (pos >= 0) & (idx <= end)
    return torch.where(ok, 0.0, NEG_INF).float()[None]


def decode_attention_plain(q, k_cache, v_cache, pos, end: int,
                           k_scale=None, v_scale=None):
    """q: (H, D); k/v_cache: (S, H*D) of q's dtype, or int8 with k_scale,
    v_scale (S,) float32; pos: (S,) int32; end: last written slot.
    Returns (H, D) in q's dtype."""
    if k_scale is None:
        return sdpa_decode_seg(q[None], k_cache, v_cache,
                               live_slot_bias(pos, end))[0]
    h, d = q.shape
    s = k_cache.shape[0]
    logits = (torch.einsum("hd,shd->hs", q.float(),
                           k_cache.view(s, h, d).float()) * inv_sqrt(d)
              * k_scale)
    w = torch.softmax(logits + live_slot_bias(pos, end), -1)
    pv = (w * v_scale).to(q.dtype).float()
    return torch.einsum("hs,shd->hd", pv,
                        v_cache.view(s, h, d).float()).to(q.dtype)


def decode_attention(q, k_cache, v_cache, pos, end: int, k_scale=None,
                     v_scale=None):
    """Same contract as decode_attention_plain; launches the CUDA kernel for
    CUDA tensors (q float32 or bfloat16, D = 64; caches of q's dtype, or
    int8 with float32 scales)."""
    if q.device.type == "cpu":
        return decode_attention_plain(q, k_cache, v_cache, pos, end, k_scale,
                                      v_scale)
    h, d = q.shape
    s, hd = k_cache.shape
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention: unsupported device {q.device}")
    quant = k_scale is not None
    scales = (k_scale, v_scale) if quant else ()
    ok = (k_cache.shape == v_cache.shape and hd == h * d
          and pos.shape == (s,) and pos.dtype == torch.int32
          and k_cache.dtype == v_cache.dtype
          == (torch.int8 if quant else q.dtype)
          and all(t.is_contiguous() and t.device == q.device
                  for t in (q, k_cache, v_cache, pos) + scales)
          and all(t.shape == (s,) and t.dtype == torch.float32
                  for t in scales)
          and 0 <= end < s)
    if not ok:
        raise ValueError("decode_attention: bad operands "
                         f"q{tuple(q.shape)} {q.dtype} k{tuple(k_cache.shape)}"
                         f" {k_cache.dtype} pos{tuple(pos.shape)} end={end}")
    out = torch.empty_like(q)
    rc = cuda_lib.library().ptt_decode_attn(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), pos.data_ptr(),
        k_scale.data_ptr() if quant else None,
        v_scale.data_ptr() if quant else None,
        out.data_ptr(), h, d, s, hd, int(end), cuda_lib.dtype_code(q),
        cuda_lib.stream_ptr(q.device))
    cuda_lib.check(rc, "ptt_decode_attn")
    if quant:
        decode_attention.launches_kv8 += 1
    else:
        decode_attention.launches += 1
    return out


decode_attention.launches = decode_attention.launches_kv8 = 0
