"""K1: T=1 decode attention over the backbone's flat KV cache, solo or
over B lanes.

Replaces the TPU kernel `pocket_tts_tpu/ops/pallas_attn.py:
decode_attention` (`_decode_attention_batched`), with caches of the
working type and, with `k_scale`/`v_scale`, int8 caches with per-row
float32 scales (`_make_decode_attention_q`); with a lane axis (the JAX
package's vmap over B streams, `end` shared by the lanes) and optionally
returning the flash statistics (`stats=True`, `:326`/`:353`) that the
shared-prefix serving merges with the prompt partial
(ops/attention.merge_attn_partials). The CUDA kernel is
`csrc/decode_attn.cu` (its header says what bounds it on the H100 and what
the design does about it); the plain version is the softmax of
`ops/attention.sdpa_decode_seg` over the live slots (s <= end, pos >= 0),
and for int8 caches the TPU kernel's arithmetic (`_flash_main_block` with
`quant`): logits (q . k) * scale * k_scale[s], softmax weights times
v_scale[s] rounded to the working type before the PV product with the int8
rows. A masked slot is skipped (the TPU kernel adds a finite -1e9): a lane
with no live slot gives out 0, m = -inf and l = 0, which
merge_attn_partials turns into the prefix partial alone, as K7 does
(ops/insert_attn.py).

The kernel splits the live slots [0, end] into `k1_split(end, S)` chunks,
one thread block each, merged on chip (one thread-block cluster per head
and lane; `chunk_units` is the rule that deals the slots out). The split
depends on end and S only, so each lane of a batched call gives the solo
call's bits.

`decode_attention` runs the plain version for tensors on the CPU and the
kernel for tensors on the card; there is no other switch. Solo launches
over caches of the working type count in `decode_attention.launches`, over
int8 caches in `decode_attention.launches_kv8`; launches with a lane axis
count in `.launches_lanes` instead, and launches that return the
statistics once more in `.launches_stats`.
"""
from __future__ import annotations

import torch

from . import cuda_lib
from .attention import NEG_INF
from .basic import inv_sqrt

# the largest portable thread-block cluster: the most chunks one (head,
# lane) can be split into
MAX_SPLITS = 8
# K1 gives a chunk at least K1_MIN_CHUNK slots, dealt out in units of
# K1_UNIT, and makes at most K1_MAX_SPLITS chunks. chip_smoke.py's
# `time_splits` times every split count: on an H100 four chunks run the
# solo call (S = 384, end = 300) within 0.3 us of the fastest count, while
# each chunk past two adds ~1-4 us at 32 lanes (S = 1024).
K1_MIN_CHUNK = 64
K1_UNIT = 8
K1_MAX_SPLITS = 4


def chunk_units(c: int, n: int, total: int, unit: int):
    """The [lo, hi) ranges of chunk c of n over `total` items: the items are
    cut into units of `unit` and unit u goes to chunk u % n. This is the
    kernels' rule (csrc/decode_attn.cu with K1_UNIT slots, csrc/ring_attn.cu
    with 16-key tiles). Dealt out in turn, a run of masked slots (a lane's
    old prefix, a fenced stretch of the ring) spreads over all chunks
    instead of idling some blocks of a cluster while the others work."""
    units = -(-total // unit)
    return [(u * unit, min(total, (u + 1) * unit))
            for u in range(c, units, n)]


def k1_split(end: int, s: int) -> int:
    """The number of chunks K1 cuts the live slots [0, end] of an S-slot
    cache into: one per K1_MIN_CHUNK slots, at most K1_MAX_SPLITS. It
    depends on end and S only, never on the lane count."""
    if not 0 <= end < s:
        raise ValueError(f"k1_split: end {end} outside [0, {s})")
    return min(K1_MAX_SPLITS, -(-(end + 1) // K1_MIN_CHUNK))


def decode_attention_plain(q, k_cache, v_cache, pos, end: int,
                           k_scale=None, v_scale=None, stats: bool = False):
    """q: (H, D); k/v_cache: (S, H*D) of q's dtype, or int8 with k_scale,
    v_scale (S,) float32; pos: (S,) int32; end: last slot read. Returns
    (H, D) in q's dtype, and with stats (out, m, l), m and l (H,) float32.
    With a lane axis: q (B, H, D), caches (B, S, H*D), pos and scales
    (B, S), out (B, H, D), m and l (B, H)."""
    if q.dim() == 2:
        res = decode_attention_plain(
            q[None], k_cache[None], v_cache[None], pos[None], end,
            None if k_scale is None else k_scale[None],
            None if v_scale is None else v_scale[None], stats)
        return tuple(r[0] for r in res) if stats else res[0]
    b, h, d = q.shape
    s = k_cache.shape[1]
    logits = torch.einsum("bhd,bshd->bhs", q.float(),
                          k_cache.view(b, s, h, d).float()) * inv_sqrt(d)
    if k_scale is not None:
        logits = logits * k_scale[:, None, :]
    idx = torch.arange(s, device=pos.device)
    ok = ((pos >= 0) & (idx <= end))[:, None, :].expand(b, h, s)
    w = (torch.softmax(logits + torch.where(ok, 0.0, NEG_INF), -1)
         * ok.any(-1, keepdim=True))
    if k_scale is not None:
        w = w * v_scale[:, None, :]
    out = torch.einsum("bhs,bshd->bhd", w.to(q.dtype).float(),
                       v_cache.view(b, s, h, d).float()).to(q.dtype)
    if not stats:
        return out
    masked = logits.masked_fill(~ok, float("-inf"))
    m = masked.amax(-1)
    l = torch.exp(masked - torch.where(torch.isfinite(m), m, 0.0)[..., None]
                  ).sum(-1)
    return out, m, l


def decode_attention(q, k_cache, v_cache, pos, end: int, k_scale=None,
                     v_scale=None, stats: bool = False):
    """Same contract as decode_attention_plain, solo or with a lane axis;
    launches the CUDA kernel for CUDA tensors (q float32 or bfloat16, D =
    64; caches of q's dtype, or int8 with float32 scales), one launch for
    all lanes."""
    if q.device.type == "cpu":
        return decode_attention_plain(q, k_cache, v_cache, pos, end, k_scale,
                                      v_scale, stats)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention: unsupported device {q.device}")
    lanes = q.dim() == 3
    b = q.shape[0] if lanes else 1
    h, d = q.shape[-2:]
    s, hd = k_cache.shape[-2:]
    lead = (b,) if lanes else ()
    quant = k_scale is not None
    scales = (k_scale, v_scale) if quant else ()
    ok = (k_cache.shape == v_cache.shape == lead + (s, hd) and hd == h * d
          and pos.shape == lead + (s,) and pos.dtype == torch.int32
          and k_cache.dtype == v_cache.dtype
          == (torch.int8 if quant else q.dtype)
          and all(t.is_contiguous() and t.device == q.device
                  for t in (q, k_cache, v_cache, pos) + scales)
          and k_cache.data_ptr() % 16 == 0 and v_cache.data_ptr() % 16 == 0
          and all(t.shape == lead + (s,) and t.dtype == torch.float32
                  for t in scales)
          and 0 <= end < s)
    if not ok:
        raise ValueError("decode_attention: bad operands "
                         f"q{tuple(q.shape)} {q.dtype} k{tuple(k_cache.shape)}"
                         f" {k_cache.dtype} pos{tuple(pos.shape)} end={end}")
    out = torch.empty_like(q)
    st = (torch.empty(2, *lead, h, dtype=torch.float32, device=q.device)
          if stats else None)
    rc = cuda_lib.library().ptt_decode_attn(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), pos.data_ptr(),
        k_scale.data_ptr() if quant else None,
        v_scale.data_ptr() if quant else None,
        out.data_ptr(), None if st is None else st.data_ptr(), b, h, d, s,
        hd, int(end), k1_split(int(end), s), cuda_lib.dtype_code(q),
        cuda_lib.stream_ptr(q.device))
    cuda_lib.check(rc, "ptt_decode_attn")
    if lanes:
        decode_attention.launches_lanes += 1
    elif quant:
        decode_attention.launches_kv8 += 1
    else:
        decode_attention.launches += 1
    if stats:
        decode_attention.launches_stats += 1
        return out, st[0], st[1]
    return out


decode_attention.launches = decode_attention.launches_kv8 = 0
decode_attention.launches_lanes = decode_attention.launches_stats = 0
