"""K2: mimi ring-cache insert + T=16 attention, in place.

Replaces the TPU kernel `pocket_tts_tpu/ops/pallas_mimi.py:
ring_insert_attention`, over rings of the working type and (K2-q, with
`k_scale`) int8 rings with per-row float32 scales
(`mimi.transformer.quantize_kv`). The CUDA kernel is `csrc/ring_attn.cu`
(its header says what bounds it on the H100 and what the design does about
it); the plain version is the `ops/attention.py` composition the JAX
package runs off the TPU: `cache_insert_ring` + `ring_cache_bias` +
`sdpa_seg`. For int8 rings it follows the TPU kernel's arithmetic
(`pallas_mimi.py:154-198`): the quantized new rows (`ks_new`, `vs_new`
their (…, T) scales) and their scales go into the ring first, then each
key's logit is (q . k_int8) * scale * k_scale[s] and its softmax weight
times v_scale[s] is rounded to the working type before the PV product with
the int8 rows. (The JAX package takes its plain XLA route below a
32-multiple capacity, `models/mimi_transformer.py:209-213`: dequantized
rows rounded to the working type; the two agree to f32 rounding.)

The kernel cuts the cap + T keys of each head into 16-key tiles and deals
them out to `k2_split(cap, T)` chunks, one thread block each, merged on
chip (ops/decode_attn.py `chunk_units` is the rule). The split depends on
cap and T only, so each lane of a batched call gives the solo call's bits.

`ring_insert_attention` runs the plain version for tensors on the CPU and
the kernel for tensors on the card; there is no other switch. Both update
the caches IN PLACE (the JAX function returns new caches), and for int8
rings the (cap,) scale rows too. Both take an optional lane axis: B streams
that share the ring offset, each with its own start (continuous batching),
in one launch. Launches over rings of the working type count in
`ring_insert_attention.launches`, over int8 rings in `.launches_kv8`.
"""
from __future__ import annotations

import torch

from . import cuda_lib
from .attention import NEG_INF, cache_insert_ring, ring_cache_bias, sdpa_seg
from .basic import inv_sqrt
from .decode_attn import MAX_SPLITS

# K2 cuts the keys into tiles of this many (the M and K of the tensor
# cores' m16n8k16 products), and makes one chunk per K2_CHUNK_SLOTS ring
# slots. chip_smoke.py's `time_splits` times every split count: on an H100
# at the default ring (256 slots) one or two chunks run 32 lanes fastest
# and more add ~3-19 us there, while the solo call gains ~1-3 us a chunk
# up to five; two keep both calls under the library's time.
K2_TILE = 16
K2_CHUNK_SLOTS = 128


def k2_split(cap: int, t: int) -> int:
    """The number of chunks K2 cuts the cap + T keys of each (head, lane)
    into: one per K2_CHUNK_SLOTS slots of the ring, at most MAX_SPLITS. It
    depends on cap and T only, never on the lane count."""
    if not (1 <= t <= K2_TILE and cap % t == 0):
        raise ValueError(f"k2_split: cap {cap}, T {t}")
    return min(MAX_SPLITS, -(-cap // K2_CHUNK_SLOTS))


def ring_insert_attention_plain(q, k_new, v_new, k_cache, v_cache,
                                offset: int, start, num_heads: int,
                                context: int, k_scale=None, v_scale=None,
                                ks_new=None, vs_new=None,
                                neg: float = NEG_INF):
    """q/k_new/v_new: (T, H*D) post-rope rows; k/v_cache: (cap, H*D),
    PRE-insert, written in place at slots (offset + i) % cap (any cap and
    offset: the insert may wrap inside the T rows); offset: timesteps
    written so far; start: the stream's first timestep. Returns attn
    (T, H*D). int8 rings: k_new, v_new and the caches int8, ks_new/vs_new
    (T,) and k_scale/v_scale (cap,) float32, the latter written in place.
    neg: the mask value (the reference-exact mode's -1e5; the kernel
    masks with -1e9).

    With a lane axis: q/k_new/v_new (B, T, H*D), caches (B, cap, H*D), the
    offset shared by the lanes and start a (B,) int32 tensor (each lane's
    first timestep); scales (B, T) and (B, cap); returns (B, T, H*D)."""
    if k_scale is not None:
        if q.dim() == 3:
            return _ring_plain_q(q, k_new, v_new, k_cache, v_cache, offset,
                                 start[:, None, None], num_heads, context,
                                 k_scale, v_scale, ks_new, vs_new, neg)
        return _ring_plain_q(q[None], k_new[None], v_new[None],
                             k_cache[None], v_cache[None], offset, start,
                             num_heads, context, k_scale[None],
                             v_scale[None], ks_new[None], vs_new[None],
                             neg)[0]
    if q.dim() == 3:
        return _ring_plain_lanes(q, k_new, v_new, k_cache, v_cache, offset,
                                 start, num_heads, context, neg)
    t, hd = q.shape
    cap = k_cache.shape[0]
    cache_insert_ring(k_cache, k_new, offset)
    cache_insert_ring(v_cache, v_new, offset)
    bias = ring_cache_bias(t, cap, offset, context, neg=neg, start=start,
                           device=q.device)
    out = sdpa_seg(q.view(t, num_heads, hd // num_heads), k_cache, v_cache,
                   bias)
    return out.reshape(t, hd)


def _ring_plain_lanes(q, k_new, v_new, k_cache, v_cache, offset: int,
                      starts, num_heads: int, context: int,
                      neg: float = NEG_INF):
    """The plain version over B lanes: the same rows of every lane's ring
    are written, and lane b's bias fences positions below starts[b]."""
    b, t, hd = q.shape
    cap = k_cache.shape[1]
    d = hd // num_heads
    idx = (offset + torch.arange(t, device=q.device)) % cap
    k_cache[:, idx] = k_new.to(k_cache.dtype)
    v_cache[:, idx] = v_new.to(v_cache.dtype)
    bias = ring_cache_bias(t, cap, offset, context, neg=neg,
                           start=starts[:, None, None],
                           device=q.device)                  # (B, T, cap)
    logits = torch.einsum("bthd,bshd->bhts",
                          q.view(b, t, num_heads, d).float(),
                          k_cache.view(b, cap, num_heads, d).float())
    w = torch.softmax(logits * inv_sqrt(d) + bias[:, None], -1)
    out = torch.einsum("bhts,bshd->bthd", w.to(v_cache.dtype).float(),
                       v_cache.view(b, cap, num_heads, d).float())
    return out.to(q.dtype).reshape(b, t, hd)


def _ring_plain_q(q, k_new, v_new, k_cache, v_cache, offset: int, start,
                  num_heads: int, context: int, k_scale, v_scale, ks_new,
                  vs_new, neg: float = NEG_INF):
    """The plain version over int8 rings, with a lane axis: bytes and
    scales inserted at the ring slots, then the TPU kernel's arithmetic.
    start: an int or a (B, 1, 1) tensor."""
    b, t, hd = q.shape
    cap = k_cache.shape[1]
    d = hd // num_heads
    idx = (offset + torch.arange(t, device=q.device)) % cap
    k_cache[:, idx] = k_new
    v_cache[:, idx] = v_new
    k_scale[:, idx] = ks_new
    v_scale[:, idx] = vs_new
    bias = ring_cache_bias(t, cap, offset, context, neg=neg, start=start,
                           device=q.device)                  # (B, T, cap)
    logits = torch.einsum("bthd,bshd->bhts",
                          q.view(b, t, num_heads, d).float(),
                          k_cache.view(b, cap, num_heads, d).float())
    logits = logits * inv_sqrt(d) * k_scale[:, None, None, :]
    w = torch.softmax(logits + bias.expand(b, t, cap)[:, None], -1)
    pv = (w * v_scale[:, None, None, :]).to(q.dtype).float()
    out = torch.einsum("bhts,bshd->bthd", pv,
                       v_cache.view(b, cap, num_heads, d).float())
    return out.to(q.dtype).reshape(b, t, hd)


def ring_insert_attention(q, k_new, v_new, k_cache, v_cache, offset: int,
                          start, num_heads: int, context: int, k_scale=None,
                          v_scale=None, ks_new=None, vs_new=None):
    """Same contract as ring_insert_attention_plain, solo or with a lane
    axis; launches the CUDA kernel for CUDA tensors (float32 or bfloat16,
    D = 64, T <= 16, cap and offset multiples of T; int8 rings with
    float32 scales), one launch for all lanes."""
    if q.device.type == "cpu":
        return ring_insert_attention_plain(q, k_new, v_new, k_cache, v_cache,
                                           offset, start, num_heads, context,
                                           k_scale, v_scale, ks_new, vs_new)
    if q.device.type != "cuda":
        raise ValueError(f"ring_insert_attention: unsupported device "
                         f"{q.device}")
    lanes = q.dim() == 3
    b = q.shape[0] if lanes else 1
    t, hd = q.shape[-2:]
    cap = k_cache.shape[-2]
    d = hd // num_heads
    quant = k_scale is not None
    lead = (b,) if lanes else ()
    ops = (k_new, v_new, k_cache, v_cache)
    scales = ((ks_new, lead + (t,)), (vs_new, lead + (t,)),
              (k_scale, lead + (cap,)), (v_scale, lead + (cap,)))
    if lanes:
        start_ok = (isinstance(start, torch.Tensor) and start.shape == (b,)
                    and start.dtype == torch.int32
                    and start.device == q.device and start.is_contiguous())
    else:
        start_ok = 0 <= start <= offset
    kv_dtype = torch.int8 if quant else q.dtype
    if not (k_new.shape == v_new.shape == q.shape
            and k_cache.shape == v_cache.shape == lead + (cap, hd)
            and all(x.dtype == kv_dtype and x.is_contiguous()
                    and x.device == q.device and x.data_ptr() % 16 == 0
                    for x in ops)
            and q.is_contiguous()
            and all(x is not None and x.shape == shape
                    and x.dtype == torch.float32 and x.is_contiguous()
                    and x.device == q.device for x, shape in scales
                    if quant)
            and (quant or all(x is None for x, _ in scales))
            and cap % t == 0 and offset % t == 0 and start_ok):
        raise ValueError("ring_insert_attention: bad operands "
                         f"q{tuple(q.shape)} {q.dtype} cache"
                         f"{tuple(k_cache.shape)} {k_cache.dtype} "
                         f"offset={offset} start={start}")

    def ptr(x):
        return None if x is None else x.data_ptr()

    out = torch.empty_like(q)
    rc = cuda_lib.library().ptt_ring_attn(
        q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(), k_cache.data_ptr(),
        v_cache.data_ptr(), out.data_ptr(), start.data_ptr() if lanes else 0,
        ptr(ks_new), ptr(vs_new), ptr(k_scale), ptr(v_scale), b, t,
        num_heads, d, cap, int(offset), 0 if lanes else int(start),
        int(context), k2_split(cap, t), cuda_lib.dtype_code(q),
        cuda_lib.stream_ptr(q.device))
    cuda_lib.check(rc, "ptt_ring_attn")
    if quant:
        ring_insert_attention.launches_kv8 += 1
    else:
        ring_insert_attention.launches += 1
    return out


ring_insert_attention.launches = ring_insert_attention.launches_kv8 = 0
