"""Scaled dot-product attention over fixed-shape KV caches, with masks made
by position arithmetic.

Counterpart of `pocket_tts_tpu/ops/attention.py` (the main-path subset,
with the shared-prefix partials `prefix_attn_stats`, `sdpa_seg_stats`,
`sdpa_decode_seg_stats` and `merge_attn_partials`, which the JAX package
computes in XLA too). Caches keep the JAX package's FLAT (S, H*D) row
layout. Logits and softmax are float32; the softmax weights are rounded to
the value dtype before the PV product, as in the JAX functions.

`cross_attn_kv` and `cross_attention` are the cross-attention of a
checkpoint that ships `cross_attention` weights (the JAX package's, plain
PyTorch there as it is XLA there).

`cache_insert_ring` + `ring_cache_bias` + `sdpa_seg` are also the plain
version of kernel K2 (ops/ring_attn.py); K1's (ops/decode_attn.py) is
`sdpa_decode_seg`'s softmax over the live slots.
"""
from __future__ import annotations

import torch

from .basic import inv_sqrt

NEG_INF = -1e9  # large negative instead of -inf, safe in f32 softmax


def sdpa(q, k, v, bias=None):
    """softmax(q k^T / sqrt(D) + bias) v.

    q: (..., T, H, D), k/v: (..., S, H, D), bias: (..., T, S) additive or
    None; the leading axes (a lane axis) are batch axes.
    """
    scale = inv_sqrt(q.shape[-1])
    logits = torch.einsum("...thd,...shd->...hts", q.float(),
                          k.float()) * scale
    if bias is not None:
        logits = logits + bias[..., None, :, :]
    w = torch.softmax(logits, -1)
    out = torch.einsum("...hts,...shd->...thd", w.to(v.dtype).float(),
                       v.float())
    return out.to(q.dtype)


def sdpa_seg(q, k, v, bias):
    """Attention of T queries over FLAT caches. q: (T, H, D); k/v:
    (S, H*D); bias: (T, S). Returns (T, H, D); the same function as sdpa
    (the JAX package's name for its flat-cache formulation)."""
    s = k.shape[0]
    h, d = q.shape[1], q.shape[2]
    return sdpa(q, k.view(s, h, d), v.view(s, h, d), bias)


def sdpa_decode_seg(q, k, v, bias):
    """T=1 decode attention over FLAT caches. q: (1, H, D); k/v: (S, H*D);
    bias: (1, S). Returns (1, H, D)."""
    return sdpa_seg(q, k, v, bias)


def sdpa_seg_stats(q, k, v, bias):
    """sdpa_seg with the flash statistics of an external merge: q
    (..., T, H, D), flat k/v (..., S, H*D), bias (..., T, S). Returns (out
    (..., T, H, D) in q's dtype, m (..., T, H) float32 running max, l
    (..., T, H) float32 normaliser). The shared-prefix prefill's own-cache
    partial."""
    *lead, t, h, d = q.shape
    s = k.shape[-2]
    logits = torch.einsum("...thd,...shd->...ths", q.float(),
                          k.view(*lead, s, h, d).float()) * inv_sqrt(d)
    logits = logits + bias[..., :, None, :]
    m = logits.amax(-1)
    w = torch.exp(logits - m[..., None])
    l = w.sum(-1)
    wn = (w / l.clamp_min(1e-30)[..., None]).to(v.dtype).float()
    out = torch.einsum("...ths,...shd->...thd", wn,
                       v.view(*lead, s, h, d).float())
    return out.to(q.dtype), m, l


def sdpa_decode_seg_stats(q, k, v, bias):
    """sdpa_seg_stats at T = 1: q (..., 1, H, D), bias (..., 1, S)."""
    return sdpa_seg_stats(q, k, v, bias)


def prefix_attn_stats(q, pk, pv, ppos):
    """Partial attention over a SHARED prompt-prefix table, with the flash
    statistics of an exact external merge (merge_attn_partials).

    q: (..., T, H, D), the leading axes (lanes) batch; pk/pv: (H, P, D)
    head-major tables shared by every lane, read once for all of them;
    ppos: (..., P) int32 per lane, -1 masks a slot (each lane unmasks only
    its own voice's segment; prompt positions precede every decode
    position, so no causal test is needed). One batched product for all
    lanes. Returns (out (..., T, H, D) float32 normalised, m (..., T, H),
    l (..., T, H))."""
    scale = inv_sqrt(q.shape[-1])
    logits = torch.einsum("...thd,hpd->...htp", q.float(),
                          pk.float()) * scale
    bias = torch.where(ppos >= 0, 0.0, NEG_INF).float()
    logits = logits + bias[..., None, None, :]
    m = logits.amax(-1)                                   # (..., H, T)
    w = torch.exp(logits - m[..., None])
    l = w.sum(-1)
    wn = (w / l.clamp_min(1e-30)[..., None]).to(pv.dtype).float()
    out = torch.einsum("...htp,hpd->...thd", wn, pv.float())
    return out, m.transpose(-1, -2), l.transpose(-1, -2)


def cross_attn_kv(in_proj, cond, num_heads: int):
    """The cross-attention KV of a conditioning sequence, computed once a
    stream: the whole in_proj runs on cond (S, d_model) and its q third is
    dropped, so every quantized layout of in_proj works unchanged (through
    K4a / K4b). Returns (k, v), each (S, H, D); no RoPE."""
    from .basic import linear
    s = cond.shape[0]
    qkv = linear(in_proj, cond)                        # (S, 3 d_model)
    dm = qkv.shape[-1] // 3
    return (qkv[:, dm:2 * dm].reshape(s, num_heads, dm // num_heads),
            qkv[:, 2 * dm:].reshape(s, num_heads, dm // num_heads))


def cross_attention(p, x, xk, xv, num_heads: int):
    """Cross-attention over a precomputed conditioning KV: q is the first
    third of in_proj applied to x (T, d_model); non-causal, unmasked
    attention against xk/xv (S, H, D) without RoPE; then out_proj.
    Returns (T, d_model)."""
    from .basic import linear
    t, dm = x.shape
    q = linear(p["in_proj"], x)[:, :dm].reshape(t, num_heads,
                                                dm // num_heads)
    return linear(p["out_proj"], sdpa(q, xk, xv).reshape(t, dm))


def merge_attn_partials(o1, m1, l1, o2, m2, l2):
    """Exact flash merge of two NORMALISED attention partials over
    disjoint key sets: o (..., H, D), m and l (..., H). A partial with
    m = -inf and l = 0 (no key attended) drops out. Returns o2's dtype."""
    m = torch.maximum(m1, m2)
    a1 = torch.exp(m1 - m) * l1
    a2 = torch.exp(m2 - m) * l2
    denom = (a1 + a2).clamp_min(1e-30)
    return (o1.float() * (a1 / denom)[..., None]
            + o2.float() * (a2 / denom)[..., None]).to(o2.dtype)


def pos_cache_bias(q_pos, slot_pos, neg: float = NEG_INF):
    """Additive bias for a slot/position-decoupled cache.

    q_pos: (..., T) absolute positions of the queries; slot_pos: (..., S)
    position stored in each slot, -1 = invalid (a leading lane axis
    allowed). Allowed(i, j) = slot_pos[j] >= 0 and slot_pos[j] <= q_pos[i].
    """
    pk = slot_pos[..., None, :]
    allowed = (pk >= 0) & (pk <= q_pos[..., :, None])
    return torch.where(allowed, 0.0, neg).float()


def ring_positions(end_offset: int, capacity: int, device="cpu"):
    """Absolute position stored in each ring slot once `end_offset`
    timesteps were written; (cap,) int32, -1 for never-written slots."""
    idx = torch.arange(capacity, dtype=torch.int32, device=device)
    last = end_offset - 1
    delta = idx - last % capacity
    pos = last + delta - torch.where(delta > 0, capacity, 0)
    return torch.where(idx < end_offset, pos, -1)


def ring_cache_bias(t: int, capacity: int, offset: int, context: int,
                    neg: float = NEG_INF, start: int = 0, device="cpu"):
    """Additive (T, cap) bias for the ring cache after inserting t rows at
    ring slots (offset + i) % cap: query pq = offset + i may see slot
    position pk iff pk >= start, pq - pk >= 0 and pq - pk < context."""
    pk = ring_positions(offset + t, capacity, device)[None, :]
    pq = (offset + torch.arange(t, dtype=torch.int32, device=device))[:, None]
    delta = pq - pk
    allowed = (pk >= start) & (delta >= 0) & (delta < context)
    return torch.where(allowed, 0.0, neg).float()


def cache_insert_ring(cache, new, offset: int):
    """Write `new` (T, H*D) into the ring cache (cap, H*D) at rows
    (offset + i) % cap, IN PLACE (the JAX function returns a new array).
    Returns the cache."""
    cap, t = cache.shape[0], new.shape[0]
    idx = (offset + torch.arange(t, device=cache.device)) % cap
    cache[idx] = new.to(cache.dtype)
    return cache
