"""Scaled dot-product attention over fixed-shape KV caches, with masks made
by position arithmetic.

Counterpart of `pocket_tts_tpu/ops/attention.py` (the solo main-path
subset). Caches keep the JAX package's FLAT (S, H*D) row layout. Logits and
softmax are float32; the softmax weights are rounded to the value dtype
before the PV product, as in the JAX functions.

These are also the plain versions of two kernels: `sdpa_decode_seg` with a
slot bias is K1's (ops/decode_attn.py), and `cache_insert_ring` +
`ring_cache_bias` + `sdpa_seg` is K2's (ops/ring_attn.py).
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
