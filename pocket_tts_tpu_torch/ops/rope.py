"""Interleaved rotary position embedding (moshi flavour), for projections
whose q/k columns were rope-permuted at load.

Counterpart of `pocket_tts_tpu/ops/rope.py`: the loader orders each head's
in_proj columns even indices first, then odd (`io/params._rope_permute`),
so the reference's interleaved (re, im) pairs arrive as contiguous halves
and the output is the reference's concat([re', im']) layout.
"""
from __future__ import annotations

import torch

from .basic import log32


def rope_cos_sin(positions, head_dim: int, max_period: float):
    """cos/sin tables, each (..., T, head_dim // 2) float32, for the
    absolute positions (..., T) (a leading lane axis allowed).
    freqs[j] = exp(-log(max_period) * j / (D/2))."""
    half = head_dim // 2
    coef = torch.tensor(-log32(max_period), dtype=torch.float32) / half
    freqs = torch.exp(torch.arange(half, dtype=torch.float32,
                                   device=positions.device) * coef)
    rads = positions.float()[..., None] * freqs
    return torch.cos(rads), torch.sin(rads)


def apply_rope_halves(x, cos, sin):
    """x: (..., T, H, D) pre-permuted q or k; cos/sin: (..., T, D/2).
    Computes in f32 and rounds once to x's dtype."""
    x32 = x.float()
    half = x32.shape[-1] // 2
    re, im = x32[..., :half], x32[..., half:]
    c = cos[..., None, :]
    s = sin[..., None, :]
    return torch.cat([re * c - im * s, re * s + im * c], -1).to(x.dtype)
