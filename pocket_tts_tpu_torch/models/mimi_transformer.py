"""Mimi decoder transformer: 2 layers, d=512, 8 heads, a ring-buffer KV cache
(256 slots, attention window 250), eps=0 LayerNorm, LayerScale on both
branches.

Counterpart of `pocket_tts_tpu/models/mimi_transformer.py`. The ring rows
are FLAT (cap, H*D) like the JAX package's; `offset` counts the timesteps
written and `start` is the stream's first timestep (0 solo). Each layer's
ring step, insert + attention, goes through kernel K2
(ops/ring_attn.ring_insert_attention), which writes the caches IN PLACE;
`forward` advances `offset` on the same state object. With int8 weights
(io/quant.py) each layer's norm1 + in_proj run as kernel K5a and its
out_proj + MLP (with both layer scales) as kernel K5b
(ops/fused_layer.py), as the JAX package does.
"""
from __future__ import annotations

import dataclasses

import torch

from ..ops import fused_layer
from ..ops.basic import gelu, layer_norm, linear, slice_layer_params
from ..ops.ring_attn import ring_insert_attention
from ..ops.rope import apply_rope_halves as apply_rope, rope_cos_sin


@dataclasses.dataclass
class MimiTransformerState:
    k: list          # L x (cap, H*D)
    v: list          # L x (cap, H*D)
    offset: int = 0  # timesteps seen
    start: int = 0   # first timestep owned by this stream


def init_state(cfg, dtype=torch.float32, device="cpu"):
    shape = (cfg.capacity, cfg.num_heads * cfg.head_dim)
    return MimiTransformerState(
        k=[torch.zeros(shape, dtype=dtype, device=device)
           for _ in range(cfg.num_layers)],
        v=[torch.zeros(shape, dtype=dtype, device=device)
           for _ in range(cfg.num_layers)])


def _layer(p, x, k_cache, v_cache, offset: int, start: int, cos, sin, cfg,
           gelu_approx: bool):
    t, dm = x.shape
    fused = fused_layer.supported(p)
    if fused:
        qkv = fused_layer.pre_attention(p, x, eps=cfg.norm_eps)
    else:
        qkv = linear(p["in_proj"], layer_norm(p["norm1"], x,
                                              eps=cfg.norm_eps))
    q, k, v = qkv.split(dm, -1)
    q = apply_rope(q.reshape(t, cfg.num_heads, cfg.head_dim), cos, sin)
    k = apply_rope(k.reshape(t, cfg.num_heads, cfg.head_dim), cos, sin)
    attn = ring_insert_attention(
        q.reshape(t, dm), k.reshape(t, dm), v.contiguous(), k_cache, v_cache,
        offset, start, cfg.num_heads, cfg.context)
    if fused:
        return fused_layer.post_attention(p, x, attn, eps=cfg.norm_eps,
                                          approx=gelu_approx)
    x = x + p["layer_scale_1"]["scale"] * linear(p["out_proj"], attn)
    h = layer_norm(p["norm2"], x, eps=cfg.norm_eps)
    up = linear(p["linear2"], gelu(linear(p["linear1"], h), gelu_approx))
    return x + p["layer_scale_2"]["scale"] * up


def forward(p, cfg, state: MimiTransformerState, x,
            gelu_approx: bool = False):
    """x: (T, d_model) -> (state, y); advances state.offset by T."""
    t = x.shape[0]
    positions = (state.offset - state.start
                 + torch.arange(t, dtype=torch.int32, device=x.device))
    cos, sin = rope_cos_sin(positions, cfg.head_dim, cfg.max_period)
    for l in range(cfg.num_layers):
        x = _layer(slice_layer_params(p["layers"], l), x, state.k[l],
                   state.v[l], state.offset, state.start, cos, sin, cfg,
                   gelu_approx)
    state.offset += t
    return state, x
