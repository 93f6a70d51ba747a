"""FlowLM streaming transformer backbone (6 layers, d=1024, 16 heads).

Counterpart of `pocket_tts_tpu/models/backbone.py` for solo decode. The KV
cache keeps the JAX package's layout: per-layer FLAT (S, H*D) rows written
at the slot cursor `end`, with `pos` recording the absolute position each
slot holds (-1 = padding or unwritten). RoPE and causality use positions.

Unlike the JAX package, which threads the state functionally, `forward`
writes the new KV rows and positions INTO the state's tensors in place and
returns the same state; `advance` moves the host-side cursors. Copy a state
(`shrink_state` does) before running a forward that must not change it.

Prefill (T > 1) attends with plain PyTorch, as the JAX package runs it on
XLA. Decode (T = 1) inserts the row at `end` first and then attends with
`end` as the last written slot, through kernel K1
(ops/decode_attn.decode_attention). With int8 weights (io/quant.py) the
decode step's norm1 + in_proj run as kernel K5a and its out_proj + MLP
as kernel K5b (ops/fused_layer.py), as the JAX package does at T = 1;
prefill keeps the unfused route, its linears through kernel K4a.
"""
from __future__ import annotations

import dataclasses

import torch

from ..ops import fused_layer
from ..ops.attention import pos_cache_bias, sdpa
from ..ops.basic import gelu, layer_norm, linear, slice_layer_params
from ..ops.decode_attn import decode_attention
from ..ops.rope import apply_rope_halves as apply_rope, rope_cos_sin


@dataclasses.dataclass
class BackboneState:
    k: list          # L x (S, H*D)
    v: list          # L x (S, H*D)
    pos: torch.Tensor  # (S,) int32 absolute position per slot, -1 invalid
    end: int         # next write slot
    next_pos: int    # next absolute position


def init_state(cfg, dtype=torch.float32, device="cpu") -> BackboneState:
    shape = (cfg.kv_capacity, cfg.num_heads * cfg.head_dim)
    return BackboneState(
        k=[torch.zeros(shape, dtype=dtype, device=device)
           for _ in range(cfg.num_layers)],
        v=[torch.zeros(shape, dtype=dtype, device=device)
           for _ in range(cfg.num_layers)],
        pos=torch.full((cfg.kv_capacity,), -1, dtype=torch.int32,
                       device=device),
        end=0, next_pos=0)


def _layer(p, x, k_cache, v_cache, end: int, cos, sin, bias, pos_vec,
           num_heads: int, gelu_approx: bool):
    """One pre-LN layer; writes its KV rows at slot `end` in place."""
    t, dm = x.shape
    d = dm // num_heads
    fused = t == 1 and fused_layer.supported(p)
    if fused:
        qkv = fused_layer.pre_attention(p, x, eps=1e-5)
    else:
        qkv = linear(p["in_proj"], layer_norm(p["norm1"], x, eps=1e-5))
    q, k, v = qkv.split(dm, -1)
    q = apply_rope(q.reshape(t, num_heads, d), cos, sin)
    k = apply_rope(k.reshape(t, num_heads, d), cos, sin)
    k_cache[end:end + t] = k.reshape(t, dm)
    v_cache[end:end + t] = v
    if t == 1:
        attn = decode_attention(q[0], k_cache, v_cache, pos_vec, end)
    else:
        s = k_cache.shape[0]
        attn = sdpa(q, k_cache.view(s, num_heads, d),
                    v_cache.view(s, num_heads, d), bias)
    if fused:
        return fused_layer.post_attention(p, x, attn.reshape(t, dm),
                                          eps=1e-5, approx=gelu_approx)
    x = x + linear(p["out_proj"], attn.reshape(t, dm))
    h = layer_norm(p["norm2"], x, eps=1e-5)
    return x + linear(p["linear2"],
                      gelu(linear(p["linear1"], h), gelu_approx))


def forward(p, cfg, state: BackboneState, x, n_valid: int = None,
            gelu_approx: bool = False):
    """Run T new rows through all layers, writing KV at slot state.end.

    x: (T, d_model); rows >= n_valid are padding (position -1, masked by
    every later step). Returns (state, y (T, d_model)); the caller moves the
    cursors with `advance`.
    """
    t = x.shape[0]
    n_valid = t if n_valid is None else n_valid
    end = state.end
    if end + t > state.pos.shape[0]:
        raise ValueError(f"KV overflow: {end} + {t} > {state.pos.shape[0]}")
    positions = state.next_pos + torch.arange(t, dtype=torch.int32,
                                              device=x.device)
    state.pos[end:end + t] = torch.where(
        torch.arange(t, device=x.device) < n_valid, positions, -1)
    cos, sin = rope_cos_sin(positions, cfg.head_dim, cfg.max_period)
    bias = (None if t == 1
            else pos_cache_bias(positions, state.pos, neg=cfg.mask_value))
    for l in range(cfg.num_layers):
        x = _layer(slice_layer_params(p["layers"], l), x, state.k[l],
                   state.v[l], end, cos, sin, bias, state.pos, cfg.num_heads,
                   gelu_approx)
    return state, x


def shrink_state(state: BackboneState, capacity: int) -> BackboneState:
    """A COPY of the first `capacity` slots (cursors unchanged): bounds the
    attention reads of a sentence to the slots it can use, and leaves the
    source (a reusable voice prefix) untouched by the in-place decode."""
    return BackboneState(
        k=[k[:capacity].clone() for k in state.k],
        v=[v[:capacity].clone() for v in state.v],
        pos=state.pos[:capacity].clone(),
        end=state.end, next_pos=state.next_pos)


def advance(state: BackboneState, t: int, n_valid: int) -> BackboneState:
    """Consume t slots and n_valid positions."""
    state.end += t
    state.next_pos += n_valid
    return state
