"""FlowLM streaming transformer backbone (6 layers, d=1024, 16 heads).

Counterpart of `pocket_tts_tpu/models/backbone.py`, solo (`BackboneState`,
`forward`) and over B lanes (`BatchedBackboneState`, `forward_lanes`). The
KV cache keeps the JAX package's layout: per-layer FLAT (S, H*D) rows
written at the slot cursor `end`, with `pos` recording the absolute position each
slot holds (-1 = padding or unwritten). RoPE and causality use positions.

Unlike the JAX package, which threads the state functionally, `forward`
writes the new KV rows and positions INTO the state's tensors in place and
returns the same state; `advance` moves the host-side cursors. Copy a state
(`shrink_state` does) before running a forward that must not change it.

Prefill (T > 1) attends with plain PyTorch, as the JAX package runs it on
XLA. Decode (T = 1) inserts the row at `end` first and then attends with
`end` as the last written slot, through kernel K1
(ops/decode_attn.decode_attention). With int8 or int4 weights
(io/quant.py; int4 with per-channel or q4_0 K-grouped scales) the decode
step's norm1 + in_proj run as kernel K5a and its out_proj + MLP as kernel
K5b (ops/fused_layer.py), as the JAX package does at T = 1; prefill keeps
the unfused route, its linears through kernel K4a (int8) or K4b (int4).
With `cfg.fuse_insert` set, a decode step instead hands the new row to
kernel K7 (ops/insert_attn.decode_insert_attention), which writes it and
attends in one launch per layer, as the JAX package's `fuse_insert` does.

Lanes (continuous batching): the caches are (B, S, H*D) and `pos` (B, S);
the write slot `end` (and, in prefix+ring mode, `ring_start`) is a host
int shared by the lanes, while each lane's `next_pos` is a (B,) device
tensor, so lanes hold streams at different points of their sentences. A
decode step (T = 1) runs K7 over all lanes in one launch per layer; a
prefill (T > 1) attends with plain PyTorch under a (B, T, S) position
bias, as the JAX package runs it on XLA. Quantized weights at batch are
not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..ops import fused_layer
from ..ops.attention import pos_cache_bias, sdpa
from ..ops.basic import gelu, layer_norm, linear, slice_layer_params
from ..ops.decode_attn import decode_attention
from ..ops.insert_attn import decode_insert_attention
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
           num_heads: int, gelu_approx: bool, cur_pos=None):
    """One pre-LN layer; writes its KV rows at slot `end` in place.
    cur_pos: the (1,) int32 position of a decode step's row when it goes
    through K7 (cfg.fuse_insert), else None."""
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
    if cur_pos is not None:
        attn = decode_insert_attention(
            q, k.reshape(1, 1, dm), v.reshape(1, 1, dm), cur_pos,
            k_cache[None], v_cache[None], pos_vec[None], end, end)[0]
    else:
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
    cur_pos = (state.pos[end:end + 1] if t == 1 and cfg.fuse_insert
               else None)
    for l in range(cfg.num_layers):
        x = _layer(slice_layer_params(p["layers"], l), x, state.k[l],
                   state.v[l], end, cos, sin, bias, state.pos, cfg.num_heads,
                   gelu_approx, cur_pos)
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


# ---------------------------------------------------------------------------
# lanes (continuous batching)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class BatchedBackboneState:
    k: list                 # L x (B, S, H*D)
    v: list                 # L x (B, S, H*D)
    pos: torch.Tensor       # (B, S) int32 absolute position per slot
    next_pos: torch.Tensor  # (B,) int32 next absolute position per lane
    end: int                # next write slot, shared by the lanes
    # prefix+ring mode: the first ring slot; the cursor then wraps inside
    # [ring_start, S) and decode attends over every slot (None: linear)
    ring_start: Optional[int] = None

    @property
    def lanes(self) -> int:
        return self.pos.shape[0]


def _layer_lanes(p, x, k_cache, v_cache, end: int, cos, sin, bias, pos,
                 cur_pos, read_end: int, num_heads: int, gelu_approx: bool):
    """One pre-LN layer over B lanes, x (B, T, d_model); writes the KV rows
    at slot `end` of every lane in place (through K7 when T == 1)."""
    b, t, dm = x.shape
    d = dm // num_heads
    if fused_layer.supported(p):
        raise NotImplementedError(
            "quantized weights at batch are not ported yet (slice 5)")
    qkv = linear(p["in_proj"], layer_norm(p["norm1"], x, eps=1e-5))
    q, k, v = qkv.split(dm, -1)
    q = apply_rope(q.reshape(b, t, num_heads, d), cos, sin)
    k = apply_rope(k.reshape(b, t, num_heads, d), cos, sin)
    if t == 1:
        attn = decode_insert_attention(
            q[:, 0].contiguous(), k.reshape(b, 1, dm), v.contiguous(),
            cur_pos, k_cache, v_cache, pos, read_end, end)
    else:
        k_cache[:, end:end + t] = k.reshape(b, t, dm)
        v_cache[:, end:end + t] = v
        s = k_cache.shape[1]
        attn = sdpa(q, k_cache.view(b, s, num_heads, d),
                    v_cache.view(b, s, num_heads, d), bias)
    x = x + linear(p["out_proj"], attn.reshape(b, t, dm))
    h = layer_norm(p["norm2"], x, eps=1e-5)
    return x + linear(p["linear2"],
                      gelu(linear(p["linear1"], h), gelu_approx))


def forward_lanes(p, cfg, state: BatchedBackboneState, x, n_valid=None,
                  gelu_approx: bool = False):
    """Run T new rows of each lane through all layers, writing KV at slot
    state.end of every lane. x: (B, T, d_model); n_valid: (B,) int tensor
    of real rows per lane (the rest get position -1), or None for all.
    Returns (state, y (B, T, d_model)); the caller moves the cursors with
    `advance_lanes`. A decode step (T = 1) needs cfg.fuse_insert (K7): the
    vmapped K1 the JAX package runs without it is not ported."""
    b, t, _ = x.shape
    s = state.pos.shape[1]
    end = state.end
    if end + t > s:
        if t > 1:
            raise ValueError(f"KV overflow: {end} + {t} > {s}")
        # a linear cursor at capacity: every lane stopped at the frame that
        # reached it (tts.frame_step_lanes), and the unconditional steps
        # after it write the last slot, as the JAX package's
        # dynamic_update_slice clamps its index
        end = s - t
    if t == 1 and not cfg.fuse_insert:
        raise NotImplementedError(
            "batched decode without fuse_insert is not ported")
    ar = torch.arange(t, dtype=torch.int32, device=x.device)
    positions = state.next_pos[:, None] + ar                  # (B, T)
    rows = (positions if n_valid is None
            else torch.where(ar < n_valid[:, None], positions, -1))
    state.pos[:, end:end + t] = rows
    cos, sin = rope_cos_sin(positions, cfg.head_dim, cfg.max_period)
    bias = (None if t == 1
            else pos_cache_bias(positions, state.pos, neg=cfg.mask_value))
    # prefix+ring mode: after warm-up every slot is live, so K7 reads them
    # all; stale and unwritten slots are masked by their positions
    read_end = s - 1 if state.ring_start is not None else end
    cur_pos = rows[:, 0].contiguous()
    for l in range(cfg.num_layers):
        x = _layer_lanes(slice_layer_params(p["layers"], l), x, state.k[l],
                         state.v[l], end, cos, sin, bias, state.pos, cur_pos,
                         read_end, cfg.num_heads, gelu_approx)
    return state, x


def advance_lanes(state: BatchedBackboneState, t: int,
                  n_valid) -> BatchedBackboneState:
    """Consume t slots (shared) and n_valid positions ((B,) tensor or an
    int). In prefix+ring mode the cursor wraps inside [ring_start, S):
    positions keep counting, only the storage slot recycles."""
    end = state.end + t
    if state.ring_start is not None:
        ring = state.pos.shape[1] - state.ring_start
        end = state.ring_start + (end - state.ring_start) % ring
    state.end = end
    state.next_pos += n_valid
    return state
