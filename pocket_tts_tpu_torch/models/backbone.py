"""FlowLM streaming transformer backbone (6 layers, d=1024, 16 heads).

Counterpart of `pocket_tts_tpu/models/backbone.py`, solo (`BackboneState`,
`forward`) and over B lanes (`BatchedBackboneState`, `forward_lanes`). The
KV cache keeps the JAX package's layout: per-layer FLAT (S, H*D) rows
written at the slot cursor `end`, with `pos` recording the absolute position each
slot holds (-1 = padding or unwritten). RoPE and causality use positions.
With `cfg.quantize_kv` the rows are int8 with one float32 absmax scale per
row (`k_scale`, `v_scale`; `quantize_rows`, bit for bit the JAX package's),
the engine's serving-throughput mode.

Unlike the JAX package, which threads the state functionally, `forward`
writes the new KV rows and positions INTO the state's tensors in place and
returns the same state; `advance` moves the host-side cursors. Copy a state
(`shrink_state` does) before running a forward that must not change it.

Prefill (T > 1) attends with plain PyTorch, as the JAX package runs it on
XLA (int8 rows dequantized first). Decode (T = 1) inserts the row at `end`
first and then attends with `end` as the last written slot, through kernel
K1 (ops/decode_attn.decode_attention; int8 caches through its int8-KV
variant). With int8 or int4 weights
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
decode step (T = 1) runs K7 over all lanes in one launch per layer (int8
caches: its int8-KV variant, the new rows quantized here), and with
quantized weights K5a and K5b over the B rows; a prefill (T > 1) attends
with plain PyTorch under a (B, T, S) position bias, as the JAX package
runs it on XLA.

Shared prefix (`split_prefix`; runtime/server.py share_prefix=True): each
voice's prompt KV moves out of the lane caches into per-layer head-major
(H, P, D) tables `pk`/`pv` of the working type, shared by every lane and
holding every registered voice's prompt side by side; `ppos` (B, P)
unmasks each lane's own voice segment. Each layer attends the tables
(ops/attention.prefix_attn_stats, one batched product for all lanes) and
its own cache (K7 with statistics at T = 1, `sdpa_seg_stats` in prefill),
and merges the two partials exactly (`merge_attn_partials`).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..ops import fused_layer
from ..ops.attention import (merge_attn_partials, pos_cache_bias,
                             prefix_attn_stats, sdpa, sdpa_seg_stats)
from ..ops.basic import gelu, layer_norm, linear, slice_layer_params
from ..ops.decode_attn import decode_attention
from ..ops.insert_attn import decode_insert_attention
from ..ops.rope import apply_rope_halves as apply_rope, rope_cos_sin


@dataclasses.dataclass
class BackboneState:
    k: list          # L x (S, H*D), int8 with cfg.quantize_kv
    v: list          # L x (S, H*D)
    pos: torch.Tensor  # (S,) int32 absolute position per slot, -1 invalid
    end: int         # next write slot
    next_pos: int    # next absolute position
    # int8 KV: L x (S,) float32 per-row scales (None otherwise)
    k_scale: Optional[list] = None
    v_scale: Optional[list] = None
    # shared-prefix tables (split_prefix; stacked into lanes by the
    # servers): L x (H, P, D) head-major, and this stream's (P,) positions
    pk: Optional[list] = None
    pv: Optional[list] = None
    ppos: Optional[torch.Tensor] = None


def init_state(cfg, dtype=torch.float32, device="cpu") -> BackboneState:
    shape = (cfg.kv_capacity, cfg.num_heads * cfg.head_dim)
    cache = torch.int8 if cfg.quantize_kv else dtype

    def scales():
        return ([torch.zeros(cfg.kv_capacity, device=device)
                 for _ in range(cfg.num_layers)] if cfg.quantize_kv
                else None)

    return BackboneState(
        k=[torch.zeros(shape, dtype=cache, device=device)
           for _ in range(cfg.num_layers)],
        v=[torch.zeros(shape, dtype=cache, device=device)
           for _ in range(cfg.num_layers)],
        pos=torch.full((cfg.kv_capacity,), -1, dtype=torch.int32,
                       device=device),
        end=0, next_pos=0, k_scale=scales(), v_scale=scales())


def quantize_rows(x):
    """(..., H*D) -> (int8 rows, (...,) float32 absmax scales): the JAX
    package's `quantize_rows`, bit for bit."""
    x32 = x.float()
    s = (x32.abs().amax(-1) / 127.0).clamp_min(1e-12)
    q = torch.clamp(torch.round(x32 / s[..., None]), -127, 127)
    return q.to(torch.int8), s


def _write_rows(k_cache, v_cache, k_scale, v_scale, end: int, k_rows,
                v_rows):
    """Write (..., T, H*D) rows at slots [end, end + T) of (..., S, H*D)
    caches in place; int8 caches get the quantized rows and their
    scales."""
    t = k_rows.shape[-2]
    if k_scale is None:
        k_cache.narrow(-2, end, t).copy_(k_rows)
        v_cache.narrow(-2, end, t).copy_(v_rows)
        return
    for cache, scale, rows in ((k_cache, k_scale, k_rows),
                               (v_cache, v_scale, v_rows)):
        q, s = quantize_rows(rows)
        cache.narrow(-2, end, t).copy_(q)
        scale.narrow(-1, end, t).copy_(s)


def _deq(cache, scale, dtype):
    """A cache as rows of `dtype`: int8 rows times their scales, rounded
    (the JAX package's XLA route), or the cache itself."""
    if scale is None:
        return cache
    return (cache.float() * scale[..., None]).to(dtype)


def _k7_rows(kn, vn, k_scale, v_scale):
    """K7's new (B, 1, H*D) rows and keyword arguments: for int8 caches
    the rows quantized here (as the JAX package's caller does), with their
    scales and the (B, S) scale rows."""
    if k_scale is None:
        return kn, vn, {}
    (kq, ks), (vq, vs) = quantize_rows(kn), quantize_rows(vn)
    return kq, vq, dict(k_scale=k_scale, v_scale=v_scale, ks_new=ks[:, 0],
                        vs_new=vs[:, 0])


def _post(p, x, attn, fused: bool, gelu_approx: bool):
    """out_proj + residual + norm2 + MLP + residual: K5b when fused."""
    if fused:
        return fused_layer.post_attention(p, x, attn, eps=1e-5,
                                          approx=gelu_approx)
    x = x + linear(p["out_proj"], attn)
    h = layer_norm(p["norm2"], x, eps=1e-5)
    return x + linear(p["linear2"],
                      gelu(linear(p["linear1"], h), gelu_approx))


def _layer(p, x, k_cache, v_cache, k_scale, v_scale, end: int, cos, sin,
           bias, pos_vec, num_heads: int, gelu_approx: bool, cur_pos=None):
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
    k = apply_rope(k.reshape(t, num_heads, d), cos, sin).reshape(t, dm)
    if cur_pos is not None:
        kn, vn, extra = _k7_rows(
            k.reshape(1, 1, dm), v.reshape(1, 1, dm),
            None if k_scale is None else k_scale[None],
            None if v_scale is None else v_scale[None])
        attn = decode_insert_attention(
            q, kn, vn, cur_pos, k_cache[None], v_cache[None], pos_vec[None],
            end, end, **extra)[0]
    else:
        _write_rows(k_cache, v_cache, k_scale, v_scale, end, k, v)
        if t == 1:
            attn = decode_attention(q[0], k_cache, v_cache, pos_vec, end,
                                    k_scale, v_scale)
        else:
            s = k_cache.shape[0]
            attn = sdpa(q, _deq(k_cache, k_scale, q.dtype).view(
                s, num_heads, d), _deq(v_cache, v_scale, q.dtype).view(
                s, num_heads, d), bias)
    return _post(p, x, attn.reshape(t, dm), fused, gelu_approx)


def forward(p, cfg, state: BackboneState, x, n_valid: int = None,
            gelu_approx: bool = False):
    """Run T new rows through all layers, writing KV at slot state.end.

    x: (T, d_model); rows >= n_valid are padding (position -1, masked by
    every later step). Returns (state, y (T, d_model)); the caller moves the
    cursors with `advance`. A state holding shared-prefix tables runs only
    over lanes (`forward_lanes`).
    """
    if state.pk is not None:
        raise ValueError("a shared-prefix state decodes over lanes "
                         "(forward_lanes)")
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
    quant = state.k_scale is not None
    for l in range(cfg.num_layers):
        x = _layer(slice_layer_params(p["layers"], l), x, state.k[l],
                   state.v[l], state.k_scale[l] if quant else None,
                   state.v_scale[l] if quant else None, end, cos, sin, bias,
                   state.pos, cfg.num_heads, gelu_approx, cur_pos)
    return state, x


def shrink_state(state: BackboneState, capacity: int) -> BackboneState:
    """A COPY of the first `capacity` slots (cursors unchanged): bounds the
    attention reads of a sentence to the slots it can use, and leaves the
    source (a reusable voice prefix) untouched by the in-place decode. The
    shared-prefix tables are read-only and stay shared."""
    return dataclasses.replace(
        state, k=[k[:capacity].clone() for k in state.k],
        v=[v[:capacity].clone() for v in state.v],
        pos=state.pos[:capacity].clone(),
        k_scale=(None if state.k_scale is None
                 else [s[:capacity].clone() for s in state.k_scale]),
        v_scale=(None if state.v_scale is None
                 else [s[:capacity].clone() for s in state.v_scale]))


def split_prefix(state: BackboneState, p: int, num_heads: int,
                 dtype=torch.bfloat16):
    """Move slots [0, p) of a primed SOLO state into shared-prefix tables.

    Returns ((pk, pv, ppos), residual): pk/pv per-layer HEAD-MAJOR
    (H, p, D) tables of `dtype` (int8 rows are dequantized: the tables are
    read once per frame for the whole batch), ppos the (p,) positions; the
    residual state (a copy) keeps slots [p:] with the slot cursor rebased,
    ready for text prefill. The JAX package's `split_prefix`."""
    quant = state.k_scale is not None
    d = state.k[0].shape[-1] // num_heads

    def grab(rows, scale):
        r = rows[:p]
        if quant:
            r = r.float() * scale[:p, None]
        return r.to(dtype).reshape(p, num_heads, d).transpose(0, 1) \
            .contiguous()

    n = len(state.k)
    pk = [grab(state.k[l], state.k_scale[l] if quant else None)
          for l in range(n)]
    pv = [grab(state.v[l], state.v_scale[l] if quant else None)
          for l in range(n)]
    ppos = state.pos[:p].clone()
    residual = dataclasses.replace(
        state, k=[k[p:].clone() for k in state.k],
        v=[v[p:].clone() for v in state.v], pos=state.pos[p:].clone(),
        end=state.end - p,
        k_scale=(None if not quant
                 else [s[p:].clone() for s in state.k_scale]),
        v_scale=(None if not quant
                 else [s[p:].clone() for s in state.v_scale]))
    return (pk, pv, ppos), residual


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
    # int8 KV: L x (B, S) float32 per-row scales
    k_scale: Optional[list] = None
    v_scale: Optional[list] = None
    # shared prefix: L x (H, P, D) tables shared by the lanes, (B, P) ppos
    pk: Optional[list] = None
    pv: Optional[list] = None
    ppos: Optional[torch.Tensor] = None

    @property
    def lanes(self) -> int:
        return self.pos.shape[0]


def _layer_lanes(p, x, k_cache, v_cache, k_scale, v_scale, end: int, cos,
                 sin, bias, pos, cur_pos, read_end: int, num_heads: int,
                 gelu_approx: bool, prefix=None):
    """One pre-LN layer over B lanes, x (B, T, d_model); writes the KV rows
    at slot `end` of every lane in place (through K7 when T == 1). prefix:
    this layer's (pk, pv, ppos) in shared-prefix mode, else None."""
    b, t, dm = x.shape
    d = dm // num_heads
    fused = t == 1 and fused_layer.supported(p)
    if fused:
        qkv = fused_layer.pre_attention(p, x, eps=1e-5)
    else:
        qkv = linear(p["in_proj"], layer_norm(p["norm1"], x, eps=1e-5))
    q, k, v = qkv.split(dm, -1)
    q = apply_rope(q.reshape(b, t, num_heads, d), cos, sin)
    k = apply_rope(k.reshape(b, t, num_heads, d), cos, sin).reshape(b, t, dm)
    share = prefix is not None
    if share:
        o1, m1, l1 = prefix_attn_stats(q, *prefix)
    if t == 1:
        kn, vn, extra = _k7_rows(k, v.contiguous(), k_scale, v_scale)
        res = decode_insert_attention(
            q[:, 0].contiguous(), kn, vn, cur_pos, k_cache, v_cache, pos,
            read_end, end, stats=share, **extra)
        attn = (merge_attn_partials(o1[:, 0], m1[:, 0], l1[:, 0], *res)
                if share else res)
    else:
        _write_rows(k_cache, v_cache, k_scale, v_scale, end, k, v)
        kd = _deq(k_cache, k_scale, q.dtype)
        vd = _deq(v_cache, v_scale, q.dtype)
        if share:
            attn = merge_attn_partials(o1, m1, l1,
                                       *sdpa_seg_stats(q, kd, vd, bias))
        else:
            s = k_cache.shape[1]
            attn = sdpa(q, kd.view(b, s, num_heads, d),
                        vd.view(b, s, num_heads, d), bias)
    return _post(p, x, attn.reshape(b, t, dm), fused, gelu_approx)


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
    quant = state.k_scale is not None
    for l in range(cfg.num_layers):
        x = _layer_lanes(
            slice_layer_params(p["layers"], l), x, state.k[l], state.v[l],
            state.k_scale[l] if quant else None,
            state.v_scale[l] if quant else None, end, cos, sin, bias,
            state.pos, cur_pos, read_end, cfg.num_heads, gelu_approx,
            None if state.pk is None
            else (state.pk[l], state.pv[l], state.ppos))
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
