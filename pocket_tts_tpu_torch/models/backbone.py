"""FlowLM streaming transformer backbone (6 layers, d=1024, 16 heads).

Counterpart of `pocket_tts_tpu/models/backbone.py`, solo (`BackboneState`,
`forward`) and over B lanes (`BatchedBackboneState`, `forward_lanes`). The
KV cache keeps the JAX package's layout: per-layer FLAT (S, H*D) rows
written at the slot cursor `end`, with `pos` recording the absolute
position each slot holds (-1 = padding or unwritten). RoPE and causality
use positions. With `cfg.quantize_kv` the rows are int8 with one float32
absmax scale per row (`k_scale`, `v_scale`; `quantize_rows`, bit for bit
the JAX package's), the engine's serving-throughput mode.

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
With `cfg.use_megalayer` a quantized decode layer is ONE launch of kernel
K8 (ops/fused_step.megalayer: K5a, the row quantization, K7 and K5b in
one), and with `cfg.use_bilayer` (int4 weights, without the megalayer)
the step runs K5a of layer 0, then per layer the attention and K5c
(fused_layer.bilayer_post_pre: K5b of layer l with K5a of layer l + 1),
K5b after the last (`_forward_bilayer`). K7, K8 and K5c update the caches
in place, as the rest of the port does, where the JAX docstrings say
"aliased".

`cfg.use_pallas_attn=False` (the reference-exact mode) is the JAX
package's XLA route (`pallas_mode == "off"`): a decode step writes its row
and attends with plain PyTorch under `pos_cache_bias(..., neg=
cfg.mask_value)`, as prefill does, and runs no K1, K7, K8 or fused
K5a/K5b/K5c, solo or over lanes; quantized linears still go through K4a /
K4b (ops/basic.linear). Throughout, a `bias` of None marks the kernel
route of a T = 1 step.

Lanes (continuous batching): the caches are (B, S, H*D) and `pos` (B, S);
the write slot `end` (and, in prefix+ring mode, `ring_start`) is a host
int shared by the lanes, while each lane's `next_pos` is a (B,) device
tensor, so lanes hold streams at different points of their sentences.
A batch whose frames run from CUDA graphs (models/frame_graph.py) keeps
the write slot on the device too (`end_dev`): the decode step writes its
position row and KV rows by that index, K7 reads the slot from it, and
`advance_lanes` moves both, the host int being the mirror. A
decode step (T = 1) runs K7 over all lanes in one launch per layer (int8
caches: its int8-KV variant, the new rows quantized here), or without
`cfg.fuse_insert` a row write and K1 over the lanes, and with quantized
weights K5a and K5b over the B rows; a prefill (T > 1) attends
with plain PyTorch under a (B, T, S) position bias, as the JAX package
runs it on XLA.

Cross-attention (a checkpoint that ships `cross_attention` weights;
`init_cross` fills `xk`/`xv` from a conditioning sequence once a stream):
each layer's tail takes the sub-block `norm_cross` (eps 1e-5) ->
`ops.attention.cross_attention` -> residual, with no layer scale, between
the attention residual and the MLP (`_post`). A state with cross KV takes
the JAX package's routes (`backbone.py:433-466`): no fused K5a/K5b, no K7,
K8 or bilayer loop; a decode step writes its rows and attends through K1
(K1-q on an int8 cache), a prefill through plain `sdpa`. Such a state is
solo: `shrink_state`, `split_prefix` and the lane stacking refuse it.

Shared prefix (`split_prefix`; runtime/server.py share_prefix=True): each
voice's prompt KV moves out of the lane caches into per-layer head-major
(H, P, D) tables `pk`/`pv` of the working type, shared by every lane and
holding every registered voice's prompt side by side; `ppos` (B, P)
unmasks each lane's own voice segment. Each layer attends the tables
(ops/attention.prefix_attn_stats, one batched product for all lanes) and
its own cache (K7 or K1 with statistics at T = 1, `sdpa_seg_stats` in
prefill),
and merges the two partials exactly (`merge_attn_partials`).

On a ("data", "model") mesh (`cfg.mesh`, set by runtime.batched.mesh_cfg
when "model" divides the heads; parallel/sharding.py) a rank holds its
heads: its columns of q, k, v and of the caches (`init_state` sizes them),
its block of the MLP width, its heads of the prefix tables. K1 and K7 run
on the local heads unchanged; out_proj and linear2 are summed over the
"model" group before their residual adds (`_post`; a quantized one is
whole, on the input gathered over the group: parallel.sharding.
row_linear); an int8 cache's new rows are scaled by the WHOLE row's
absmax, maxed over the group (`_quantize_kv`, prefill and decode), as the
JAX package hands the full-row scales to its head shards. No fused layer
kernel (K5a / K5b, K5c, K8) runs on a mesh (`sharding.fusable`): a
quantized layer's linears go through K4a / K4b there, each on the block
the rank holds.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from . import frame_graph
from ..ops import fused_layer, fused_step
from ..ops.attention import (cross_attention, cross_attn_kv,
                             merge_attn_partials, pos_cache_bias,
                             prefix_attn_stats, sdpa, sdpa_seg_stats)
from ..ops.basic import (gelu, layer_norm, linear, quantize_rows,
                         slice_layer_params)
from ..ops.decode_attn import decode_attention
from ..ops.insert_attn import decode_insert_attention
from ..ops.rope import apply_rope_halves as apply_rope, rope_cos_sin
from ..parallel.sharding import (fusable, local_heads, model_group,
                                 reduce_absmax, row_linear)


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
    # cross-attention KV of a conditioning sequence (init_cross): L x
    # (S_c, H, D), read every step (None: no cross-attention)
    xk: Optional[list] = None
    xv: Optional[list] = None


def init_state(cfg, dtype=torch.float32, device="cpu") -> BackboneState:
    """An empty solo state; on a mesh (cfg.mesh) its caches hold this
    rank's heads."""
    shape = (cfg.kv_capacity, local_heads(cfg) * cfg.head_dim)
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


def init_cross(p, cfg, state: BackboneState, cond) -> BackboneState:
    """Fill the state's cross-attention KV from a conditioning sequence
    cond (S_c, d_model): each layer's `cross_attention.in_proj` applied
    once (`cross_attn_kv`). Needs a checkpoint with cross weights."""
    xk, xv = [], []
    for l in range(cfg.num_layers):
        k, v = cross_attn_kv(slice_layer_params(
            p["layers"], l)["cross_attention"]["in_proj"], cond,
            cfg.num_heads)
        xk.append(k)
        xv.append(v)
    state.xk, state.xv = xk, xv
    return state


def refuse_cross(state, what: str) -> None:
    """Raise for a state holding cross-attention KV: `what` serves solo
    states without it only (no JAX entry point builds one for serving)."""
    if state.xk is not None:
        raise ValueError(f"{what}: a cross-attention state (init_cross) "
                         "decodes solo, through `forward` only")


def _quantize_kv(k_rows, v_rows, group):
    """The int8 K and V rows with their scales, (kq, ks), (vq, vs). On a
    mesh (group: the "model" group) the rows hold this rank's heads only,
    and each row's absmax is maxed over the group first (one reduce for K
    and V), so that every shard scales by the WHOLE row's absmax, as the
    JAX package does."""
    amax = (None, None) if group is None else reduce_absmax(
        torch.stack([k_rows, v_rows]), group)
    return quantize_rows(k_rows, amax[0]), quantize_rows(v_rows, amax[1])


def _write_rows(k_cache, v_cache, k_scale, v_scale, end, k_rows,
                v_rows, group=None):
    """Write (..., T, H*D) rows at slots [end, end + T) of (..., S, H*D)
    caches in place; int8 caches get the quantized rows and their scales
    (group: as in _quantize_kv). end: an int, or a device cursor
    (frame_graph.Cursor), whose slots are indexed on the device."""
    t = k_rows.shape[-2]
    dev = getattr(end, "dev", None)
    if dev is not None:
        idx = dev.long() + torch.arange(t, device=dev.device)

    def put(dst, src, dim):
        if dev is None:
            dst.narrow(dim, end, t).copy_(src)
        else:
            dst.index_copy_(dim, idx, src.to(dst.dtype))

    if k_scale is None:
        put(k_cache, k_rows, -2)
        put(v_cache, v_rows, -2)
        return
    for cache, scale, (q, s) in zip(
            (k_cache, v_cache), (k_scale, v_scale),
            _quantize_kv(k_rows, v_rows, group)):
        put(cache, q, -2)
        put(scale, s, -1)


def _deq(cache, scale, dtype):
    """A cache as rows of `dtype`: int8 rows times their scales, rounded
    (the JAX package's XLA route), or the cache itself."""
    if scale is None:
        return cache
    return (cache.float() * scale[..., None]).to(dtype)


def _k7_rows(kn, vn, k_scale, v_scale, group=None):
    """K7's new (B, 1, H*D) rows and keyword arguments: for int8 caches
    the rows quantized here (as the JAX package's caller does), with their
    scales and the (B, S) scale rows (group: as in _quantize_kv)."""
    if k_scale is None:
        return kn, vn, {}
    (kq, ks), (vq, vs) = _quantize_kv(kn, vn, group)
    return kq, vq, dict(k_scale=k_scale, v_scale=v_scale, ks_new=ks[:, 0],
                        vs_new=vs[:, 0])


def _post(p, x, attn, fused: bool, gelu_approx: bool, cross=None,
          num_heads: int = 0, group=None):
    """out_proj + residual + norm2 + MLP + residual: K5b when fused.
    cross: this layer's (xk, xv) when the state holds cross KV (never
    fused): the cross sub-block runs between the residual and the MLP.
    group: the "model" group of a mesh: attn holds this rank's heads and
    the MLP's hidden width its block, and out_proj and linear2 are summed
    over the group before their residual adds (parallel.sharding.
    row_linear)."""
    if fused:
        return fused_layer.post_attention(p, x, attn, eps=1e-5,
                                          approx=gelu_approx)
    x = x + row_linear(p["out_proj"], attn, group)
    if cross is not None:
        x = x + cross_attention(p["cross_attention"],
                                layer_norm(p["norm_cross"], x, eps=1e-5),
                                cross[0], cross[1], num_heads)
    h = layer_norm(p["norm2"], x, eps=1e-5)
    return x + row_linear(p["linear2"],
                          gelu(linear(p["linear1"], h), gelu_approx), group)


def _attend(qkv, k_cache, v_cache, k_scale, v_scale, end: int, cos, sin,
            bias, pos_vec, num_heads: int, cur_pos=None, group=None):
    """The attention middle of a solo layer: qkv (T, 3 dm) -> attn (T, dm),
    the new KV rows written at slot `end` in place. cur_pos: the (1,) int32
    position of a decode step's row when it goes through K7
    (cfg.fuse_insert), else None. bias: None for a T = 1 step on the
    kernels (K1), else the (T, S) bias of plain attention. On a mesh,
    num_heads is this rank's and group its "model" group (int8 scales).
    The JAX package's `_attend` (factored out for the bilayer loop) and
    the middle of its `_layer`."""
    t = qkv.shape[0]
    dm = qkv.shape[-1] // 3
    d = dm // num_heads
    q, k, v = qkv.split(dm, -1)
    q = apply_rope(q.reshape(t, num_heads, d), cos, sin)
    k = apply_rope(k.reshape(t, num_heads, d), cos, sin).reshape(t, dm)
    if cur_pos is not None:
        kn, vn, extra = _k7_rows(
            k.reshape(1, 1, dm), v.reshape(1, 1, dm),
            None if k_scale is None else k_scale[None],
            None if v_scale is None else v_scale[None], group)
        attn = decode_insert_attention(
            q, kn, vn, cur_pos, k_cache[None], v_cache[None], pos_vec[None],
            end, end, **extra)[0]
    else:
        _write_rows(k_cache, v_cache, k_scale, v_scale, end, k, v, group)
        if bias is None:
            attn = decode_attention(q[0], k_cache, v_cache, pos_vec, end,
                                    k_scale, v_scale)
        else:
            s = k_cache.shape[0]
            attn = sdpa(q, _deq(k_cache, k_scale, q.dtype).view(
                s, num_heads, d), _deq(v_cache, v_scale, q.dtype).view(
                s, num_heads, d), bias)
    return attn.reshape(t, dm)


def _layer(p, x, k_cache, v_cache, k_scale, v_scale, end: int, cos, sin,
           bias, pos_vec, num_heads: int, gelu_approx: bool, cur_pos=None,
           megalayer: bool = False, cross=None, group=None, mesh=None):
    """One pre-LN layer; writes its KV rows at slot `end` in place.
    cur_pos: as in _attend. megalayer (cfg.use_megalayer): a T = 1
    quantized layer runs as ONE launch of kernel K8 (ops/fused_step), read
    end and write slot both `end`, as the JAX package's `_layer` routes
    it; it raises for a layer K8 does not take (q4_0 scales). A bias at
    T = 1 (the plain route) fuses nothing, and neither does a layer with
    cross KV (`cross`: its (xk, xv); the caller passes no cur_pos and no
    megalayer with it). group: the "model" group of a mesh (num_heads is
    then this rank's); mesh: the layer's cfg.mesh, under which nothing
    fuses (`sharding.fusable`)."""
    t = x.shape[0]
    fused = (t == 1 and bias is None and cross is None
             and fusable(p, mesh))
    if fused and megalayer:
        return fused_step.megalayer(
            p, x, cos, sin, pos_vec[end:end + 1], k_cache, v_cache,
            pos_vec, end, end, k_scale, v_scale, gelu_approx)
    if fused:
        qkv = fused_layer.pre_attention(p, x, eps=1e-5)
    else:
        qkv = linear(p["in_proj"], layer_norm(p["norm1"], x, eps=1e-5))
    attn = _attend(qkv, k_cache, v_cache, k_scale, v_scale, end, cos, sin,
                   bias, pos_vec, num_heads, cur_pos, group)
    return _post(p, x, attn, fused, gelu_approx, cross, num_heads, group)


def _forward_bilayer(p, cfg, state: BackboneState, x, cos, sin, cur_pos,
                     gelu_approx: bool):
    """Solo int4 decode with post(l) + pre(l + 1) fused at each layer
    boundary (cfg.use_bilayer), the JAX package's `_forward_bilayer`: K5a
    of layer 0, then per layer the attention and K5c (K5b for the last
    layer), 2L + 1 fused launches per step instead of 3L."""
    quant = state.k_scale is not None
    lps = [slice_layer_params(p["layers"], l) for l in range(cfg.num_layers)]
    qkv = fused_layer.pre_attention(lps[0], x, eps=1e-5)
    for l in range(cfg.num_layers):
        attn = _attend(qkv, state.k[l], state.v[l],
                       state.k_scale[l] if quant else None,
                       state.v_scale[l] if quant else None, state.end, cos,
                       sin, None, state.pos, cfg.num_heads, cur_pos)
        if l + 1 < cfg.num_layers:
            x, qkv = fused_layer.bilayer_post_pre(
                lps[l], lps[l + 1], x, attn, eps=1e-5, approx=gelu_approx)
        else:
            x = fused_layer.post_attention(lps[l], x, attn, eps=1e-5,
                                           approx=gelu_approx)
    return state, x


def forward(p, cfg, state: BackboneState, x, n_valid: int = None,
            gelu_approx: bool = False):
    """Run T new rows through all layers, writing KV at slot state.end.

    x: (T, d_model); rows >= n_valid are padding (position -1, masked by
    every later step). Returns (state, y (T, d_model)); the caller moves the
    cursors with `advance`. A state holding shared-prefix tables runs only
    over lanes (`forward_lanes`). A decode step (T = 1) with quantized
    weights runs each layer through K8 under cfg.use_megalayer, or, under
    cfg.use_bilayer without it and with int4 weights, the bilayer loop
    (K5c), as the JAX package gates them (`backbone.py:438-452`); with
    cfg.use_pallas_attn False it runs none of them (plain attention). A
    state with cross KV runs none of them either, nor K7: its decode step
    writes the rows and runs K1 (`backbone.py:455-463`). On a mesh
    (cfg.mesh) the layers run on this rank's heads (parallel/sharding.py)
    and none of K8, K5c or K5a / K5b runs; a cross state is refused
    there.
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
    kernels = t == 1 and cfg.use_pallas_attn is not False
    bias = (None if kernels
            else pos_cache_bias(positions, state.pos, neg=cfg.mask_value))
    cross = state.xk is not None
    group = model_group(cfg)
    if cross and cfg.mesh is not None:
        raise ValueError("a cross-attention state (init_cross) decodes "
                         "solo, without a mesh")
    cur_pos = (state.pos[end:end + 1]
               if kernels and cfg.fuse_insert and not cross else None)
    if (kernels and cfg.use_bilayer and not cfg.use_megalayer
            and cfg.num_layers > 1 and not cross):
        l0 = slice_layer_params(p["layers"], 0)
        # the (0, 1) pair stands for every pair: the layers are quantized
        # as one stacked array (io/quant.py), one layout for all
        if (fusable(l0, cfg.mesh) and fused_layer.bilayer_supported(
                l0, slice_layer_params(p["layers"], 1))):
            return _forward_bilayer(p, cfg, state, x, cos, sin, cur_pos,
                                    gelu_approx)
    quant = state.k_scale is not None
    for l in range(cfg.num_layers):
        x = _layer(slice_layer_params(p["layers"], l), x, state.k[l],
                   state.v[l], state.k_scale[l] if quant else None,
                   state.v_scale[l] if quant else None, end, cos, sin, bias,
                   state.pos, local_heads(cfg), gelu_approx, cur_pos,
                   cfg.use_megalayer and not cross,
                   (state.xk[l], state.xv[l]) if cross else None, group,
                   cfg.mesh)
    return state, x


def shrink_state(state: BackboneState, capacity: int) -> BackboneState:
    """A COPY of the first `capacity` slots (cursors unchanged): bounds the
    attention reads of a sentence to the slots it can use, and leaves the
    source (a reusable voice prefix) untouched by the in-place decode. The
    shared-prefix tables are read-only and stay shared. Raises ValueError
    for a cross-attention state."""
    refuse_cross(state, "shrink_state")
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
    ready for text prefill. The JAX package's `split_prefix`. On a mesh
    the state holds this rank's heads (num_heads: its local count), so the
    tables come out head-sliced, the layout parallel/sharding.py gives
    them. Raises ValueError for a cross-attention state."""
    refuse_cross(state, "split_prefix")
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
    # `end` on the device as well, a (1,) int32 (frame_graph.attach_cursors)
    end_dev: Optional[torch.Tensor] = None

    @property
    def lanes(self) -> int:
        return self.pos.shape[0]


def _layer_lanes(p, x, k_cache, v_cache, k_scale, v_scale, end: int, cos,
                 sin, bias, pos, cur_pos, read_end: int, num_heads: int,
                 gelu_approx: bool, prefix=None, fuse_insert: bool = True,
                 group=None, mesh=None):
    """One pre-LN layer over B lanes, x (B, T, d_model); writes the KV rows
    at slot `end` of every lane in place. A decode step (T = 1) goes
    through K7 under fuse_insert, else writes the rows and runs K1 over the
    lanes. prefix: this layer's (pk, pv, ppos) in shared-prefix mode, else
    None. bias: None for a T = 1 step on the kernels, else the (B, T, S)
    bias of plain attention (prefill, and every step of the plain route,
    which fuses nothing). group: the "model" group of a mesh, num_heads
    then this rank's (its heads' columns of q, k, v and of the caches;
    out_proj and linear2 summed over the group, or whole on the gathered
    input); mesh: cfg.mesh, under which nothing fuses
    (`sharding.fusable`)."""
    b, t, _ = x.shape
    fused = t == 1 and bias is None and fusable(p, mesh)
    if fused:
        qkv = fused_layer.pre_attention(p, x, eps=1e-5)
    else:
        qkv = linear(p["in_proj"], layer_norm(p["norm1"], x, eps=1e-5))
    dm = qkv.shape[-1] // 3
    d = dm // num_heads
    q, k, v = qkv.split(dm, -1)
    q = apply_rope(q.reshape(b, t, num_heads, d), cos, sin)
    k = apply_rope(k.reshape(b, t, num_heads, d), cos, sin).reshape(b, t, dm)
    share = prefix is not None
    if share:
        o1, m1, l1 = prefix_attn_stats(q, *prefix)
    if bias is None and fuse_insert:
        kn, vn, extra = _k7_rows(k, v.contiguous(), k_scale, v_scale, group)
        res = decode_insert_attention(
            q[:, 0].contiguous(), kn, vn, cur_pos, k_cache, v_cache, pos,
            read_end, end, stats=share, **extra)
        attn = (merge_attn_partials(o1[:, 0], m1[:, 0], l1[:, 0], *res)
                if share else res)
    elif bias is None:
        _write_rows(k_cache, v_cache, k_scale, v_scale, end, k, v, group)
        res = decode_attention(q[:, 0].contiguous(), k_cache, v_cache, pos,
                               read_end, k_scale, v_scale, stats=share)
        attn = (merge_attn_partials(o1[:, 0], m1[:, 0], l1[:, 0], *res)
                if share else res)
    else:
        _write_rows(k_cache, v_cache, k_scale, v_scale, end, k, v, group)
        kd = _deq(k_cache, k_scale, q.dtype)
        vd = _deq(v_cache, v_scale, q.dtype)
        if share:
            attn = merge_attn_partials(o1, m1, l1,
                                       *sdpa_seg_stats(q, kd, vd, bias))
        else:
            s = k_cache.shape[1]
            attn = sdpa(q, kd.view(b, s, num_heads, d),
                        vd.view(b, s, num_heads, d), bias)
    return _post(p, x, attn.reshape(b, t, dm), fused, gelu_approx,
                 group=group)


def forward_lanes(p, cfg, state: BatchedBackboneState, x, n_valid=None,
                  gelu_approx: bool = False):
    """Run T new rows of each lane through all layers, writing KV at slot
    state.end of every lane. x: (B, T, d_model); n_valid: (B,) int tensor
    of real rows per lane (the rest get position -1), or None for all.
    Returns (state, y (B, T, d_model)); the caller moves the cursors with
    `advance_lanes`. A decode step (T = 1) runs K7 under cfg.fuse_insert,
    else a row write and K1 over the lanes (with statistics under a shared
    prefix), the JAX package's vmapped `_layer`; with cfg.use_pallas_attn
    False a row write and plain attention instead. cfg.use_bilayer and
    cfg.use_megalayer change nothing over lanes: the JAX package gates the
    bilayer to solo decode, and its vmap rule for K8 runs the 3-call path
    (`fused_step.py:579-587`), which the serving cfg's fused insert gives
    here; both compute the function of the unfused layer. On a mesh
    (cfg.mesh) every layer runs on this rank's heads: its block of the
    params and of the caches (parallel/sharding.py), with the sums over
    the "model" group in `_post`."""
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
    ar = torch.arange(t, dtype=torch.int32, device=x.device)
    positions = state.next_pos[:, None] + ar                  # (B, T)
    rows = (positions if n_valid is None
            else torch.where(ar < n_valid[:, None], positions, -1))
    if state.end_dev is None:
        state.pos[:, end:end + t] = rows
    else:
        # the slot cursor on the device (a frame replayed from a graph)
        state.pos.index_copy_(1, state.end_dev.long() + ar.long(), rows)
        end = frame_graph.Cursor(state, "end", state.end_dev)
    cos, sin = rope_cos_sin(positions, cfg.head_dim, cfg.max_period)
    bias = (None if t == 1 and cfg.use_pallas_attn is not False
            else pos_cache_bias(positions, state.pos, neg=cfg.mask_value))
    # prefix+ring mode: after warm-up every slot is live, so K7 (K1) reads
    # them all; stale and unwritten slots are masked by their positions
    read_end = s - 1 if state.ring_start is not None else end
    cur_pos = rows[:, 0].contiguous()
    quant = state.k_scale is not None
    share = state.pk is not None
    heads, group = local_heads(cfg), model_group(cfg)
    for l in range(cfg.num_layers):
        x = _layer_lanes(
            slice_layer_params(p["layers"], l), x, state.k[l], state.v[l],
            state.k_scale[l] if quant else None,
            state.v_scale[l] if quant else None, end, cos, sin, bias,
            state.pos, cur_pos, read_end, heads, gelu_approx,
            (state.pk[l], state.pv[l], state.ppos) if share else None,
            bool(cfg.fuse_insert), group, cfg.mesh)
    return state, x


def advance_lanes(state: BatchedBackboneState, t: int,
                  n_valid) -> BatchedBackboneState:
    """Consume t slots (shared) and n_valid positions ((B,) tensor or an
    int). In prefix+ring mode the cursor wraps inside [ring_start, S):
    positions keep counting, only the storage slot recycles. A cursor kept
    on the device (`end_dev`) moves there too, and its host mirror through
    `frame_graph.host`, so a frame replayed from graphs moves both."""
    rs = state.ring_start
    ring = None if rs is None else state.pos.shape[1] - rs

    def move():
        end = state.end + t
        if rs is not None:
            end = rs + (end - rs) % ring
        state.end = end

    frame_graph.host(move)
    if state.end_dev is not None:
        e = state.end_dev
        if rs is None:
            e.add_(t)
        else:
            e.sub_(rs - t).remainder_(ring).add_(rs)
    state.next_pos += n_valid
    return state
