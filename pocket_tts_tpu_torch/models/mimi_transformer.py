"""Mimi decoder transformer: 2 layers, d=512, 8 heads, a ring-buffer KV cache
(256 slots, attention window 250), eps=0 LayerNorm, LayerScale on both
branches.

Counterpart of `pocket_tts_tpu/models/mimi_transformer.py`. The ring rows
are FLAT (cap, H*D) like the JAX package's; `offset` counts the timesteps
written and `start` is the stream's first timestep (0 solo). Each layer's
ring step, insert + attention, goes through kernel K2
(ops/ring_attn.ring_insert_attention), which writes the caches IN PLACE;
`forward` advances `offset` on the same state object. With int8 or int4
weights (io/quant.py) each layer's norm1 + in_proj run as kernel K5a and
its out_proj + MLP (with both layer scales) as kernel K5b
(ops/fused_layer.py), as the JAX package does. With `cfg.quantize_kv` the
ring rows are int8 with one float32 absmax scale per row (`k_scale`,
`v_scale`, L x (cap,) or (B, cap) with lanes): each layer quantizes its 16
new K and V rows with `quantize_rows` and hands them to K2's int8 variant
(K2-q), which writes bytes and scales into the ring in place.

Lanes (continuous batching): with caches (B, cap, H*D) and `start` a (B,)
int32 device tensor, `forward` takes x (B, T, d_model). The lanes share
`offset` (so every lane writes the same ring slots, as the JAX package's
`_axes_like` keeps it unbatched); each lane's RoPE positions are
offset - start[b] and its ring window is fenced at its own start, so a
lane that joined a running batch decodes as a solo stream would. K2 runs
all lanes in one launch per layer, and with quantized weights K5a and K5b
take the B * T rows of all lanes in one call each (ops/fused_layer.py).

The variants a checkpoint switches on (the JAX package's `_layer`):
`norm1` / `norm2` as RMSNorm when they carry "alpha" (`_norm_any`, eps
1e-8 as there); a cross-attention sub-block when the layer ships
`cross_attention` weights and the state holds their KV (`init_cross`):
`norm_cross` at cfg.norm_eps (0 in mimi), `ops.attention.
cross_attention`, a residual with no layer scale, between the attention
residual and the MLP; and SwiGLU gating (ops/gating.py) in place of the
linear1/GELU/linear2 MLP when the layer carries "gating", given the
shared ring `offset` as its step (as the JAX package passes it under
vmap; the same for every lane). Such a layer never takes the fused
K5a/K5b route: that is taken only for a layer without "gating" that
`fused_layer.supported` accepts (which refuses "alpha" and cross
layers). K2 (K2-q) stays on every variant's path; quantized linears of
the variants go through K4a / K4b.

When `cfg.use_pallas_attn` is False (the reference-exact mode) the model
takes the JAX package's XLA route instead of K2 and of the fused K5a/K5b:
K2's plain version, `ring_insert_attention_plain`, called with the cfg's
mask. Its insert scatters by rows, so the reference-exact mode's 250-slot
ring may wrap inside a 16-step block, and its -1e5 mask goes into
`ring_cache_bias`. Quantized linears still go through K4a / K4b there.
`config.check_supported` refuses a capacity that is not a multiple of T,
or a mask other than -1e9, on the kernel route.

On a mesh (`cfg.mesh`, set by runtime.batched.mesh_cfg when "model"
divides the heads) each rank holds its heads: its columns of q, k, v and
of the ring, its block of the MLP's hidden width (parallel/sharding.py).
K2 runs on the local heads; a float out_proj and linear2 are summed over
the "model" group before their layer scales and residual adds, a
quantized one runs whole on the input gathered over the group
(parallel.sharding.row_linear); an int8 ring's new rows are scaled by the
whole row's absmax (maxed over the group); a gated layer's MLP stays
whole on every rank. No layer takes K5a / K5b there
(`sharding.fusable`): quantized linears go through K4a / K4b on the
rank's block. A cross state is refused there.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..ops import fused_layer
from ..ops.attention import cross_attention, cross_attn_kv
from ..ops.basic import (gelu, layer_norm, linear, quantize_rows, rms_norm,
                         slice_layer_params)
from ..ops.gating import weights_per_step_gating
from ..ops.ring_attn import ring_insert_attention, ring_insert_attention_plain
from ..ops.rope import apply_rope_halves as apply_rope, rope_cos_sin
from ..parallel.sharding import (fusable, local_heads, model_group,
                                 reduce_absmax, row_linear)


@dataclasses.dataclass
class MimiTransformerState:
    k: list          # L x (cap, H*D), or L x (B, cap, H*D) with lanes;
    v: list          # int8 with cfg.quantize_kv
    offset: int = 0  # timesteps seen (shared by the lanes)
    start: object = 0  # first timestep of the stream; (B,) int32 tensor
                       # with lanes
    # int8 ring: L x (cap,) float32 per-row scales, (B, cap) with lanes
    k_scale: Optional[list] = None
    v_scale: Optional[list] = None
    # cross-attention KV of a conditioning sequence (init_cross): L x
    # (S_c, H, D) (None: no cross-attention)
    xk: Optional[list] = None
    xv: Optional[list] = None


def init_state(cfg, dtype=torch.float32, device="cpu"):
    """An empty solo ring; on a mesh it holds this rank's heads."""
    shape = (cfg.capacity, local_heads(cfg) * cfg.head_dim)
    cache = torch.int8 if cfg.quantize_kv else dtype

    def scales():
        return ([torch.zeros(cfg.capacity, device=device)
                 for _ in range(cfg.num_layers)] if cfg.quantize_kv
                else None)

    return MimiTransformerState(
        k=[torch.zeros(shape, dtype=cache, device=device)
           for _ in range(cfg.num_layers)],
        v=[torch.zeros(shape, dtype=cache, device=device)
           for _ in range(cfg.num_layers)],
        k_scale=scales(), v_scale=scales())


def init_cross(p, cfg, state: MimiTransformerState, cond):
    """Fill the state's cross-attention KV from a conditioning sequence
    cond (S_c, d_model); returns the state unchanged when the layers ship
    no cross weights."""
    xk, xv = [], []
    for l in range(cfg.num_layers):
        lp = slice_layer_params(p["layers"], l)
        if "cross_attention" not in lp:
            return state
        k, v = cross_attn_kv(lp["cross_attention"]["in_proj"], cond,
                             cfg.num_heads)
        xk.append(k)
        xv.append(v)
    state.xk, state.xv = xk, xv
    return state


def _norm_any(p, x, eps: float):
    """LayerNorm at eps, or RMSNorm at its default eps when the params
    carry "alpha"."""
    if "alpha" in p:
        return rms_norm(p, x)
    return layer_norm(p, x, eps=eps)


def _layer(p, x, k_cache, v_cache, k_scale, v_scale, offset: int, start,
           cos, sin, cfg, gelu_approx: bool, plain: bool = False, xk=None,
           xv=None):
    """One layer; plain: the plain ring route (no K2, no K5a/K5b); xk/xv:
    this layer's cross-attention KV, or None. On a mesh the layer runs on
    this rank's heads (see the module docstring)."""
    *lead, t, _ = x.shape
    group, nh = model_group(cfg), local_heads(cfg)
    fused = not plain and "gating" not in p and fusable(p, cfg.mesh)
    if fused:
        qkv = fused_layer.pre_attention(p, x, eps=cfg.norm_eps)
    else:
        qkv = linear(p["in_proj"], _norm_any(p["norm1"], x, cfg.norm_eps))
    dm = qkv.shape[-1] // 3
    q, k, v = qkv.split(dm, -1)
    heads = (*lead, t, nh, cfg.head_dim)
    q = apply_rope(q.reshape(heads), cos, sin)
    k = apply_rope(k.reshape(heads), cos, sin).reshape(*lead, t, dm)
    v = v.contiguous()
    extra = {}
    if k_scale is not None:
        amax = (None, None) if group is None else reduce_absmax(
            torch.stack([k, v]), group)
        (k, ks), (v, vs) = quantize_rows(k, amax[0]), quantize_rows(
            v, amax[1])
        extra = dict(k_scale=k_scale, v_scale=v_scale, ks_new=ks, vs_new=vs)
    if plain:
        extra["neg"] = cfg.mask_value
    attn = (ring_insert_attention_plain if plain else ring_insert_attention)(
        q.reshape(*lead, t, dm), k, v, k_cache, v_cache, offset, start,
        nh, cfg.context, **extra)
    if fused:
        return fused_layer.post_attention(p, x, attn, eps=cfg.norm_eps,
                                          approx=gelu_approx)
    x = x + p["layer_scale_1"]["scale"] * row_linear(p["out_proj"], attn,
                                                     group)
    if "cross_attention" in p and xk is not None:
        x = x + cross_attention(
            p["cross_attention"], layer_norm(p["norm_cross"], x,
                                             eps=cfg.norm_eps),
            xk, xv, cfg.num_heads)
    h = _norm_any(p["norm2"], x, cfg.norm_eps)
    if "gating" in p:
        up = weights_per_step_gating(p["gating"], h, offset=offset)
    else:
        up = row_linear(p["linear2"], gelu(linear(p["linear1"], h),
                                           gelu_approx), group)
    return x + p["layer_scale_2"]["scale"] * up


def forward(p, cfg, state: MimiTransformerState, x,
            gelu_approx: bool = False):
    """x: (T, d_model), or (B, T, d_model) with lanes -> (state, y);
    advances state.offset by T. The ring step runs K2 unless
    cfg.use_pallas_attn is False (the plain ring route)."""
    t = x.shape[-2]
    rel = state.offset - state.start      # an int, or (B,) with lanes
    if isinstance(rel, torch.Tensor):
        rel = rel[:, None]
    positions = rel + torch.arange(t, dtype=torch.int32, device=x.device)
    cos, sin = rope_cos_sin(positions, cfg.head_dim, cfg.max_period)
    quant = state.k_scale is not None
    plain = cfg.use_pallas_attn is False
    cross = state.xk is not None
    if cross and (x.dim() == 3 or cfg.mesh is not None):
        raise ValueError("mimi_transformer.forward: a cross-attention "
                         "state (init_cross) decodes solo, not over lanes "
                         "and not on a mesh")
    for l in range(cfg.num_layers):
        x = _layer(slice_layer_params(p["layers"], l), x, state.k[l],
                   state.v[l], state.k_scale[l] if quant else None,
                   state.v_scale[l] if quant else None, state.offset,
                   state.start, cos, sin, cfg, gelu_approx, plain,
                   state.xk[l] if cross else None,
                   state.xv[l] if cross else None)
    state.offset += t
    return state, x
