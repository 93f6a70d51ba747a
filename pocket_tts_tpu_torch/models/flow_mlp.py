"""SimpleMLPAdaLN: the flow-matching net that maps Gaussian noise to the next
32-d audio latent in one step, conditioned on the backbone output.

Counterpart of `pocket_tts_tpu/models/flow_mlp.py`, same params tree:
  input_proj, cond_embed: linear
  time_embed: 2 x {freqs, mlp_0, mlp_2, mlp_3 {alpha}}
  res_blocks (stacked over depth): {in_ln, mlp_0, mlp_2, adaln}
  final: {norm, linear, adaln}
Functions take one feature vector (no batch axis). With int8 or int4
weights (io/quant.py) `forward` runs the whole net as kernel K6
(ops/fused_flow.py), as the JAX package does on the TPU.
"""
from __future__ import annotations

import torch

from ..ops import fused_flow
from ..ops.basic import (layer_norm, linear, mlp_std_norm, modulate, silu,
                         slice_layer_params)


def timestep_embed(p, t: float):
    """cos/sin features -> mlp -> (n-1)-variance std-norm."""
    args = p["freqs"] * t
    emb = torch.cat([torch.cos(args), torch.sin(args)], -1)
    h = silu(linear(p["mlp_0"], emb))
    h = linear(p["mlp_2"], h)
    return mlp_std_norm(p["mlp_3"], h, eps=1e-5)


def time_cond(p):
    """(TE1(t=1) + TE0(s=0)) / 2: constant at inference (s=0, t=1 always).
    The loader computes it once per checkpoint (params["_time_cond"])."""
    return 0.5 * (timestep_embed(p["time_embed"][1], 1.0)
                  + timestep_embed(p["time_embed"][0], 0.0))


def res_block(p, x, y):
    mod = linear(p["adaln"], silu(y))
    shift, scale, gate = mod.chunk(3, -1)
    h = modulate(layer_norm(p["in_ln"], x, eps=1e-6), shift, scale)
    h = linear(p["mlp_2"], silu(linear(p["mlp_0"], h)))
    return x + gate * h


def final_layer(p, x, y):
    mod = linear(p["adaln"], silu(y))
    shift, scale = mod.chunk(2, -1)
    x = modulate(layer_norm(p["norm"], x, eps=1e-6), shift, scale)
    return linear(p["linear"], x)


def forward(p, c, x, t_combined=None, fused: bool = True):
    """Flow direction for one step. c: (d_model,) conditioning; x:
    (latent,) noise; t_combined: precomputed `time_cond(p)`. fused=False
    keeps quantized weights off kernel K6 (the JAX package's use_pallas=
    False, which a mesh sets)."""
    if t_combined is None:
        t_combined = time_cond(p)
    if fused and fused_flow.supported(p):
        return fused_flow.flow_forward(p, c, x, t_combined)
    h = linear(p["input_proj"], x)
    y = t_combined + linear(p["cond_embed"], c)
    depth = next(iter(p["res_blocks"]["adaln"].values())).shape[0]
    for i in range(depth):
        h = res_block(slice_layer_params(p["res_blocks"], i), h, y)
    return final_layer(p["final"], h, y)


def sample_latent(p, c, noise, t_combined=None, fused: bool = True):
    """latent = noise + flow_net(c, s=0, t=1, noise)."""
    return noise + forward(p, c, noise, t_combined, fused)
