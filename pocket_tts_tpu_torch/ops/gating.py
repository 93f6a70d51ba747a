"""Activation gating (SwiGLU) and weights-per-step modules.

Counterpart of `pocket_tts_tpu/ops/gating.py`: the moshi gating and
multi-linear modules that a checkpoint switches on by shipping their
weights (the shipped pocket-tts checkpoints carry none).

Layouts:
  gating:  {"linear_in": {w (d, 2h), b?}, "linear_out": {w (h, d), b?}}
  per-step linear: {"w": (M, in, out), "b"?: (M, out)}, a stacked module
  list, with a `schedule` tuple mapping timestep -> module index
  (None: module t + offset)
Quantized layouts ({"q"/"q4", "scale"} from io/quant.py) are taken too.
A 2-D weight, or a stack of one module, goes through ops.basic.linear,
so quantized weights run kernels K4a / K4b; with M > 1 modules each row's
module is gathered and the product is one float32 einsum, quantized
stacks dequantized inline, all plain PyTorch (the JAX package computes
this path in XLA).
"""
from __future__ import annotations

import torch

from .basic import linear, silu
from .quant_matmul import unpack_int4


def activation_gating(p, x, dtype=None):
    """linear_out(silu(left) * right), left/right the feature halves of
    linear_in(x); with dtype (Moshi's float32) the product is computed in
    it and rounded once to x's type."""
    h = linear(p["linear_in"], x)
    if dtype is not None:
        h = h.to(dtype)
    half = h.shape[-1] // 2
    g = silu(h[..., :half]) * h[..., half:]
    return linear(p["linear_out"], g if dtype is None else g.to(x.dtype))


def _weight_stack(p):
    """The module's weight-carrying leaf: "w", "q" or "q4"."""
    return p["w"] if "w" in p else (p["q"] if "q" in p else p["q4"])


def _squeeze_module(p):
    """Drop a leading unit stack axis from every stacked leaf, so an
    M == 1 module feeds ops.basic.linear."""
    stacked_ndim = {"w": 3, "q": 3, "q4": 3, "scale": 2, "b": 2}
    return {k: (v[0] if stacked_ndim.get(k) == v.dim() else v)
            for k, v in p.items() if v is not None}


def _dequant_stack(p):
    """A quantized stacked weight (M, in, out) in float32."""
    if "q" in p:
        return p["q"].float() * p["scale"][..., None, :]
    return unpack_int4(p["q4"]) * p["scale"][..., None, :]


def _step_indices(m: int, schedule, t: int, offset: int, device):
    """Module index per timestep: schedule[t + offset] or t + offset,
    clamped into range."""
    steps = offset + torch.arange(t, dtype=torch.int64, device=device)
    if schedule is not None:
        table = torch.as_tensor(schedule, dtype=torch.int64, device=device)
        return table[steps.clamp(0, table.shape[0] - 1)]
    return steps.clamp(0, m - 1)


def weights_per_step_linear(p, x, offset: int = 0, schedule=None):
    """Row t of x (..., T, in) uses module schedule[t + offset] (the
    leading axes, lanes, share the steps). M == 1 (or a 2-D weight) is a
    shared linear."""
    wk = _weight_stack(p)
    if wk.dim() == 2 or wk.shape[0] == 1:
        return linear(_squeeze_module(p), x)
    w = p["w"] if "w" in p else _dequant_stack(p)
    # offset: an int, or a (1,) device tensor (a lane batch's ring cursor)
    idx = _step_indices(w.shape[0], schedule, x.shape[-2],
                        offset if isinstance(offset, torch.Tensor)
                        else int(offset), x.device)
    wt = w[idx].to(x.dtype)                              # (T, in, out)
    y = torch.einsum("...tc,tco->...to", x.float(), wt.float()).to(x.dtype)
    b = p.get("b")
    if b is not None:
        y = y + b[idx]
    return y


def weights_per_step_gating(p, x, offset: int = 0, schedule=None):
    """Per-timestep activation gating: p {"linear_in": {"w": (M, d, 2h)},
    "linear_out": {"w": (M, h, d)}}; M == 1 (or 2-D weights) is the
    shared gating."""
    w_in = _weight_stack(p["linear_in"])
    if w_in.dim() == 2 or w_in.shape[0] == 1:
        return activation_gating(
            {"linear_in": _squeeze_module(p["linear_in"]),
             "linear_out": _squeeze_module(p["linear_out"])}, x)
    h = weights_per_step_linear(p["linear_in"], x, offset, schedule)
    half = h.shape[-1] // 2
    gated = silu(h[..., :half]) * h[..., half:]
    return weights_per_step_linear(p["linear_out"], gated, offset, schedule)
