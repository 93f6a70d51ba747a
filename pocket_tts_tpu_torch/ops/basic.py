"""Elementary ops: linear layers, norms, activations.

Counterpart of `pocket_tts_tpu/ops/basic.py`. Parameters are dicts:
  linear: {"w": (in, out), "b": (out,) optional}, int8-quantized
          {"q": (in, out) int8, "scale": (out,) float32, "b" optional} or
          int4-quantized {"q4": (in/2, out) int8 packed, "scale": (out,)
          float32 or (in/32, out) bfloat16, "b" optional}
  norm:   {"scale": (d,), "bias": (d,) optional}, or {"alpha": (d,)} for
          the RMSNorm of a checkpoint that ships `norm*.alpha`
Norms compute in float32 and round once to the input dtype, as the JAX
package does.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .quant_matmul import int4_matmul, int8_matmul


def linear(p, x):
    """y = x @ w + b, accumulated in f32 and rounded once to x's dtype
    (addmm adds the bias in the matmul's f32 epilogue). An int8 linear goes
    through kernel K4a (ops/quant_matmul.int8_matmul), an int4 one through
    K4b (int4_matmul); both keep the JAX package's rounding order: the
    scaled product is rounded to x's dtype, then the bias is added in that
    dtype."""
    b = p.get("b")
    if "q" in p or "q4" in p:
        y = (int8_matmul(x, p["q"], p["scale"]) if "q" in p
             else int4_matmul(x, p["q4"], p["scale"]))
        return y if b is None else (y + b).to(x.dtype)
    w = p["w"]
    shape = x.shape
    x2 = x.reshape(-1, shape[-1])
    y = x2 @ w if b is None else torch.addmm(b, x2, w)
    return y.reshape(*shape[:-1], w.shape[-1])


def slice_layer_params(p_layers, l: int) -> dict:
    """Per-layer view of stacked (L, ...) module params."""
    return {k: (slice_layer_params(v, l) if isinstance(v, dict) else v[l])
            for k, v in p_layers.items()}


def layer_norm(p, x, eps: float = 1e-5):
    """LayerNorm over the last axis: mean/var with divisor n, eps inside the
    sqrt. eps may be 0 (the mimi decoder transformer)."""
    x32 = x.float()
    mean = x32.mean(-1, keepdim=True)
    xc = x32 - mean
    var = (xc * xc).mean(-1, keepdim=True)
    y = xc * torch.rsqrt(var + eps)
    if p is not None:
        scale = p.get("scale")
        if scale is not None:
            y = y * scale.float()
        bias = p.get("bias")
        if bias is not None:
            y = y + bias.float()
    return y.to(x.dtype)


def rms_norm(p, x, eps: float = 1e-8):
    """RMSNorm: x times rsqrt(mean(x^2) + eps), times alpha, in float32
    and rounded once to x's dtype. eps 1e-8 is moshi's default and the
    JAX package's (the mimi layers call it with that default)."""
    x32 = x.float()
    y = x32 * torch.rsqrt((x32 * x32).mean(-1, keepdim=True) + eps)
    return (y * p["alpha"].float()).to(x.dtype)


def quantize_rows(x, amax=None):
    """(..., H*D) -> (int8 rows, (...,) float32 absmax scales): the JAX
    package's `models.backbone.quantize_rows`, bit for bit (the int8 KV
    caches of the backbone and of the mimi ring). amax: the rows' (...,)
    absmax when x holds only some columns of each row (a head shard on a
    mesh: parallel.sharding.reduce_absmax), else taken from x."""
    x32 = x.float()
    if amax is None:
        amax = x32.abs().amax(-1)
    s = (amax / 127.0).clamp_min(1e-12)
    q = torch.clamp(torch.round(x32 / s[..., None]), -127, 127)
    return q.to(torch.int8), s


def mlp_std_norm(p, x, eps: float = 1e-5):
    """The flow net's "RMSNorm": x (not centred) divided by the
    (n-1)-divisor standard deviation of x, times alpha."""
    x32 = x.float()
    n = x32.shape[-1]
    xc = x32 - x32.mean(-1, keepdim=True)
    var = (xc * xc).sum(-1, keepdim=True) / (n - 1)
    y = x32 * torch.rsqrt(var + eps)
    return (y * p["alpha"].float()).to(x.dtype)


def gelu(x, approx: bool = False):
    """GELU: erf (the default) or the tanh approximation."""
    return F.gelu(x, approximate="tanh" if approx else "none")


def elu(x):
    """ELU(alpha=1)."""
    return torch.where(x > 0, x, torch.expm1(torch.clamp(x, max=0.0)))


def silu(x):
    return F.silu(x)


def modulate(x, shift, scale):
    """adaLN modulation: x * (1 + scale) + shift."""
    return x * (1.0 + scale) + shift


def inv_sqrt(d: int) -> float:
    """1/sqrt(d) rounded to float32, the attention scale of both packages."""
    return float(1.0 / torch.sqrt(torch.tensor(float(d), dtype=torch.float32)))


def log32(x: float) -> float:
    """log(x) rounded to float32, as jnp.log computes it."""
    return float(torch.log(torch.tensor(float(x), dtype=torch.float32)))

