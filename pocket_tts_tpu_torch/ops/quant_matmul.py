"""K4a and K4b: x @ a quantized weight (int8, or packed int4).

K4a replaces the TPU kernel `pocket_tts_tpu/ops/quant_matmul.py:
int8_matmul_pallas`, K4b `int4_matmul_pallas` (`_int4_kernel`,
`_int4_grouped_kernel`). K4a's CUDA kernel is `csrc/int8_matmul.cu`. K4b
is the row-block product of the fused layer (csrc/fused_layer.cu) with
the plain load prologue and the rounding epilogue, on its route
(`fused_layer.rows_route`): `rows_mma_kernel` on the tensor cores for
bf16 calls of MMA_ROWS (16) rows or more (every prefill, the serving
mode's input_linear over its lanes), `skinny_kernel` below (input_linear
once a frame: T = 1, K = 32), `rows_kernel` for float32 (fused_layer.cu's
header says what bounds them on the H100 and what the designs do about
it). The plain versions are the JAX package's off-TPU math (`_core`),
with grouped int4 scales applied in float32.

Layouts (io/quant.py), one layer of a stacked (L, ...) weight being `q[l]`,
a contiguous view:
  int8  q (K, N) int8, scale (N,) float32 per output channel
  int4  q4 (K/2, N) int8, packed halves: byte = 16*hi + (lo + 8), packed
        row r holds logical row r in the low nibble (biased) and logical
        row r + K/2 in the high nibble (signed); scale (N,) float32 per
        output channel, or K-grouped (K/group, N) bfloat16 (q4_0, group
        32), whose row g covers logical rows [g*group, (g+1)*group)

`int8_matmul` and `int4_matmul` run the plain version for tensors on the
CPU and the kernel for tensors on the card; there is no other switch.
`kernel_operands` is the layout check the fused kernels (K5a, K5b, K6)
share.
"""
from __future__ import annotations

import numpy as np
import torch

from . import cuda_lib

# weight kinds of a linear as the fused CUDA kernels take them (csrc/qdot.cuh)
PLAIN, INT8, INT4, INT4_GROUPED = range(4)


def pack_int4(q: np.ndarray) -> np.ndarray:
    """q (..., K, N) integers in [-8, 7] -> packed (..., K/2, N) int8:
    byte = 16*hi + (lo + 8), lo = logical row r, hi = row r + K/2."""
    k = q.shape[-2]
    if k % 2:
        raise ValueError(f"int4 packing needs an even K, not {k}")
    q16 = q.astype(np.int16)
    lo, hi = q16[..., : k // 2, :] + 8, q16[..., k // 2:, :]
    return (16 * hi + lo).astype(np.int8)


def unpack_int4(q4, dtype=torch.float32):
    """packed (..., K/2, N) int8 -> (..., K, N) values in [-8, 7]."""
    b = q4.to(torch.int16)
    return torch.cat([(b & 0xF) - 8, b >> 4], dim=-2).to(dtype)


def grouped(lin) -> bool:
    """True when an int4 linear carries K-grouped (q4_0) scales."""
    return "q4" in lin and lin["scale"].dim() == lin["q4"].dim()


def deq_dot(x, lin):
    """float32 x @ W for a linear {"w"}, {"q", "scale"} or {"q4",
    "scale"} (one layer), without the bias: per-channel scales multiply
    the float32 product, grouped scales the (exact) float32 weight."""
    x32 = x.float()
    if "w" in lin:
        return x32 @ lin["w"].float()
    if "q" in lin:
        return (x32 @ lin["q"].float()) * lin["scale"]
    w = unpack_int4(lin["q4"])
    if grouped(lin):
        s = lin["scale"].float()
        return x32 @ (w * s.repeat_interleave(w.shape[-2] // s.shape[-2],
                                              dim=-2))
    return (x32 @ w) * lin["scale"]


def _bad(name, **tensors):
    return ValueError(
        f"{name}: bad operands " + ", ".join(
            f"{k}{tuple(t.shape)} {t.dtype} {t.device} "
            f"contiguous={t.is_contiguous()}" for k, t in tensors.items()))


def int8_matmul_plain(x, q, scale):
    """x (..., K) @ (q (K, N) widened to x's type) accumulated in float32,
    times scale, rounded to x's type. x and q widen to float32 exactly
    (bf16 values and |q| <= 127), so the float32 product is the f32-
    accumulated product of the working-type operands."""
    y = deq_dot(x.reshape(-1, x.shape[-1]), {"q": q, "scale": scale})
    return y.to(x.dtype).reshape(*x.shape[:-1], q.shape[-1])


def int8_matmul(x, q, scale):
    """Same contract as int8_matmul_plain; launches the CUDA kernel for
    CUDA tensors (x float32 or bfloat16)."""
    if x.device.type == "cpu":
        return int8_matmul_plain(x, q, scale)
    if x.device.type != "cuda":
        raise ValueError(f"int8_matmul: unsupported device {x.device}")
    k, n = q.shape
    x2 = x.reshape(-1, x.shape[-1])
    if not (x2.shape[1] == k and q.dtype == torch.int8
            and scale.dtype == torch.float32 and scale.shape == (n,)
            and all(t.is_contiguous() and t.device == x.device
                    for t in (x2, q, scale))):
        raise _bad("int8_matmul", x=x, q=q, scale=scale)
    y = torch.empty(x2.shape[0], n, dtype=x.dtype, device=x.device)
    rc = cuda_lib.library().ptt_int8_matmul(
        x2.data_ptr(), q.data_ptr(), scale.data_ptr(), y.data_ptr(),
        x2.shape[0], k, n, cuda_lib.dtype_code(x), cuda_lib.stream_ptr(
            x.device))
    cuda_lib.check(rc, "ptt_int8_matmul")
    int8_matmul.launches += 1
    return y.reshape(*x.shape[:-1], n)


def int4_matmul_plain(x, q4, scale):
    """x (..., K) @ dequant(q4 (K/2, N)) accumulated in float32, with
    per-channel scale (N,) applied to the product or grouped scale
    (K/group, N) to the weight (nibble x bf16 scale is exact in float32),
    rounded once to x's type."""
    y = deq_dot(x.reshape(-1, x.shape[-1]), {"q4": q4, "scale": scale})
    return y.to(x.dtype).reshape(*x.shape[:-1], q4.shape[-1])


def int4_matmul(x, q4, scale):
    """Same contract as int4_matmul_plain; for CUDA tensors (x float32 or
    bfloat16, `kernel_operands`' layouts) launches the row-block product
    of x's route once (`fused_layer.rows_launch`), counted here only."""
    if x.device.type == "cpu":
        return int4_matmul_plain(x, q4, scale)
    if x.device.type != "cuda":
        raise ValueError(f"int4_matmul: unsupported device {x.device}")
    from .fused_layer import EPI_ROUND, ROWS_LOAD, rows_launch
    kh, n = q4.shape
    x2 = x.reshape(-1, x.shape[-1])
    if not (x2.shape[1] == 2 * kh and x2.shape[0] >= 1
            and x2.is_contiguous()
            and x.dtype in (torch.float32, torch.bfloat16)):
        raise _bad("int4_matmul", x=x, q4=q4, scale=scale)
    lin, layout = kernel_operands({"q4": q4, "scale": scale}, 2 * kh, n, x)
    y = torch.empty(x2.shape[0], n, dtype=x.dtype, device=x.device)
    rows_launch(cuda_lib.library(), x.dtype, x2, (None, None), lin, layout,
                None, None, y, x2.shape[0], 2 * kh, n, ROWS_LOAD, EPI_ROUND,
                False, 0.0, cuda_lib.stream_ptr(x.device))
    int4_matmul.launches += 1
    return y.reshape(*x.shape[:-1], n)


int8_matmul.launches = 0
int4_matmul.launches = 0


def bits(lin) -> int:
    """8 or 4 for a quantized linear, 16 for a plain one, 0 otherwise (the
    JAX package's `fused_layer._qw` classes)."""
    for key, b in (("q", 8), ("q4", 4), ("w", 16)):
        if key in lin:
            return b
    return 0


def kernel_operands(lin, k: int, n: int, x, layers=None):
    """[w, scale, bias] and [kind, group] of a linear of logical shape
    (k, n) (stacked over `layers` when given) for the fused kernels, after
    checking what they read: shapes, dtypes, contiguity, x's device, N a
    multiple of 4, and the alignment of 4-column loads. A missing scale or
    bias is None. Raises ValueError on anything else."""
    pre = () if layers is None else (layers,)
    b = lin.get("b")
    items = [(b, pre + (n,), x.dtype, 1)]
    layout_ok = n % 4 == 0
    if "q" in lin:
        w, s, kind, group = lin["q"], lin["scale"], INT8, 0
        items += [(w, pre + (k, n), torch.int8, 4),
                  (s, pre + (n,), torch.float32, 1)]
    elif "q4" in lin:
        w, s = lin["q4"], lin["scale"]
        items.append((w, pre + (k // 2, n), torch.int8, 4))
        layout_ok = layout_ok and k % 2 == 0
        if grouped(lin):
            ng = s.shape[-2]
            kind, group = INT4_GROUPED, k // max(ng, 1)
            items.append((s, pre + (ng, n), torch.bfloat16, 8))
            # whole groups in each half of K (io/quant.py's rule)
            layout_ok = layout_ok and ng * group == k and (k // 2) % group == 0
        else:
            kind, group = INT4, 0
            items.append((s, pre + (n,), torch.float32, 1))
    elif "w" in lin:
        w, s, kind, group = lin["w"], None, PLAIN, 0
        items.append((w, pre + (k, n), x.dtype, 4 * x.element_size()))
    else:
        raise ValueError(f"not a linear: {sorted(lin)}")
    bad = [(tuple(t.shape), t.dtype) for t, shape, dtype, align in items
           if t is not None and not (
               tuple(t.shape) == shape and t.dtype == dtype
               and t.is_contiguous() and t.device == x.device
               and t.data_ptr() % align == 0)]
    if bad or not layout_ok:
        raise ValueError(f"linear ({k}, {n}): bad operands {bad}")
    return [w, s, b], [kind, group]
