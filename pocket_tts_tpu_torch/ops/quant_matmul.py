"""K4a: x @ int8 weight with per-output-channel scales.

Replaces the TPU kernel `pocket_tts_tpu/ops/quant_matmul.py:
int8_matmul_pallas`. The CUDA kernel is `csrc/int8_matmul.cu` (its header
says what bounds it on the H100 and what the design does about it); the
plain version is the JAX package's off-TPU math (`_core`, bits 8).

Layout (io/quant.py): q (K, N) int8, scale (N,) float32. A layer of a
stacked (L, K, N) weight is `q[l]`, a contiguous view.

`int8_matmul` runs the plain version for tensors on the CPU and the kernel
for tensors on the card; there is no other switch.
"""
from __future__ import annotations

import torch

from . import cuda_lib


def int8_matmul_plain(x, q, scale):
    """x (..., K) @ (q (K, N) widened to x's type) accumulated in float32,
    times scale, rounded to x's type. x and q widen to float32 exactly
    (bf16 values and |q| <= 127), so the float32 product is the f32-
    accumulated product of the working-type operands."""
    y = (x.reshape(-1, x.shape[-1]).float() @ q.float()) * scale
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
        raise ValueError(
            "int8_matmul: bad operands "
            + ", ".join(f"{name}{tuple(t.shape)} {t.dtype} {t.device} "
                        f"contiguous={t.is_contiguous()}"
                        for name, t in (("x", x), ("q", q),
                                        ("scale", scale))))
    y = torch.empty(x2.shape[0], n, dtype=x.dtype, device=x.device)
    rc = cuda_lib.library().ptt_int8_matmul(
        x2.data_ptr(), q.data_ptr(), scale.data_ptr(), y.data_ptr(),
        x2.shape[0], k, n, cuda_lib.dtype_code(x), cuda_lib.stream_ptr(
            x.device))
    cuda_lib.check(rc, "ptt_int8_matmul")
    int8_matmul.launches += 1
    return y.reshape(*x.shape[:-1], n)


int8_matmul.launches = 0
