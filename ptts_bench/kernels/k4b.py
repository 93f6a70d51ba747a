"""K4b, `ops/quant_matmul.int4_matmul`: x @ an int4 weight with its scales
over all rows (`skinny_kernel`, `rows_mma_kernel`, `rows_kernel`). FLOPs
2 K N a row; bytes: the packed weight and scales, x in, y out."""
from ._count import nbytes, rows_of

ENTRY = ("pocket_tts_tpu_torch.ops.quant_matmul", "int4_matmul")


def record(a: dict) -> dict:
    x, q4, scale = a["x"], a["q4"], a["scale"]
    k, n = 2 * q4.shape[-2], q4.shape[-1]
    m = rows_of(x)
    return {"flops": 2.0 * m * k * n,
            "bytes": nbytes(q4) + nbytes(scale) + nbytes(x)
            + m * n * x.element_size()}


def cost(r: dict) -> tuple:
    return r["flops"], r["bytes"]
