"""K5a, `ops/fused_layer.pre_attention`: norm1 and the quantized in_proj of
a layer over all rows (`skinny_kernel`, `rows_mma_kernel`). FLOPs 2 K N a
row; bytes: the packed weight, its scales and the norm, the rows in, the
q/k/v rows out."""
from ._count import linear_shape, nbytes, rows_of, tree_bytes

ENTRY = ("pocket_tts_tpu_torch.ops.fused_layer", "pre_attention")


def record(a: dict) -> dict:
    p, x = a["p"], a["x"]
    k, n = linear_shape(p["in_proj"])
    m = rows_of(x)
    return {"flops": 2.0 * m * k * n,
            "bytes": tree_bytes(p["in_proj"]) + tree_bytes(p["norm1"])
            + nbytes(x) + m * n * x.element_size()}


def cost(r: dict) -> tuple:
    return r["flops"], r["bytes"]
