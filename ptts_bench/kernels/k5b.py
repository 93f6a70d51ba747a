"""K5b, `ops/fused_layer.post_attention`: out_proj, residual, norm2, the
MLP and its residual of a layer over all rows, the layer scales where the
layer has them (`fused_post_kernel`, or three `rows_mma_kernel` launches
over many rows). FLOPs 2 K N a row of each of the three linears; bytes:
their packed weights and scales, the norm and scales, x and attn in, x
out."""
from ._count import linear_shape, nbytes, rows_of, tree_bytes

ENTRY = ("pocket_tts_tpu_torch.ops.fused_layer", "post_attention")
LINEARS = ("out_proj", "linear1", "linear2")


def record(a: dict) -> dict:
    p, x = a["p"], a["x"]
    m = rows_of(x)
    fl = sum(2.0 * m * k * n for k, n in (linear_shape(p[name])
                                          for name in LINEARS))
    extra = sum(tree_bytes(p[k]) for k in ("norm2", "layer_scale_1",
                                           "layer_scale_2") if k in p)
    return {"flops": fl,
            "bytes": sum(tree_bytes(p[name]) for name in LINEARS) + extra
            + nbytes(x) * 2 + nbytes(a["attn"])}


def cost(r: dict) -> tuple:
    return r["flops"], r["bytes"]
