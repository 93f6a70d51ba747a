"""K6, `ops/fused_flow.flow_forward`: the whole quantized flow net over the
lanes' rows (`flow_mods_kernel`, `flow_chain_kernel`). FLOPs 2 K N a row
of each linear it runs (input_proj, cond_embed, each block's adaLN and two
MLP linears, the final adaLN and linear); bytes: those weights and scales,
the conditioning, noise and time rows in, the latents out."""
from ._count import linear_shape, nbytes, rows_of, tree_bytes

ENTRY = ("pocket_tts_tpu_torch.ops.fused_flow", "flow_forward")


def _linears(p):
    yield p["input_proj"]
    yield p["cond_embed"]
    for key in ("adaln", "mlp_0", "mlp_2"):
        yield p["res_blocks"][key]
    yield p["final"]["adaln"]
    yield p["final"]["linear"]


def record(a: dict) -> dict:
    p, x = a["p"], a["x"]
    m = rows_of(x)
    depth = 1
    fl = 0.0
    for lin in _linears(p):
        k, n = linear_shape(lin)
        w = lin.get("q4", lin.get("q", lin.get("w")))
        depth = w.shape[0] if w.dim() == 3 else 1
        fl += 2.0 * m * k * n * depth
    by = sum(tree_bytes(lin) for lin in _linears(p))
    by += tree_bytes(p["res_blocks"].get("in_ln", {}))
    return {"flops": fl,
            "bytes": by + nbytes(a["c"]) + nbytes(x) * 2
            + nbytes(a["t_combined"])}


def cost(r: dict) -> tuple:
    return r["flops"], r["bytes"]
