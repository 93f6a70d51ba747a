"""K3, `ops/seanet_frame.seanet_frame`: the SEANet decoder over every lane's
frame (`seanet_gemm_kernel`, `seanet_overlap_kernel`,
`seanet_last_kernel`: 14 launches).

FLOPs: `model_flops.seanet`. Needs: the weights as the kernels read them
(`prep_weights`), the input rows, every carry read and written, the PCM
out."""
from ..model_flops import seanet
from ._count import nbytes, tree_bytes

ENTRY = ("pocket_tts_tpu_torch.ops.seanet_frame", "seanet_frame")


def record(a: dict) -> dict:
    cfg, x = a["cfg"], a["x"]
    rows = x.numel() // x.shape[-1]          # lanes x input rows
    fl = seanet(rows, cfg.in_ch, cfg.first_kernel,
                [(st.in_ch, st.out_ch, st.kernel, st.stride)
                 for st in cfg.stages], cfg.resnet_kernel, cfg.last_kernel,
                cfg.out_ch)
    r = rows * cfg.total_stride
    w = a["weights"] if a["weights"] is not None else a["p"]
    return {"flops": fl,
            "bytes": tree_bytes(w) + nbytes(x) + 2 * tree_bytes(a["state"])
            + r * cfg.out_ch * x.element_size()}


def cost(r: dict) -> tuple:
    return r["flops"], r["bytes"]
