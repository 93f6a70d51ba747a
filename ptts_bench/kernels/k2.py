"""K2, `ops/ring_attn.ring_insert_attention`: the Mimi transformer's ring
insert and attention over every lane (`ring_attn_kernel`).

A query at step offset + i of a lane that started at `start` sees the keys
from max(start, offset + i - context + 1, offset + T - cap) to offset + i.
Needs: the ring rows some query sees (K and V, and their scales), the T new
rows, q and the output. FLOPs: 4 D per head and visible key."""
import torch

from ._count import nbytes

ENTRY = ("pocket_tts_tpu_torch.ops.ring_attn", "ring_insert_attention")


def record(a: dict) -> dict:
    q, kc = a["q"], a["k_cache"]
    off, ctx = int(a["offset"]), int(a["context"])
    t = q.shape[-2]
    cap = kc.shape[-2]
    start = torch.as_tensor(a["start"], device=q.device).reshape(-1, 1)
    i = torch.arange(t, device=q.device)[None]
    lo = torch.maximum(torch.maximum(start, off + i - ctx + 1),
                       torch.full_like(i, off + t - cap))
    seen = (off + i - lo + 1).clamp_min(0)
    rows = (off + t - lo[:, :1]).clamp(0, cap)
    return {"seen": seen.sum(), "rows": rows.sum(), "h": a["num_heads"],
            "d": q.shape[-1] // a["num_heads"],
            "row": kc.shape[-1] * kc.element_size(),
            "scaled": a["k_scale"] is not None,
            "io": nbytes(q) * 2 + nbytes(a["k_new"]) + nbytes(a["v_new"])}


def cost(r: dict) -> tuple:
    rows = int(r["rows"])
    by = 2 * rows * (r["row"] + (4 if r["scaled"] else 0)) + r["io"]
    return 4.0 * int(r["seen"]) * r["h"] * r["d"], by
