"""K7, `ops/insert_attn.decode_insert_attention`: one decode step's KV row
insert and attention over every lane's cache (`insert_attn_kernel`).

Needs: the slots that hold a position (pos >= 0) among those the call reads,
K and V rows and their scales; every slot's position; q, the new rows and
the output; the statistics when asked. FLOPs: 4 D per head and valid slot
(q.k and p.v)."""
from ._count import nbytes

ENTRY = ("pocket_tts_tpu_torch.ops.insert_attn", "decode_insert_attention")


def record(a: dict) -> dict:
    q, kc, pos = a["q"], a["k_cache"], a["pos"]
    b, h, d = q.shape
    read = a["read_end"] + 1
    return {"valid": (pos[:, :read] >= 0).sum(), "b": b, "h": h, "d": d,
            "read": read, "row": kc.shape[-1] * kc.element_size(),
            "scaled": a["k_scale"] is not None, "stats": a["stats"],
            "io": nbytes(q) * 2 + nbytes(a["k_new"]) + nbytes(a["v_new"])
            + nbytes(a["cur_pos"])}


def cost(r: dict) -> tuple:
    valid = int(r["valid"])
    by = (2 * valid * (r["row"] + (4 if r["scaled"] else 0))
          + r["b"] * r["read"] * 4 + r["io"]
          + (r["b"] * r["h"] * 8 if r["stats"] else 0))
    return 4.0 * valid * r["h"] * r["d"], by
