"""Moshi's operations, counted from a configuration's shapes.

An emitted frame of one call at its step t (t >= 1; step 0 emits
nothing; a call resumed at step a emits from a on): 2 K N for each
linear it runs (the temporal transformer's four a layer and the text
head; each depth sub-step's input projection, its layers' four and its
head), 4 D for each key a query attends to (the
temporal transformer's min(t + 1, context) a layer, the depth
transformer's k + 1 at sub-step k), and Mimi's decode of the frame: the
RVQ's two projections, its transformer over its rows (`upsample_stride`
a frame, window `context`), and SEANet's convs (2 Cin Cout K an output
row; its first conv from `in_ch` to the first stage's `in_ch`).
"""
from __future__ import annotations


def _layer(d: int, hidden: int) -> float:
    """Weights of a pre-norm SwiGLU layer: in_proj, out_proj, linear_in,
    linear_out."""
    return 4 * d * d + 3 * d * hidden


def temporal(m: dict, t: int) -> float:
    d, layers = m["d_model"], m["num_layers"]
    keys = min(t + 1, m["context"])
    return (2.0 * (layers * _layer(d, m["hidden"]) + d * m["text_card"])
            + 4.0 * d * keys * layers)


def depth(m: dict) -> float:
    dp, d = m["depth"], m["d_model"]
    dd, n = dp["d_model"], dp["steps"]
    fl = 0.0
    for k in range(n):
        fl += 2.0 * (d * dd + dp["num_layers"] * _layer(dd, dp["hidden"])
                     + dd * m["card"])
        fl += 4.0 * dd * (k + 1) * dp["num_layers"]
    return fl


def seanet(rows: int, sc: dict) -> float:
    """SEANet's convs over `rows` input rows."""
    st0 = sc["stages"][0]
    fl = 2.0 * rows * sc["in_ch"] * st0["in_ch"] * sc["first_kernel"]
    r = rows
    for st in sc["stages"]:
        fl += 2.0 * r * st["in_ch"] * st["out_ch"] * st["kernel"]
        r *= st["stride"]
        half = st["out_ch"] // 2
        fl += 2.0 * r * (st["out_ch"] * half * sc["resnet_kernel"]
                         + half * st["out_ch"])
    return fl + 2.0 * r * sc["stages"][-1]["out_ch"] * sc["out_ch"] \
        * sc["last_kernel"]


def mimi(m: dict, f: int) -> float:
    """Decoding frame f of a call."""
    mi, rvq = m["mimi"], m["rvq"]
    tr, md = mi["transformer"], mi["dim"]
    rows = mi["upsample_stride"]
    keys = sum(min(f * rows + i + 1, tr["context"]) for i in range(rows))
    return (2.0 * 2 * rvq["dim"] * md
            + 2.0 * rows * tr["num_layers"] * (4 * md * md
                                               + 2 * md * tr["hidden_dim"])
            + 4.0 * md * keys * tr["num_layers"]
            + seanet(rows, mi["seanet"]))


def frame(m: dict, t: int, f: int = None) -> float:
    """Step t of a call, which emits its frame t - 1; f: that frame's
    index in its Mimi stream (t - 1, or t - a for a call resumed at
    step a, whose Mimi starts at its frame a - 1)."""
    return temporal(m, t) + depth(m) + mimi(m, t - 1 if f is None else f)
