"""The model's operations, counted from a configuration's shapes.

A decoded frame of one stream: 2 K N for each linear it runs (the backbone's
four a layer, the input linear and EOS head, the flow net, the Mimi
quantizer projection and transformer over its 16 rows), 4 D a head for
each key the backbone and the Mimi transformer attend to, and the SEANet
decoder's convs (2 Cin Cout K an output row). A prefill row: the
backbone's linears and its attention. The same arithmetic as the port's
utils/roofline.py, taken per lane and per frame.
"""
from __future__ import annotations


def _backbone_linears(m: dict) -> float:
    bb = m["backbone"]
    d = bb["d_model"]
    h = d * bb["hidden_scale"]
    return bb["num_layers"] * (3 * d * d + d * d + 2 * d * h)


def _flow_linears(m: dict) -> float:
    fl, d, lat = m["flow"], m["backbone"]["d_model"], m["latent_dim"]
    fd, fh = fl["dim"], fl["mlp_hidden"]
    return (lat * fd + d * fd + fl["depth"] * (3 * fd * fd + 2 * fd * fh)
            + 2 * fd * fd + fd * lat)


def _mimi(m: dict, index: int) -> float:
    mi = m["mimi"]
    tr, md = mi["transformer"], mi["dim"]
    rows = mi["upsample_stride"]
    lin = tr["num_layers"] * (4 * md * md + 2 * md * tr["hidden_dim"])
    keys = sum(min(index * rows + i + 1, tr["context"]) for i in range(rows))
    fl = (2.0 * rows * lin + 4.0 * md * keys * tr["num_layers"]
          + 2.0 * m["latent_dim"] * md)
    sc = mi["seanet"]
    return fl + seanet(rows, sc["in_ch"], sc["first_kernel"],
                       [(st["in_ch"], st["out_ch"], st["kernel"],
                         st["stride"]) for st in sc["stages"]],
                       sc["resnet_kernel"], sc["last_kernel"], sc["out_ch"])


def seanet(rows, in_ch, first_kernel, stages, resnet_kernel, last_kernel,
           out_ch) -> float:
    """The SEANet decoder's convs over `rows` input rows: 2 Cin Cout K an
    output row (a transposed conv's: an input row), each stage's resnet
    (k then 1x1, channels halved between) at the stage's output rate.
    stages: [(in_ch, out_ch, kernel, stride)]."""
    fl = 2.0 * rows * in_ch * in_ch * first_kernel
    r = rows
    for cin, cout, k, stride in stages:
        fl += 2.0 * r * cin * cout * k
        r *= stride
        fl += 2.0 * r * (cout * (cout // 2) * resnet_kernel
                         + (cout // 2) * cout)
    return fl + 2.0 * r * stages[-1][1] * out_ch * last_kernel


def frame(m: dict, context: int, index: int) -> float:
    """Frame `index` of one stream, whose backbone attends to `context`
    keys."""
    bb = m["backbone"]
    d = bb["d_model"]
    return (2.0 * (_backbone_linears(m) + m["latent_dim"] * d + d
                   + _flow_linears(m))
            + 4.0 * d * context * bb["num_layers"] + _mimi(m, index))


def prefill_row(m: dict, context: int) -> float:
    """One prompt or text row whose attention sees `context` keys."""
    bb = m["backbone"]
    return (2.0 * _backbone_linears(m)
            + 4.0 * bb["d_model"] * context * bb["num_layers"])
