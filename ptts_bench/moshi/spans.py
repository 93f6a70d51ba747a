"""Device time of the kernels launched under the program's spans.

`with_spans(reduce)` wraps `trace.reduce`: the summary it returns gains
"span_device_s", {span name: device seconds of the kernels whose launch
sat inside that span} over the traced window, for Moshi's `ptt.temporal`,
`ptt.depth` and `ptt.mimi` (`utils.profiling.span` opens a profiler range
of its name while a profiler records; a frame replayed from CUDA graphs
opens them around its graph pieces, so each graph launch, and the kernels
it runs, lies under its span). The benchmark's probes are left out, as in
`trace.reduce`. A program without the spans gives zeros.
"""
from __future__ import annotations

import json

from .. import trace as tr

NAMES = ("ptt.temporal", "ptt.depth", "ptt.mimi")


def device_by_span(path: str, names=NAMES) -> dict:
    with open(path) as f:
        data = json.load(f)
    events = [e for e in data.get("traceEvents", []) if e.get("ph") == "X"]
    win = [e for e in events if e.get("name") == "bench::window"]
    if not win:
        return {n: 0.0 for n in names}
    w0, w1 = win[0]["ts"], win[0]["ts"] + win[0]["dur"]
    tid = win[0]["tid"]
    annots = [e for e in events if e.get("cat") == "user_annotation"
              and e.get("tid") == tid and w0 <= e["ts"] <= w1]
    launches = {}
    for e in events:
        if e.get("cat") in ("cuda_runtime", "cuda_driver"):
            c = (e.get("args") or {}).get("correlation")
            if c is not None:
                launches[c] = e
    kern = [e for e in events if e.get("cat") == "kernel"
            and e["ts"] < w1 and e["ts"] + e["dur"] > w0]
    found = [launches.get((e.get("args") or {}).get("correlation"))
             for e in kern]
    at = [x for x in found if x is not None and x.get("tid") == tid]
    stacks = dict(zip((id(x) for x in at),
                      tr.stacks_at(annots, [x["ts"] for x in at])))
    out = {n: 0.0 for n in names}
    for e, launch in zip(kern, found):
        st = stacks.get(id(launch), []) if launch is not None else []
        if "bench::probe" in st:
            continue
        for n in names:
            if n in st:
                out[n] += e["dur"] * 1e-6
    return out


def with_spans(reduce):
    def reduce_with_spans(path):
        out = reduce(path)
        out["span_device_s"] = device_by_span(path)
        return out
    return reduce_with_spans
