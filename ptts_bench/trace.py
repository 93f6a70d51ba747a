"""Reduce a torch.profiler chrome trace to what the per-layer readers use.

The trace covers the `bench::window` range: the profiled chunks. Device
events are kernels, memcpys and memsets. Each kernel is tied to its launch
on the host through its correlation id, and so to the innermost
`kernel::<name>#<i>` range around the launch (the hand-written kernel call
`i`, `serve.KernelCalls`) and to whether the launch sat inside a
`bench::probe` range (the benchmark's own copies and counts: left out of
every figure). Returns:

- window_s: the window's length; busy_s: the union of device events in it
  (probes left out);
- kernels: kernel launches in the window (probes left out);
- calls: {call index: [device seconds of its hand-written kernels]};
- device_ops: the 10 kernel names that took the most device time;
- idle_gaps: the 10 longest gaps with no device event, each named by the
  benchmark's ranges the host thread was inside at the gap's middle
  (`bench::step > server::admit`, `... > batched::continuous_decode_chunk
  > tts::frame`; a bare `bench::step` is the step's host read and
  bookkeeping after its chunk);
- correlated: the share of kernels whose launch was found.
"""
from __future__ import annotations

import json
import re
from collections import defaultdict

# kernels the port writes by hand (the `__global__` functions of
# pocket_tts_tpu_torch/csrc): a kernel whose name holds one of these is
# the call's own; PyTorch's kernels inside a call are not
HAND_WRITTEN = ("decode_attn_kernel", "insert_attn_kernel",
                "ring_attn_kernel", "seanet_gemm_kernel",
                "seanet_overlap_kernel", "seanet_last_kernel",
                "rows_kernel", "rows_mma_kernel", "skinny_kernel",
                "wgmma_int8_kernel", "fused_post_kernel", "bilayer_kernel",
                "megalayer_kernel", "flow_mods_kernel", "flow_chain_kernel")
_HAND = re.compile("|".join(rf"\b{n}\b" for n in HAND_WRITTEN))
DEVICE_CATS = {"kernel", "gpu_memcpy", "gpu_memset"}


def hand_written(name: str) -> bool:
    return bool(_HAND.search(name))


def _union(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def stacks_at(ranges, times):
    """For each time, the names of the host ranges containing it, outermost
    first: one sweep over ranges that nest (one thread's)."""
    evs = sorted(ranges, key=lambda e: (e["ts"], -e["dur"]))
    out = [None] * len(times)
    stack, j = [], 0
    for i in sorted(range(len(times)), key=times.__getitem__):
        t = times[i]
        while j < len(evs) and evs[j]["ts"] <= t:
            e = evs[j]
            j += 1
            while stack and stack[-1]["ts"] + stack[-1]["dur"] < e["ts"]:
                stack.pop()
            stack.append(e)
        while stack and stack[-1]["ts"] + stack[-1]["dur"] < t:
            stack.pop()
        out[i] = [e["name"] for e in stack]
    return out


def reduce(path: str) -> dict:
    with open(path) as f:
        data = json.load(f)
    events = [e for e in data.get("traceEvents", []) if e.get("ph") == "X"]
    win = [e for e in events if e.get("name") == "bench::window"]
    if not win:
        raise RuntimeError("the trace holds no bench::window range")
    w0, w1 = win[0]["ts"], win[0]["ts"] + win[0]["dur"]
    tid = win[0]["tid"]
    host = [e for e in events if e.get("cat") in ("user_annotation",
                                                  "cpu_op")
            and e.get("tid") == tid and w0 <= e["ts"] <= w1]
    annots = [e for e in host if e.get("cat") == "user_annotation"]
    launches = {}
    for e in events:
        if e.get("cat") in ("cuda_runtime", "cuda_driver"):
            c = (e.get("args") or {}).get("correlation")
            if c is not None:
                launches[c] = e
    dev = [e for e in events if e.get("cat") in DEVICE_CATS
           and e["ts"] < w1 and e["ts"] + e["dur"] > w0]
    found = [launches.get((e.get("args") or {}).get("correlation"))
             for e in dev]
    at = [x for x in found if x is not None and x.get("tid") == tid]
    stacks = dict(zip((id(x) for x in at),
                      stacks_at(annots, [x["ts"] for x in at])))
    busy, kernels = [], 0
    per_call = defaultdict(list)
    by_name = defaultdict(float)
    for e, launch in zip(dev, found):
        names = stacks.get(id(launch), []) if launch is not None else []
        if "bench::probe" in names:
            continue
        a, b = max(e["ts"], w0), min(e["ts"] + e["dur"], w1)
        busy.append((a, b))
        if e.get("cat") != "kernel":
            continue
        kernels += 1
        by_name[e["name"]] += e["dur"] * 1e-6
        owner = [n for n in names if n.startswith("kernel::")]
        if owner and hand_written(e["name"]):
            per_call[int(owner[-1].split("#")[1])].append(e["dur"] * 1e-6)
    merged = _union(busy)
    busy_s = sum(b - a for a, b in merged) * 1e-6
    gaps = []
    prev = w0
    for a, b in merged:
        if a > prev:
            gaps.append((prev, a))
        prev = max(prev, b)
    if w1 > prev:
        gaps.append((prev, w1))
    gaps.sort(key=lambda g: g[0] - g[1])
    top = gaps[:10]
    labels = stacks_at(annots, [(a + b) / 2 for a, b in top])
    idle = [[(" > ".join(n.split("#")[0] for n in st
                         if n != "bench::window") or "host")[:160],
             (b - a) * 1e-6]
            for (a, b), st in zip(top, labels)]
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    n_dev = sum(1 for e in dev if e.get("cat") == "kernel")
    return {"window_s": (w1 - w0) * 1e-6, "busy_s": busy_s,
            "kernels": kernels, "calls": dict(per_call),
            "device_ops": [[n[:160], s] for n, s in ops],
            "idle_gaps": idle,
            "correlated": (sum(x is not None for x in found) / len(dev)
                           if dev else 0.0),
            "device_kernels": n_dev}
