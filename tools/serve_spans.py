"""Where a serving step's host time goes, and what the program's spans cost
(the PyTorch/CUDA port, on an NVIDIA card).

    python3 tools/serve_spans.py --workload int4kv8.turns128 --seed 7 \
        --out spans_turns128.json

from the root of a checkout. It builds a cell of BENCHMARK.json as the
benchmark does, through the cell's model family (`ptts_bench.families`:
Pocket TTS's weights, voices and warm prefills, or Moshi's; the closed
loop until every lane was admitted), then:

1. cost: `--blocks` pairs of `--block-steps` steps, one with
   `profiling.recording()` around the steps and one without, in turn
   (each pair's order swapped from the last), and the median step wall
   of each side; and the cost of one span off and on (no profiler) in a
   tight loop, times the spans a step records;
2. split: the mean milliseconds per step of each `ptt.*` span in the
   recorded blocks (no profiler), and `server_host` = `ptt.step` less its
   `ptt.prefill`, `ptt.chunk` and `ptt.read`;
3. the benchmark's traced chunks (`serve.profile_chunks`, the profiler
   and the kernel records on): the same split there, the mean
   `bench::step` range against the mean `ptt.step` range from the
   profiler's own trace, the idle gaps with their labels, and the four
   span metrics as the benchmark's readers read them;
4. nesting: for each span name, the share of its spans whose parent is
   the span it belongs in (Moshi's `ptt.temporal`, `ptt.depth` and
   `ptt.mimi` in `ptt.frame`).

Prints one JSON line and writes it to --out. Imports neither JAX nor the
JAX package.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import statistics
import sys
import time
from pathlib import Path
from types import SimpleNamespace

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

SPANS = ("ptt.step", "ptt.admit", "ptt.prefill", "ptt.lane_write",
         "ptt.chunk", "ptt.frame", "ptt.read", "ptt.bookkeep",
         "ptt.temporal", "ptt.depth", "ptt.mimi")
# the span each span is recorded in
PARENT = {"ptt.admit": "ptt.step", "ptt.prefill": "ptt.admit",
          "ptt.lane_write": "ptt.admit", "ptt.chunk": "ptt.step",
          "ptt.frame": "ptt.chunk", "ptt.read": "ptt.step",
          "ptt.bookkeep": "ptt.step", "ptt.temporal": "ptt.frame",
          "ptt.depth": "ptt.frame", "ptt.mimi": "ptt.frame"}
TIMED = ("ptt.prefill", "ptt.chunk", "ptt.read")
METRICS = ("queue_wait_p95_ms", "prefill_pad_pct", "host_read_ms",
           "server_host_ms")


def split(steps):
    """Mean ms per step of each span name under the steps, and of
    `server_host`; steps: [(ptt.step span, [spans under it])]."""
    def ms(s):
        return (s.end_ns - s.start_ns) * 1e-6
    n = len(steps)
    out = {name: 0.0 for name in SPANS[:8]}
    host = 0.0
    for st, under in steps:
        out["ptt.step"] += ms(st)
        host += ms(st)
        for k in under:
            out[k.name] = out.get(k.name, 0.0) + ms(k)
            if k.name in TIMED:
                host -= ms(k)
    out = {k: v / n for k, v in out.items()}
    out["server_host"] = host / n
    out["admit_own"] = (out["ptt.admit"] - out["ptt.prefill"]
                        - out["ptt.lane_write"])
    out["steps"] = n
    return out


def span_cost(n=200_000):
    """µs per span (enter and leave) off, and on under recording()."""
    from pocket_tts_tpu_torch.utils import profiling
    out = {}
    for mode in ("off", "on"):
        ctx = profiling.recording() if mode == "on" else contextlib.nullcontext()
        with ctx:
            t = time.perf_counter()
            for i in range(n):
                with profiling.span("ptt.cost", i=i):
                    pass
            out[mode] = (time.perf_counter() - t) / n * 1e6
    return out


def nesting(steps):
    """{span name: share of its spans under the traced steps whose parent
    is PARENT[name]} for the names that occur."""
    by_i, seen, ok = {}, {}, {}
    for st, under in steps:
        by_i[st.i] = st
        for k in under:
            by_i[k.i] = k
    for k in by_i.values():
        if k.name in PARENT:
            seen[k.name] = seen.get(k.name, 0) + 1
            par = by_i.get(k.parent)
            ok[k.name] = ok.get(k.name, 0) + int(
                par is not None and par.name == PARENT[k.name])
    return {name: ok[name] / seen[name] for name in seen}


def trace_cover(path):
    """From the profiler's chrome trace: the mean `bench::step` and
    `ptt.step` range (ms) on the window's thread, and the count of each."""
    with open(path) as f:
        events = [e for e in json.load(f).get("traceEvents", [])
                  if e.get("ph") == "X"
                  and e.get("cat") == "user_annotation"]
    out = {}
    for name in ("bench::step", "ptt.step", "bench::client"):
        d = [e["dur"] * 1e-3 for e in events if e.get("name") == name]
        out[name] = {"n": len(d), "mean_ms": sum(d) / len(d) if d else None}
    b, p = out["bench::step"]["mean_ms"], out["ptt.step"]["mean_ms"]
    out["ptt_over_bench"] = p / b if b and p else None
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--blocks", type=int, default=6)
    ap.add_argument("--block-steps", type=int, default=20)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    import torch
    from ptts_bench import families, serve
    from pocket_tts_tpu_torch.ops import cuda_lib
    if not torch.cuda.is_available():
        print("needs an NVIDIA card", file=sys.stderr)
        return 3
    _, conf, mix, _ = serve.load_cell(args.workload)
    fam = families.load(conf, serve.ROOT)
    serve.set_cache_env()
    torch.set_num_threads(2)
    cuda_lib.set_build_dir(str(serve.cache_dirs()["kernels"]))
    out = measure(fam, conf, mix, args.seed, torch.device("cuda", 0),
                  torch.bfloat16, args.blocks, args.block_steps)
    out["workload"] = args.workload
    line = json.dumps(out)
    print(line)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    return 0


def measure(fam, conf, mix, seed, device, dtype, blocks,
            block_steps) -> dict:
    """Steps 1-4 of the module's docstring on one server of the cell,
    built by its model family `fam` (`ptts_bench.families.load`)."""
    import torch
    from ptts_bench import run as brun, serve, trace as tr
    from ptts_bench.metrics.host_read_ms import traced
    from pocket_tts_tpu_torch.utils import profiling
    t0 = time.perf_counter()
    rec = serve.Run(t0=t0, seed=seed)
    srv = fam.build(conf, mix, seed, device, dtype)
    planned = fam.plan(mix, seed)
    fam.warm(srv, mix, planned)
    cap = fam.Capture(srv, mix["chunk_frames"])
    client = serve.Client(srv, mix, planned, rec, fam.submit)
    rec.chunk_frames, rec.lanes = mix["chunk_frames"], mix["lanes"]

    def step():
        client.before_step()
        return client.after_step(srv.step())

    seen = set()
    warm = mix["arrivals"].get("ramp_chunks", 0) + 1
    while srv.steps < warm or len(seen) < mix["lanes"]:
        step()
        seen |= {i for i, r in enumerate(srv._live) if r is not None}
    for _ in range(block_steps):   # past the ramp's first wave
        step()
    setup_s = time.perf_counter() - t0

    # 1, 2: recording on and off in turn
    walls = {"off": [], "on": []}
    first = srv.steps
    for b in range(blocks):
        for mode in (("off", "on") if b % 2 == 0 else ("on", "off")):
            with (profiling.recording() if mode == "on" else contextlib.nullcontext()):
                last = step_time = time.perf_counter()
                for _ in range(block_steps):
                    step_time = step()
                    walls[mode].append((step_time - last) * 1e3)
                    last = step_time
    recorded = traced(SimpleNamespace(notes={"traced_steps": (
        first, srv.steps)}, t_close=rec.step_time[first]))
    per_step = (sum(1 + len(u) for _, u in recorded) / len(recorded)
                if recorded else 0)
    cost = span_cost()

    # 3: the benchmark's traced chunks
    rec.t_close = rec.step_time[srv.steps]
    rec.close_step = srv.steps
    rec.t_open = rec.step_time[first]
    rec.open_step = first
    cover = {}
    orig = tr.reduce

    def reduce(path):
        cover.update(trace_cover(path))
        return orig(path)
    tr.reduce = reduce
    try:
        serve.profile_chunks(srv, client, cap, rec, mix, device,
                             brun.kernel_specs(), fam.PHASES)
    finally:
        tr.reduce = orig
    metrics = {m: brun.load_reader("metrics", m).read(rec) for m in METRICS}
    in_trace = traced(rec)
    gaps = rec.trace["idle_gaps"]
    inside = [g for g in gaps if g[0].startswith("bench::step")]
    cap.close()
    cuda = device.type == "cuda"
    return {
        "seed": seed,
        "device": torch.cuda.get_device_name(device) if cuda else "cpu",
        "power": brun.power_limit() if cuda else None, "setup_s": setup_s,
        "cost": {
            "step_ms_median_off": statistics.median(walls["off"]),
            "step_ms_median_on": statistics.median(walls["on"]),
            "step_ms_mean_off": statistics.fmean(walls["off"]),
            "step_ms_mean_on": statistics.fmean(walls["on"]),
            "span_us_off": cost["off"], "span_us_on": cost["on"],
            "spans_per_step": per_step,
            "ms_per_step_on": cost["on"] * per_step * 1e-3,
        },
        "split_recording": split(recorded) if recorded else None,
        "split_traced": split(in_trace) if in_trace else None,
        "nesting": nesting(in_trace),
        "cover": cover,
        "idle_gaps": gaps,
        "gaps_in_step_named_ptt": all(" > ptt." in g[0] for g in inside),
        "device_idle_pct": (100.0 * (1 - rec.trace["busy_s"]
                                     / rec.trace["window_s"])
                            if rec.trace["window_s"] > 0 else None),
        "metrics": metrics,
    }


if __name__ == "__main__":
    sys.exit(main())
