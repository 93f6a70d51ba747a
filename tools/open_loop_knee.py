"""The knee of an open loop: the highest Poisson arrival rate at which a
cell's server keeps the 95th percentile of send-to-first-audio under a
limit (the PyTorch/CUDA port, on an NVIDIA card).

    python3 tools/open_loop_knee.py --workload int4kv8.sessions256 \
        --seed 7 --rates 50,55,60,65,70,75,80,85 --runs 3 --seconds 20 \
        --out knee.json

from the root of a checkout. It builds the cell's server once, as the
benchmark does (its model family: weights, voices, warm prefills), then
for each rate in turn and each run: the cell's traffic with its arrivals
replaced by a Poisson stream at that rate (no bursts; a plan of its own
seed), `--lead` seconds of it, then a window of `--seconds` in which it
reads the benchmark's `ttfa_p95_ms` (requests whose first audio arrived
in the window, from when they were sent), frames/s and the lanes' fill,
then the arrivals stop and the server drains. A rate passes when every
run reads under `--limit-ms`; the sweep stops after the first rate that
does not. The knee is the highest rate that passed. Prints a JSON line a
run and one with the knee, and writes them all to --out. Imports neither
JAX nor the JAX package.
"""
from __future__ import annotations

import argparse
import copy
import json
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))


def one_run(fam, srv, mix, rate, seed, lead, seconds, frame_size):
    """One run at `rate`: {rate, seed, ttfa_p95_ms, frames_per_s,
    lane_fill_pct, sent, queue_max}."""
    from ptts_bench import run as brun, serve
    m = copy.deepcopy(mix)
    m["arrivals"] = {"kind": "open", "rate_per_s": float(rate),
                     "burst_factor": 1.0}
    planned = fam.plan(m, seed)
    rec = serve.Run(t0=time.perf_counter(), seed=seed)
    rec.frame_size, rec.chunk_frames, rec.lanes = (frame_size,
                                                   m["chunk_frames"],
                                                   m["lanes"])
    client = serve.Client(srv, m, planned, rec, fam.submit)
    qmax = 0

    def step():
        client.before_step()
        return client.after_step(srv.step())

    t = step()
    t_lead = t + lead
    while t < t_lead:
        t = step()
    rec.t_open, rec.open_step = t, srv.steps
    deadline = t + seconds
    while t < deadline:
        t = step()
        qmax = max(qmax, len(srv._queue))
    rec.t_close, rec.close_step = t, srv.steps
    row = {"rate": rate, "seed": seed,
           "ttfa_p95_ms": brun.load_reader("metrics", "ttfa_p95_ms")
           .read(rec),
           "frames_per_s": brun.load_reader("metrics", "audio_frames_per_s")
           .read(rec),
           "lane_fill_pct": brun.load_reader("metrics", "lane_fill_pct")
           .read(rec),
           "sent": sum(1 for s in rec.sent
                       if rec.t_open < s.t_send <= rec.t_close),
           "queue_max": qmax}
    # drain: no more arrivals; every live request finishes
    client.plan = client.plan[:client.cursor]
    while srv._queue or any(r is not None for r in srv._live):
        step()
    srv.completed.clear()
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--rates", required=True,
                    help="comma-separated requests a second, rising")
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--lead", type=float, default=3.0)
    ap.add_argument("--limit-ms", type=float, default=400.0)
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
    device = torch.device("cuda", 0)
    cuda_lib.set_build_dir(str(serve.cache_dirs()["kernels"]))
    srv = fam.build(conf, mix, args.seed, device, torch.bfloat16)
    fam.warm(srv, mix, fam.plan(mix, args.seed))
    rows, knee = [], None
    for rate in (float(r) for r in args.rates.split(",")):
        ok = True
        for i in range(args.runs):
            row = one_run(fam, srv, mix, rate, args.seed + 1000 * i + 1,
                          args.lead, args.seconds, fam.frame_size(conf))
            rows.append(row)
            print(json.dumps(row), flush=True)
            ok &= (row["ttfa_p95_ms"] is not None
                   and row["ttfa_p95_ms"] < args.limit_ms)
        if not ok:
            break
        knee = rate
    summary = {"workload": args.workload, "knee_per_s": knee,
               "limit_ms": args.limit_ms, "runs": args.runs,
               "seconds": args.seconds,
               "card": torch.cuda.get_device_name(device)}
    print(json.dumps(summary))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("\n".join(json.dumps(r) for r in
                                            rows + [summary]) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
