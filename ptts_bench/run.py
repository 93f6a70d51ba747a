"""Run one cell of BENCHMARK.json once and print its result line.

    python3 -m ptts_bench.run --workload int4kv8.sessions256 --seed 7 \
        --seconds 20 --trace 0

from the root of a checkout. It needs an NVIDIA card (it exits with 3 and
prints no result without one) and runs the PyTorch/CUDA port,
`pocket_tts_tpu_torch`, only. With --trace 0 the result's metrics are the
cell's end-to-end metrics, with --trace 1 its per-layer metrics and a
breakdown of the device's time. --control 1 also computes the control's
numbers (the reference one precision step down in the program's place)
on the same sample and prints them; the limits in the configuration files
were set from them. Measuring runs leave it off.
"""
from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent
FORBIDDEN = {"jax", "jaxlib", "flax", "pocket_tts_tpu"}


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & FORBIDDEN)


def load_reader(kind: str, name: str):
    path = ROOT / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"ptts_bench.{kind}.{name.replace('.', '_').replace('-', '_')}",
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def kernel_specs() -> dict:
    return {p.stem: load_reader("kernels", p.stem)
            for p in sorted((ROOT / "kernels").glob("*.py"))
            if not p.stem.startswith("_")}


def peaks_for(name: str):
    table = json.loads((ROOT / "peaks.json").read_text())
    for entry in table["cards"]:
        if entry["match"] in name:
            return entry
    return None


def power_limit() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, default=0, choices=(0, 1))
    ap.add_argument("--control", type=int, default=0, choices=(0, 1))
    args = ap.parse_args(argv)

    from . import serve
    cell, conf, mix, bench = serve.load_cell(args.workload)
    import torch
    if not torch.cuda.is_available() or (torch.cuda.device_count()
                                         < cell["chips"]):
        print(f"no result: the cell needs {cell['chips']} CUDA card(s); "
              f"torch sees {torch.cuda.device_count()}", file=sys.stderr)
        return 3
    serve.set_cache_env()
    torch.set_num_threads(2)  # one process, few threads: a steadier host
    device = torch.device("cuda", 0)
    result, rec = run_cell(cell, conf, mix, bench, args.seed, args.seconds,
                           bool(args.trace), bool(args.control), device,
                           torch.bfloat16)
    rows = rec.notes.get("rows", [])
    found = forbidden_modules()
    if found:
        print(f"no result: modules {found} were loaded", file=sys.stderr)
        return 4
    for row in rows:
        print("request " + json.dumps(row), file=sys.stderr)
    walls = sorted(rec.step_time[s] - rec.step_time[s - 1]
                   for s in range(rec.open_step + 1, rec.close_step + 1))
    print(f"chunks in the window: {len(walls)}, wall ms p10 / p50 / p90 "
          f"{walls[len(walls) // 10] * 1e3:.1f} / "
          f"{walls[len(walls) // 2] * 1e3:.1f} / "
          f"{walls[len(walls) * 9 // 10] * 1e3:.1f}", file=sys.stderr)
    print(json.dumps(result))
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    return 0


def run_cell(cell, conf, mix, bench, seed, seconds, trace, control,
             device, dtype, kernels=None, root=ROOT):
    """One run; returns (the result dict, its key "checks" last; the
    run's records). Used by `main` on the card and by the tests on the
    CPU at small sizes. `root` holds the model families (`families/`)."""
    import torch
    from pocket_tts_tpu_torch.ops import cuda_lib
    from . import families, serve
    fam = families.load(conf, root)
    if device.type == "cuda":
        cuda_lib.set_build_dir(str(serve.cache_dirs()["kernels"]))
    run = serve.Run(t0=T0)
    run.seed = seed
    run.frame_size = fam.frame_size(conf)
    srv = fam.build(conf, mix, seed, device, dtype)
    planned = fam.plan(mix, seed)
    fam.warm(srv, mix, planned)
    cap = serve.serve(mix, fam, srv, planned, run, seconds, device, trace,
                      kernel_specs() if kernels is None else kernels)
    run.device_name = (torch.cuda.get_device_name(device)
                       if device.type == "cuda" else "cpu")
    run.peaks = peaks_for(run.device_name)
    if trace:
        run.flops_traced = fam.model_flops(run, cap, conf, mix)
    # the sample, then the program's state freed before the reference
    cases = fam.sample(run, cap, mix, seed)
    cap.close()
    attempted = sum(1 for s in run.sent
                    if run.t_open < s.t_send <= run.t_close)
    del srv, cap
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    verdict = fam.judge(conf, mix, cases, seed, device, control)
    run.notes["rows"] = verdict["rows"]
    names = [m["name"] for m in bench[
        "per_layer" if trace else "end_to_end"]
        if cell["name"] in m.get("workloads", [cell["name"]])]
    metrics = {}
    for name in names:
        value = load_reader("metrics", name).read(run)
        if value is not None:
            unit = {m["name"]: m["unit"] for m in bench["end_to_end"]
                    + bench["per_layer"]}[name]
            metrics[name] = {"value": value, "unit": unit}
    out = {"correct": verdict["correct"], "attempted": attempted,
           "failed": 0, "metrics": metrics,
           "device": {"platform": "gpu" if device.type == "cuda" else "cpu",
                      "kind": run.device_name, "count": cell["chips"],
                      "memory_peak_bytes": run.memory_peak}}
    if device.type == "cuda":
        out["device"]["power"] = power_limit()
    if trace and run.trace:
        out["device"]["busy_s"] = run.trace["busy_s"]
        out["device"]["window_s"] = run.trace["window_s"]
        out["breakdown"] = {"device_ops": run.trace["device_ops"],
                            "idle_gaps": run.trace["idle_gaps"]}
        out["trace_notes"] = {"correlated": run.trace["correlated"],
                              "calls": len(run.kernel_calls)}
    out["sampled"] = verdict["sampled"]
    if control:
        out["control"] = verdict["control"]
        out["control_fails"] = verdict["control_fails"]
    out["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in
                     verdict["checks"].items()}
    return out, run


if __name__ == "__main__":
    sys.exit(main())
