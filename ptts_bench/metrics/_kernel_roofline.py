"""One hand-written kernel's share of its roofline over the traced chunks:
the sum over that kernel's calls of each call's least time (the larger of
its bytes at the card's bandwidth and its operations at its peak,
`kernels/<name>.py`) over the sum of the device time of the kernels each
call launched, in %; nothing where no such call was traced."""
import importlib


def share(run, name: str, keep=lambda rec: True):
    t = run.trace
    if not t or not run.peaks or not t["calls"]:
        return None
    cost = importlib.import_module(f"ptts_bench.kernels.{name}").cost
    bound = spent = 0.0
    for i, secs in t["calls"].items():
        kname, rec = run.kernel_calls[i]
        if kname != name or not keep(rec):
            continue
        flops, nbytes = cost(rec)
        bound += max(flops / run.peaks["flops_per_s"],
                     nbytes / run.peaks["bytes_per_s"])
        spent += sum(secs)
    if not spent:
        return None
    pct = 100.0 * bound / spent
    assert pct <= 100.0, f"{name} roofline {pct} > 100: a count is wrong"
    return pct
