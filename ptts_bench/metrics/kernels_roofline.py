"""The hand-written kernels' share of their roofline over the traced
chunks: the sum over their calls of each call's least time (the larger of
its bytes at the card's bandwidth and its operations at its peak,
`kernels/<name>.py`) over the sum of the device time of the kernels each
call launched, in %."""
import importlib


def read(run):
    t = run.trace
    if not t or not run.peaks or not t["calls"]:
        return None
    bound = spent = 0.0
    for i, secs in t["calls"].items():
        name, rec = run.kernel_calls[i]
        flops, nbytes = importlib.import_module(
            f"ptts_bench.kernels.{name}").cost(rec)
        bound += max(flops / run.peaks["flops_per_s"],
                     nbytes / run.peaks["bytes_per_s"])
        spent += sum(secs)
    share = 100.0 * bound / spent
    assert share <= 100.0, f"kernels_roofline {share} > 100: a count is wrong"
    return share
