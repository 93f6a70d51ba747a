"""Moshi's operations for the frames emitted in the traced chunks
(`moshi/flops.py`) over the traced window's seconds at the card's peak
bf16 rate, in %."""


def read(run):
    t = run.trace
    if not t or not run.peaks or not run.flops_traced:
        return None
    share = 100.0 * run.flops_traced / (t["window_s"]
                                        * run.peaks["flops_per_s"])
    assert share <= 100.0, f"step_mfu.moshi {share} > 100: the count is wrong"
    return share
