"""Share of the traced window in which no kernel, copy or set ran on the
device (the benchmark's probes left out), in %."""


def read(run):
    t = run.trace
    if not t or t["window_s"] <= 0 or t["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
