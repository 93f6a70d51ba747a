"""Device kernels the profiler saw over the traced chunks, per frame step
(the benchmark's own probes left out)."""


def read(run):
    t = run.trace
    if not t or not t["frame_steps"] or not t["kernels"]:
        return None
    return t["kernels"] / t["frame_steps"]
