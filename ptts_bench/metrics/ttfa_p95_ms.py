"""95th percentile, over every request whose first audio arrived in the
window, of the time from when its session sent it to its first chunk."""
from ._stream import chunk_times, in_window, p95


def read(run):
    xs = []
    for s in run.sent:
        t = chunk_times(run, s)
        if t and in_window(run, t[0]):
            xs.append((t[0] - s.t_send) * 1e3)
    return p95(xs)
