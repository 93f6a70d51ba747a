"""95th percentile, over every pair of consecutive chunks a stream received
in the window, of the time between them."""
from ._stream import chunk_times, in_window, p95


def read(run):
    xs = []
    for s in run.sent:
        t = [x for x in chunk_times(run, s) if in_window(run, x)]
        xs += [(b - a) * 1e3 for a, b in zip(t, t[1:])]
    return p95(xs)
