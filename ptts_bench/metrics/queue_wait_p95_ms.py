"""95th percentile, over every request the server admitted in the window,
of the time from its submission to its leaving the queue into an
admission group (`Request.submitted_at`, `Request.admitted_at`, both on
the host's perf_counter). A program that does not stamp the admission
gives none."""
from ._stream import in_window, p95


def read(run):
    xs = []
    for s in run.sent:
        t = getattr(s.req, "admitted_at", None)
        if t is not None and in_window(run, t):
            xs.append((t - s.req.submitted_at) * 1e3)
    return p95(xs)
