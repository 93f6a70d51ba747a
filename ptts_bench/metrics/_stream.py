"""What each stream received in the window, from a run's records: a
request's chunk k arrived when step `first_audio_step + k` returned (its
frames are contiguous from the chunk after its admission)."""
from __future__ import annotations

import math


def in_window(run, t) -> bool:
    return run.t_open < t <= run.t_close


def chunk_times(run, sent) -> list:
    """Arrival times of the chunks a request received, up to the close."""
    req = sent.req
    first = req.first_audio_step
    if first is None or first > run.close_step:
        return []
    if sent.done_step is not None and req.pcm is not None:
        frames = req.pcm.size // run.frame_size
        last = first + math.ceil(frames / run.chunk_frames) - 1
    else:
        last = run.close_step
    return [run.step_time[s] for s in range(first, min(last, run.close_step)
                                            + 1)]


def p95(xs):
    import numpy as np
    return float(np.percentile(np.asarray(xs, float), 95)) if xs else None
