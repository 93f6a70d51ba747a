"""Frames the chunks of the window emitted over what their lanes could
(lanes x chunk frames a chunk), in %."""


def read(run):
    steps = [s for s in run.step_frames
             if run.open_step < s <= run.close_step]
    if not steps:
        return None
    frames = sum(run.step_frames[s] for s in steps)
    return 100.0 * frames / (len(steps) * run.lanes * run.chunk_frames)
