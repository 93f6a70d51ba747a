"""Audio frames delivered to the clients in the window over its seconds
(12.5 frames are a second of audio)."""


def read(run):
    frames = sum(f for s, f in run.step_frames.items()
                 if run.open_step < s <= run.close_step)
    return frames / (run.t_close - run.t_open)
