"""Share of the traced chunks' frame steps that ran from CUDA graphs, in %:
100 x the program's `ptt.frame` spans with the attribute `graph` ==
"replay" over all its `ptt.frame` spans. A program whose frame spans carry
no `graph` attribute gives nothing."""
from .host_read_ms import traced


def read(run):
    frames = [k for _, under in traced(run) for k in under
              if k.name == "ptt.frame"]
    if not frames or not any("graph" in k.attrs for k in frames):
        return None
    replays = sum(1 for k in frames if k.attrs.get("graph") == "replay")
    return 100.0 * replays / len(frames)
