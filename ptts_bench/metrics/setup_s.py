"""Seconds from the process's start to the window's opening: the weights
and voices made, the engine loaded (and the kernel library built on a
checkout's first run), the shapes warmed up and every lane admitted."""


def read(run):
    return run.setup_s
