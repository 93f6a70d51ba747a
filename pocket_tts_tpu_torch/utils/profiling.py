"""Tracing, frame metering and the program's spans.

Counterpart of `pocket_tts_tpu/utils/profiling.py`: `FrameMeter` (frames/s,
realtime factor and time to first audio on the host clock, the CLI's
`--bench` report, key for key; `skip` takes back a step that gave no
frame), `device_trace` (a `torch.profiler` trace instead of a
`jax.profiler` one) and `enable_compile_cache`, which here chooses the
directory nvcc builds the kernel library into (ops/cuda_lib.py) instead
of XLA's compilation cache. Unlike the JAX function it swallows no error:
a directory that cannot be made raises, and so does a change of directory
after the library has loaded.

Spans: `span(name, **attrs)` marks a part of the serving path (the
`ptt.*` names of runtime/server.py and runtime/batched.py). A span is
recorded inside `recording()` and whenever a `torch.profiler` records; in
the second case it also opens a `record_function` range of its name, so
the profiler's timeline puts the host's work beside the card's kernels.
Records (`Span`: name, start and end on `time.perf_counter_ns`, the
index of the enclosing span, attributes) go into one bounded buffer,
`recorded_spans()` a snapshot of it in start order. Off, a span is a flag
check, the profiler's check and a shared null context.
"""
from __future__ import annotations

import collections
import contextlib
import itertools
import os
import tempfile
import threading
import time
from typing import List, Optional

import torch

TRACE_FILE = "trace.json"
SPAN_BUFFER = 65536   # the spans kept: the newest this many

_profiler_on = torch._C._autograd._profiler_enabled
_recording = 0        # depth of open `recording()` blocks
_spans: collections.deque = collections.deque(maxlen=SPAN_BUFFER)
_index = itertools.count()
_open = threading.local()


class Span:
    """One recorded span: `i` its index (in start order), `parent` the
    index of the span open around it on the same thread (None at the
    top), `start_ns` / `end_ns` on `time.perf_counter_ns` (`end_ns` None
    while open), `attrs` its attributes."""

    __slots__ = ("i", "name", "start_ns", "end_ns", "parent", "attrs",
                 "_range")

    def __init__(self, name: str, attrs: dict):
        self.name = name
        self.attrs = attrs
        self.end_ns = None

    def set(self, **attrs):
        """Add attributes known only inside the span."""
        self.attrs.update(attrs)

    def __enter__(self):
        self._range = None
        if _profiler_on():
            self._range = torch.profiler.record_function(self.name)
            self._range.__enter__()
        stack = getattr(_open, "stack", None)
        if stack is None:
            stack = _open.stack = []
        self.parent = stack[-1] if stack else None
        self.i = next(_index)
        stack.append(self.i)
        _spans.append(self)
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.end_ns = time.perf_counter_ns()
        _open.stack.pop()
        if self._range is not None:
            self._range.__exit__(*exc)
            self._range = None
        return False


class _Off:
    """The span when nothing records: enters and leaves doing nothing,
    is false, and takes no attributes."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def __bool__(self):
        return False

    def set(self, **attrs):
        pass


_OFF = _Off()


def span(name: str, **attrs):
    """A context manager around a part of the program, recorded inside
    `recording()` or while a torch.profiler records; yields the `Span`
    (`.set(**attrs)` adds attributes), or a false null object when off:
    guard work done only for attributes with `if sp:`."""
    if not (_recording or _profiler_on()):
        return _OFF
    return Span(name, attrs)


@contextlib.contextmanager
def recording():
    """Record spans in the block, with or without a profiler (no
    `record_function` ranges without one). Nests."""
    global _recording
    _recording += 1
    try:
        yield
    finally:
        _recording -= 1


def recorded_spans() -> List[Span]:
    """A snapshot of the buffer: the newest SPAN_BUFFER spans, in start
    order."""
    return list(_spans)


@contextlib.contextmanager
def device_trace(trace_dir: str, device=None):
    """Record a torch.profiler trace of the block and write it as a Chrome
    trace, `<trace_dir>/trace.json` (chrome://tracing or Perfetto reads
    it); yields that path. The profiler records CPU activity and, when
    `device` is a CUDA device (None: whenever a card is present), the
    card's kernels. The window opens on a synchronized device and 10 ms
    before the block's first launch: without that pause the profiler lost
    the first records of a window on the H100 (PERF.md section 5)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    cuda = (torch.cuda.is_available() if device is None
            else torch.device(device).type == "cuda")
    activities = [ProfilerActivity.CPU]
    if cuda:
        activities.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize()
    os.makedirs(trace_dir, exist_ok=True)
    path = os.path.join(trace_dir, TRACE_FILE)
    with profile(activities=activities) as prof:
        time.sleep(0.01)
        yield path
        if cuda:
            torch.cuda.synchronize()
    prof.export_chrome_trace(path)


def enable_compile_cache(path: Optional[str] = None) -> str:
    """Choose the directory the kernel library is built into and looked
    up in, before its first launch: the analog of the JAX package's
    persistent compilation cache (nvcc builds the library once per
    directory and sources; a library built before loads at once). path:
    None keeps the package's `_build/` (ops/cuda_lib BUILD_DIR), "off"
    builds into a fresh temporary directory, anything
    else is made if missing. Returns the directory; raises when it cannot
    be made or when the library has loaded already from another one."""
    from ..ops import cuda_lib
    if path is None:
        path = cuda_lib.BUILD_DIR
    elif path == "off":
        path = tempfile.mkdtemp(prefix="ptt_build_")
    else:
        os.makedirs(path, exist_ok=True)
    cuda_lib.set_build_dir(path)
    return cuda_lib.build_dir()


class FrameMeter:
    """Accumulates per-frame timings; reports frames/s, RTF, TTFA."""

    def __init__(self, frame_rate: float = 12.5):
        self.frame_rate = frame_rate
        self.reset()

    def reset(self):
        self._start = time.perf_counter()
        self._busy = 0.0
        self._frames = 0
        self._first_frame_at: Optional[float] = None

    @contextlib.contextmanager
    def step(self):
        t0 = time.perf_counter()
        yield
        now = time.perf_counter()
        self._busy += now - t0
        self._frames += 1
        if self._first_frame_at is None:
            self._first_frame_at = now - self._start

    def skip(self):
        """The last step gave no frame (a `receive` that returned None):
        take it back from the frame count, and from the first-frame time
        when it was the first step. Its time stays in the busy time, as
        the JAX CLI's `meter._frames -= 1` leaves it; unlike that, the
        time to first audio is the first frame's, not the first step's."""
        self._frames -= 1
        if self._frames == 0:
            self._first_frame_at = None

    def report(self) -> dict:
        fps = self._frames / self._busy if self._busy > 0 else 0.0
        return {
            "frames": self._frames,
            "frames_per_second": round(fps, 3),
            "rtf": round(fps / self.frame_rate, 3),
            "ttfa_ms": (round(self._first_frame_at * 1e3, 2)
                        if self._first_frame_at is not None else None),
            "wall_s": round(time.perf_counter() - self._start, 3),
        }
