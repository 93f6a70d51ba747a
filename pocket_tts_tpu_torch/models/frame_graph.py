"""Piecewise CUDA graphs over one lane frame step (`tts.frame_step_lanes`).

A frame of 256 lanes launches ~760-850 device kernels, most of them
PyTorch ops between the hand-written kernels (K5a/K5b, K7, K6, K2, K3,
K4b). The host spends ~20 us on each launch, several times the device's
time, so the card mostly waits on the host (PERF.md section 5).

Capture: the first frame of a batch runs the frame's Python once. Its
PyTorch ops between two calls of hand-written kernels are captured into a
graph segment (all segments share one memory pool). At each call of a
kernel's entry (`ops.cuda_lib.entry`) the segment ends and is replayed
once, the kernel launches eagerly, the call is recorded with its result,
and the next segment begins; so the capture frame computes a whole frame.
Replay: segment 0, then entry 0 (looked up through its module attribute
at call time, as the eager code does, and writing into the result
recorded at capture: `out=`), segment 1, and so on. Host work that every
frame must do, the cursors' host mirrors, goes through `host(fn)`, which
is recorded in its place the same way.

A replay needs every tensor of the frame at its address of the capture:
the batch state is updated in place, and the frame's tensor arguments
(the noise rows, frames_after_eos, max_steps) are copied into those the
capture saw unless they are those tensors. Nothing in the frame may
depend on a host value that changes between frames. The two that did,
the backbone write slot and the Mimi ring offset, are kept on the device
as well (`attach_cursors`, `Cursor`) and advanced there; K7 and K2 read
them through a pointer. A change of the batch's tensors (a new epoch, new
prefix tables), of the params or of the arguments' shapes captures again
(`frame_key`), and `reset` frees the segments.

Which frames take graphs (`graphable`): a lane batch in ring mode on one
CUDA card. A linear cursor moves K7's read end and split every frame, a
mesh runs collectives inside the frame and the CPU has no graphs: those
run eagerly. `FrameGraphs(graph=...)` takes another class with
`torch.cuda.CUDAGraph`'s capture_begin / capture_end / replay / reset,
which is how the CPU tests drive it (a stand-in that records each
segment's ops and runs them again).

`span(name, **attrs)` marks a part of a frame (`utils.profiling.span`):
under capture the segments split at its ends and each replay opens and
closes it there, so the graph pieces and kernels replayed inside it fall
inside its range (Moshi's `ptt.temporal`, `ptt.depth`, `ptt.mimi`).
"""
from __future__ import annotations

import contextlib
import dataclasses
import sys
import warnings

import torch

from ..ops import cuda_lib
from ..utils import profiling

GRAPH, ENTRY, HOST, SPAN = range(4)
_capturing = None   # the FrameGraphs whose frame is being captured


class Cursor:
    """A cursor shared by a batch's lanes, kept twice: `dev`, a one-element
    int32 tensor on the device that the frame's ops and kernels read, and
    the host mirror `getattr(obj, name)`, which int() reads at the time it
    is asked (checks, admission, the benchmark's records of a call)."""

    __slots__ = ("obj", "name", "dev")

    def __init__(self, obj, name: str, dev: torch.Tensor):
        self.obj, self.name, self.dev = obj, name, dev

    def __int__(self):
        return getattr(self.obj, self.name)

    __index__ = __int__

    def __repr__(self):
        return f"Cursor({self.name}={int(self)})"


def cursor(obj, name: str):
    """obj.<name> as a Cursor when obj keeps it on the device as well
    (obj.<name>_dev), else the host int."""
    dev = getattr(obj, name + "_dev")
    return getattr(obj, name) if dev is None else Cursor(obj, name, dev)


def host(fn) -> None:
    """Run fn() now; while a frame is captured, also at this point of every
    replay (work on host values that each frame must do)."""
    fn()
    if _capturing is not None:
        _capturing.items.append((HOST, fn))


@contextlib.contextmanager
def span(name: str, **attrs):
    """`profiling.span(name, **attrs)` around a part of a frame; while the
    frame is captured, the graph segments end and begin again at the
    span's ends, and every replay opens and closes the span at those
    points."""
    cap = _capturing
    if cap is None:
        with profiling.span(name, **attrs):
            yield
        return
    cap._end()
    cap.items.append((SPAN, name, attrs))
    sp = profiling.span(name, **attrs)
    sp.__enter__()
    try:
        cap._begin()
        yield
        cap._end()
    finally:
        sp.__exit__(None, None, None)
    cap.items.append((SPAN, None, None))
    cap._begin()


def attach_cursors(state) -> None:
    """Keep a lane batch's backbone write slot (`flow.end_dev`) and Mimi
    ring offset (`mimi.transformer.offset_dev`) on the device too, from
    their host ints; the frame then reads and advances both there."""
    flow, tr = state.flow, state.mimi.transformer
    dev = state.step.device
    if flow.end_dev is None:
        flow.end_dev = torch.tensor([flow.end], dtype=torch.int32,
                                    device=dev)
    if tr.offset_dev is None:
        tr.offset_dev = torch.tensor([tr.offset], dtype=torch.int32,
                                     device=dev)


def graphable(cfg, state) -> bool:
    """Frames of this batch run from CUDA graphs: one CUDA card (no mesh)
    and the prefix+ring cursor."""
    return (state.step.device.type == "cuda" and not cfg.on_mesh
            and cfg.backbone.mesh is None
            and state.flow.ring_start is not None)


def _tensors(obj, out: list) -> list:
    if isinstance(obj, torch.Tensor):
        out.append(obj)
    elif isinstance(obj, (list, tuple)):
        for x in obj:
            _tensors(x, out)
    elif isinstance(obj, dict):
        for x in obj.values():
            _tensors(x, out)
    elif dataclasses.is_dataclass(obj):
        for name, x in vars(obj).items():
            if name != "graphs":
                _tensors(x, out)
    return out


def frame_key(p, cfg, state, seanet_weights, inputs) -> tuple:
    """What a capture holds fixed: the params, cfg and SEANet layouts, the
    address of every tensor of the batch state, and the inputs' shapes."""
    return (id(p), id(cfg), id(seanet_weights),
            tuple(t.data_ptr() for t in _tensors(state, [])),
            tuple((t.shape, t.dtype, t.device) for t in inputs))


def run_frame(graphs, body, key, inputs):
    """`graphs.run(body, key, inputs)`, counted in `run_frame.captures`,
    `.replays` and `.segments` (graph segments a frame, of the last
    capture); returns body's outputs."""
    out, mode = graphs.run(body, key, inputs)
    if mode == "capture":
        run_frame.captures += 1
        run_frame.segments = graphs.segments
    else:
        run_frame.replays += 1
    return out


run_frame.captures = run_frame.replays = run_frame.segments = 0


class FrameGraphs:
    """The segments, kernel calls and host steps of one captured frame.
    `run(body, key, inputs)` captures body(*inputs) when `key` differs from
    the capture's, else replays it; it returns (clones of body's output
    tensors, "capture" or "replay"), and `last` says which."""

    def __init__(self, graph=None):
        self.graph = graph      # None: torch.cuda.CUDAGraph
        self.items = []
        self.key = None
        self.inputs = ()
        self.outputs = ()
        self.segments = 0       # graph segments a frame
        self.last = None
        self._g = None

    def reset(self) -> None:
        """Free the segments; the next run captures."""
        for item in self.items:
            if item[0] == GRAPH:
                item[1].reset()
        self.items, self.key = [], None
        self.inputs, self.outputs = (), ()
        self.segments = 0

    def run(self, body, key, inputs):
        if key == self.key:
            self.last = "replay"
            return self._replay(inputs), self.last
        out = self._capture(body, key, inputs)
        self.last = "capture"
        return out, self.last

    # -- capture ----------------------------------------------------------
    def _capture(self, body, key, inputs):
        global _capturing
        self.reset()
        self._cuda = self.graph is None
        if self._cuda:
            torch.cuda.synchronize()
            self._main = torch.cuda.current_stream()
            self._side = torch.cuda.Stream()
            self._pool = torch.cuda.graph_pool_handle()
        else:
            self._pool = None
        prev = cuda_lib.set_entry_hook(self._entry)
        _capturing = self
        try:
            self._begin()
            out = body(*inputs)
            self._end()
        except BaseException:
            self._abandon()
            self.reset()
            raise
        finally:
            _capturing = None
            cuda_lib.set_entry_hook(prev)
        self.key, self.inputs, self.outputs = key, tuple(inputs), tuple(out)
        return tuple(o.clone() for o in self.outputs)

    def _begin(self):
        self._g = (self.graph or torch.cuda.CUDAGraph)()
        if self._cuda:
            torch.cuda.set_stream(self._side)
        self._g.capture_begin(pool=self._pool,
                              capture_error_mode="thread_local")

    def _end(self):
        g, self._g = self._g, None
        with warnings.catch_warnings():
            # a segment with no kernel (two entries back to back) is empty
            warnings.filterwarnings("ignore", message=".*[Gg]raph is empty")
            g.capture_end()
        if self._cuda:
            torch.cuda.set_stream(self._main)
        g.replay()
        self.items.append((GRAPH, g))
        self.segments += 1

    def _abandon(self):
        if self._g is not None:
            g, self._g = self._g, None
            try:
                g.capture_end()
            except Exception:
                pass
            if self._cuda:
                torch.cuda.set_stream(self._main)

    def _entry(self, fn, args, kwargs):
        """A hand-written kernel's entry called inside the capture."""
        self._end()
        cuda_lib.set_entry_hook(None)   # an entry's own entry calls run
        try:
            res = fn(*args, **kwargs)
        finally:
            cuda_lib.set_entry_hook(self._entry)
        self.items.append((ENTRY, sys.modules[fn.__module__], fn.__name__,
                           args, dict(kwargs, out=res)))
        self._begin()
        return res

    # -- replay -----------------------------------------------------------
    def _replay(self, inputs):
        for mine, given in zip(self.inputs, inputs):
            if given is not mine:
                mine.copy_(given)
        spans = []
        for item in self.items:
            kind = item[0]
            if kind == GRAPH:
                item[1].replay()
            elif kind == ENTRY:
                getattr(item[1], item[2])(*item[3], **item[4])
            elif kind == SPAN:
                if item[1] is None:
                    spans.pop().__exit__(None, None, None)
                else:
                    spans.append(profiling.span(item[1], **item[2]))
                    spans[-1].__enter__()
            else:
                item[1]()
        return tuple(o.clone() for o in self.outputs)
