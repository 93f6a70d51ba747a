"""One run of a cell: set-up, the measured window, the correctness check.

The harness plays the clients of the port's continuous-batching server
(the cell's model family builds it, `families/`): it submits each request
when its session sends it, calls `step()` (one admission and one decode
chunk of every lane), and stamps on its own clock when each stream's chunk
reaches it, which is when `step()` returns. A request's frames are
contiguous from the chunk after its admission, so its chunk k arrives with
step `admit_step + 1 + k`.

The family's probe sits on the timed path in every run (`Capture`: what
the judge needs of each frame, and the lane each live request holds at
the first frame of a chunk). The traced run adds host timers around the
family's `TIMED` functions (synchronized), and after the window profiles
`trace_chunks` more chunks with a record of each hand-written kernel call
(`kernels/`). The mix keys read here: `lanes`, `chunk_frames`, `capacity`,
`arrivals`, `warm_chunks` (optional) and `trace_chunks`.
"""
from __future__ import annotations

import dataclasses
import importlib
import inspect
import json
import os
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

from . import families

ROOT = Path(__file__).resolve().parent
PROGRAM = "pocket_tts_tpu_torch"


def load_cell(name: str, root: Path = ROOT):
    """(workload entry, configuration file, mix, BENCHMARK.json) of a cell
    named in BENCHMARK.json; fails here where the configuration's model
    family has no file."""
    bench = json.loads((root.parent / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    cell = cells[name]
    entry = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    conf = json.loads((root.parent / entry["file"]).read_text())
    families.load(conf, root)
    mix = json.loads((root / "traffic" / f"{cell['traffic']}.json")
                     .read_text())
    return cell, conf, mix, bench


def cache_dirs(root: Path = ROOT) -> dict:
    """Fixed build and kernel-cache directories inside the checkout."""
    base = root / ".cache"
    return {"kernels": base / "kernels", "triton": base / "triton",
            "extensions": base / "torch_extensions",
            "cuda": base / "cuda"}


def set_cache_env(root: Path = ROOT) -> dict:
    dirs = cache_dirs(root)
    for d in dirs.values():
        d.mkdir(parents=True, exist_ok=True)
    os.environ["TRITON_CACHE_DIR"] = str(dirs["triton"])
    os.environ["TORCH_EXTENSIONS_DIR"] = str(dirs["extensions"])
    os.environ["CUDA_CACHE_PATH"] = str(dirs["cuda"])
    return dirs


def patch_everywhere(orig, repl) -> list:
    """Point every module of the program that holds `orig` at `repl`;
    returns what to restore."""
    hits = []
    for name, mod in list(sys.modules.items()):
        if mod is None or name.split(".")[0] != PROGRAM:
            continue
        for attr, val in list(vars(mod).items()):
            if val is orig:
                setattr(mod, attr, repl)
                hits.append((mod, attr, orig))
    return hits


def same_attributes(wrapper, orig):
    """The wrapper shares the function's attributes (the program's launch
    counters live there and are updated through the module's name)."""
    wrapper.__dict__ = orig.__dict__
    return wrapper


def unpatch(hits):
    for mod, attr, orig in hits:
        setattr(mod, attr, orig)


@dataclasses.dataclass
class Sent:
    plan: object           # the family's planned request
    req: object            # the server's Request
    session: int
    t_send: float
    done_step: Optional[int] = None


@dataclasses.dataclass
class Run:
    """What a run measured, for the metric readers and the result line."""
    t0: float
    seed: int = 0
    frame_size: int = 0
    t_open: float = 0.0
    t_close: float = 0.0
    chunk_frames: int = 5
    lanes: int = 0
    # by the server's step count after each chunk: when it returned to
    # the clients, and the frames it emitted
    step_time: Dict[int, float] = dataclasses.field(default_factory=dict)
    step_frames: Dict[int, int] = dataclasses.field(default_factory=dict)
    open_step: int = 0
    close_step: int = 0
    sent: List[Sent] = dataclasses.field(default_factory=list)
    prefill_s: List[float] = dataclasses.field(default_factory=list)
    chunk_s: List[float] = dataclasses.field(default_factory=list)
    trace: Optional[dict] = None
    kernel_calls: list = dataclasses.field(default_factory=list)
    flops_traced: float = 0.0
    memory_peak: int = 0
    setup_s: float = 0.0
    device_name: str = ""
    peaks: Optional[dict] = None
    notes: Dict[str, object] = dataclasses.field(default_factory=dict)


class Client:
    """The cell's clients around one server; `submit(srv, planned)` hands
    the server one planned request."""

    def __init__(self, srv, mix: dict, planned: list, run: Run, submit):
        self.srv = srv
        self.submit = submit
        self.mix = mix
        self.plan = planned
        self.run = run
        self.cursor = 0
        arr = mix["arrivals"]
        self.kind = arr["kind"]
        n = arr.get("sessions", 0)
        ramp = arr.get("ramp_chunks", 0)
        self.think = arr.get("think_chunks", 0)
        self.next_chunk = [s * ramp // n for s in range(n)] if n else []
        self.busy: Dict[int, Sent] = {}
        self.done_seen = 0
        self.t_traffic = None

    def _send(self, session: int, now: float, due: float = None):
        if self.cursor >= len(self.plan):
            raise RuntimeError("the traffic plan ran out: raise `pool`")
        p = self.plan[self.cursor]
        self.cursor += 1
        req = self.submit(self.srv, p)
        s = Sent(p, req, session, now if due is None else due)
        self.run.sent.append(s)
        self.busy[id(req)] = s

    def before_step(self):
        now = time.perf_counter()
        if self.t_traffic is None:
            self.t_traffic = now
        if self.kind == "closed":
            for s, c in enumerate(self.next_chunk):
                if c is not None and c <= self.srv.steps:
                    self.next_chunk[s] = None
                    self._send(s, now)
        else:
            while (self.cursor < len(self.plan) and self.t_traffic
                   + self.plan[self.cursor].due_s <= now):
                self._send(-1, now, self.t_traffic
                           + self.plan[self.cursor].due_s)

    def after_step(self, emitted: int) -> float:
        now = time.perf_counter()
        self.run.step_time[self.srv.steps] = now
        self.run.step_frames[self.srv.steps] = emitted
        done = self.srv.completed[self.done_seen:]
        self.done_seen = len(self.srv.completed)
        for req in done:
            s = self.busy.pop(id(req))
            s.done_step = self.srv.steps
            if self.kind == "closed":
                self.next_chunk[s.session] = self.srv.steps + self.think
        if self.kind == "closed" and self.think == 0:
            self.before_step()  # a session sends as soon as it is answered
        return now


class Timers:
    """Synchronized host timers around each call of the functions `timed`
    names ({Run list: (module, function)}; the traced run's window)."""

    def __init__(self, run: Run, device, timed: dict):
        import torch
        self.on = True
        self.hits = []

        def sync():
            if device.type == "cuda":
                torch.cuda.synchronize(device)

        def wrap(orig, out):
            def wrapper(*a, **k):
                if not self.on:
                    return orig(*a, **k)
                sync()
                t = time.perf_counter()
                res = orig(*a, **k)
                sync()
                out.append(time.perf_counter() - t)
                return res
            return same_attributes(wrapper, orig)

        for out, (mod, fn) in timed.items():
            orig = getattr(importlib.import_module(mod), fn)
            self.hits += patch_everywhere(orig, wrap(orig, getattr(run, out)))

    def close(self):
        unpatch(self.hits)


class KernelCalls:
    """A record of each hand-written kernel call while the profiler runs:
    `kernels/<name>.py` names the entry function (`ENTRY`) and gives
    `record(args)` at the call and `cost(rec)` -> (flops, bytes) after. A
    call runs inside a profiler range `kernel::<name>#<i>`, so the trace
    ties the kernels it launches to it; a call inside another recorded
    call is the outer call's."""

    def __init__(self, specs: dict):
        import torch
        self.calls: List[tuple] = []
        self.on = False
        self.depth = 0
        self.hits = []
        for name, spec in specs.items():
            mod_name, fn_name = spec.ENTRY
            orig = getattr(importlib.import_module(mod_name), fn_name)
            sig = inspect.signature(orig)
            self.hits += patch_everywhere(
                orig, self._wrap(name, spec, orig, sig, torch))

    def _wrap(self, name, spec, orig, sig, torch):
        def wrapper(*a, **k):
            if not self.on or self.depth:
                return orig(*a, **k)
            with torch.profiler.record_function("bench::probe"):
                args = sig.bind(*a, **k)
                args.apply_defaults()
                rec = spec.record(args.arguments)
            i = len(self.calls)
            self.calls.append((name, rec))
            self.depth += 1
            try:
                with torch.profiler.record_function(f"kernel::{name}#{i}"):
                    return orig(*a, **k)
            finally:
                self.depth -= 1
        return same_attributes(wrapper, orig)

    def close(self):
        unpatch(self.hits)


def serve(mix: dict, fam, srv, planned, run: Run, seconds: float, device,
          trace: bool, kernel_specs: dict):
    """The warm-up, the window, and with trace the profiled chunks after
    it, on the server of the model family `fam`; returns its Capture."""
    import torch
    cf = mix["chunk_frames"]
    run.chunk_frames, run.lanes = cf, mix["lanes"]
    cap = fam.Capture(srv, cf)
    client = Client(srv, mix, planned, run, fam.submit)
    timers = Timers(run, device, fam.TIMED) if trace else None
    if timers:
        timers.on = False
    warm = mix.get("warm_chunks", mix["arrivals"].get("ramp_chunks", 0) + 1)
    seen = set()
    # warm-up: the ramp, until every lane has been admitted
    while True:
        client.before_step()
        emitted = srv.step()
        client.after_step(emitted)
        live = cap.lanes.get(srv.steps - 1, [])
        seen |= {i for i, r in enumerate(live) if r is not None}
        if srv.steps >= warm and len(seen) == mix["lanes"]:
            break
        if srv.steps > warm + 4 * mix["capacity"]:
            raise RuntimeError("warm-up never filled every lane")
    run.t_open = run.step_time[srv.steps]
    run.open_step = srv.steps
    run.setup_s = run.t_open - run.t0
    if timers:
        timers.on = True
    deadline = run.t_open + seconds
    while True:
        client.before_step()
        if client.after_step(srv.step()) >= deadline:
            break
    run.t_close = run.step_time[srv.steps]
    run.close_step = srv.steps
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        run.memory_peak = int(torch.cuda.max_memory_allocated(device))
    if trace:
        timers.on = False
        profile_chunks(srv, client, cap, run, mix, device, kernel_specs,
                       fam.PHASES)
    if timers:
        timers.close()
    return cap


def profile_chunks(srv, client, cap, run: Run, mix: dict, device,
                   kernel_specs: dict, phases: dict):
    """`trace_chunks` chunks under torch.profiler after the window, the
    host's phases in ranges: `server::admit` around the server's `_admit`,
    and each of `phases` ({range name: (module, function)})."""
    import tempfile
    import torch
    from torch.profiler import ProfilerActivity, profile
    from . import trace as tr
    calls = KernelCalls(kernel_specs)
    cap.annotate = True
    # name the host's phases of a step for the idle gaps: admission and
    # the family's; the rest of a step is its host read and bookkeeping
    admit = srv._admit

    def annotated(name, fn):
        def wrapper(*a, **k):
            with torch.profiler.record_function(name):
                return fn(*a, **k)
        return same_attributes(wrapper, fn)

    srv._admit = annotated("server::admit", admit)
    named = []
    for name, (mod, fn) in phases.items():
        orig = getattr(importlib.import_module(mod), fn)
        named += patch_everywhere(orig, annotated(name, orig))
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    n = mix["trace_chunks"]
    first = srv.steps
    with profile(activities=acts) as prof:
        calls.on = True
        with torch.profiler.record_function("bench::window"):
            for _ in range(n):
                with torch.profiler.record_function("bench::step"):
                    client.before_step()
                    emitted = srv.step()
                with torch.profiler.record_function("bench::client"):
                    client.after_step(emitted)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
        calls.on = False
    calls.close()
    unpatch(named)
    srv._admit = admit
    cap.annotate = False
    run.notes["traced_steps"] = (first, srv.steps)
    run.kernel_calls = calls.calls
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        run.trace = tr.reduce(path)
    finally:
        os.remove(path)
    run.trace["frame_steps"] = (srv.steps - first) * mix["chunk_frames"]
