"""One run of a cell: set-up, the measured window, the correctness check.

The harness plays the clients of the port's continuous-batching server
(`pocket_tts_tpu_torch.runtime.server.ContinuousBatchingServer`): it
submits each request when its session sends it, calls `step()` (one
admission and one decode chunk of every lane), and stamps on its own clock
when each stream's chunk reaches it, which is when `step()` returns. A
request's frames are contiguous from the chunk after its admission, so its
chunk k arrives with step `admit_step + 1 + k`.

Two probes sit on the timed path in every run: each frame's latents are
copied as `models/tts.frame_step_lanes` returns (one small device copy a
frame, for the comparison), and the lane each live request holds is read
from the server at the first frame of a chunk. The traced run adds host
timers around each admission prefill and decode chunk (synchronized), and
after the window profiles `trace_chunks` more chunks with a record of each
hand-written kernel call (`kernels/`).
"""
from __future__ import annotations

import dataclasses
import inspect
import json
import os
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

from . import traffic, weights

ROOT = Path(__file__).resolve().parent
PROGRAM = "pocket_tts_tpu_torch"


def load_cell(name: str, root: Path = ROOT):
    """(workload entry, configuration file, mix) of a cell named in
    BENCHMARK.json."""
    bench = json.loads((root.parent / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    cell = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    return (cell, json.loads((root.parent / conf["file"]).read_text()),
            traffic.load(cell["traffic"], root), bench)


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


def model_config(model: dict):
    """The port's ModelConfig with the sizes of a configuration file."""
    from pocket_tts_tpu_torch import config as pc

    def fill(obj, spec):
        ch = {}
        for k, v in spec.items():
            cur = getattr(obj, k)
            if dataclasses.is_dataclass(cur):
                ch[k] = fill(cur, v)
            elif k == "stages":
                ch[k] = tuple(pc.SeanetStage(**s) for s in v)
            else:
                ch[k] = v
        return dataclasses.replace(obj, **ch)

    return fill(pc.DEFAULT_CONFIG, model)


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
    plan: traffic.Planned
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
    """The cell's clients around one server."""

    def __init__(self, srv, mix: dict, planned: List[traffic.Planned],
                 run: Run):
        self.srv = srv
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
        req = self.srv.submit(p.text, p.voice, temp=p.temp, seed=p.seed)
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


class Capture:
    """Each frame's latents (B, latent) and, at each chunk's first frame,
    which request every lane holds."""

    def __init__(self, srv, chunk_frames: int):
        import torch
        from pocket_tts_tpu_torch.models import tts
        self.srv = srv
        self.cf = chunk_frames
        self.latents = []
        self.lanes: Dict[int, list] = {}
        self.orig = tts.frame_step_lanes
        self.annotate = False
        cap = self

        def frame_step_lanes(p, cfg, state, *a, **k):
            out = cap.orig(p, cfg, state, *a, **k)
            i = len(cap.latents)
            if i % cap.cf == 0:
                cap.lanes[i // cap.cf] = list(cap.srv._live)
            if cap.annotate:
                with torch.profiler.record_function("bench::probe"):
                    cap.latents.append(state.prev_latent.clone())
            else:
                cap.latents.append(state.prev_latent.clone())
            return out

        def traced(p, cfg, state, *a, **k):
            if not cap.annotate:
                return frame_step_lanes(p, cfg, state, *a, **k)
            with torch.profiler.record_function("tts::frame"):
                return frame_step_lanes(p, cfg, state, *a, **k)

        self.hits = patch_everywhere(self.orig,
                                     same_attributes(traced, self.orig))

    def lane_of(self, req, admit_step: int) -> Optional[int]:
        live = self.lanes.get(admit_step)
        if live is None:
            return None
        for lane, r in enumerate(live):
            if r is req:
                return lane
        return None

    def request_latents(self, req, lane: int, n: int):
        import torch
        a = req.admit_step * self.cf
        return torch.stack([self.latents[a + j][lane] for j in range(n)])

    def close(self):
        unpatch(self.hits)


class Timers:
    """Synchronized host timers around each admission prefill and decode
    chunk (the traced run's window)."""

    def __init__(self, run: Run, device):
        import torch
        from pocket_tts_tpu_torch.runtime import batched
        self.on = True
        self.hits = []

        def sync():
            if device.type == "cuda":
                torch.cuda.synchronize(device)

        def timed(orig, out):
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

        for orig, out in ((batched.batched_sentence_prefill, run.prefill_s),
                          (batched.continuous_decode_chunk, run.chunk_s)):
            self.hits += patch_everywhere(orig, timed(orig, out))

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
        import importlib
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


def build(conf: dict, mix: dict, seed: int, device, dtype):
    """The server of a configuration and mix, its engine on the
    benchmark's weights and voices."""
    from pocket_tts_tpu_torch.io.params import params_from_flat
    from pocket_tts_tpu_torch.runtime.engine import TTSEngine
    from pocket_tts_tpu_torch.runtime.server import ContinuousBatchingServer
    serving = conf["serving"]
    cfg0 = model_config(conf["model"])
    if serving.get("mimi_quantize_kv"):
        cfg0 = dataclasses.replace(cfg0, mimi=dataclasses.replace(
            cfg0.mimi, transformer=dataclasses.replace(
                cfg0.mimi.transformer, quantize_kv=True)))
    flat = weights.checkpoint(conf["model"], seed, device)
    host = {k: v.cpu().numpy() for k, v in flat.items()}
    del flat
    params, cfg = params_from_flat(host, cfg0, dtype=dtype, device=device)
    del host
    tok = traffic.WordTokenizer(cfg.lut.n_bins)
    eng = TTSEngine(params=params, cfg=cfg, dtype=dtype, device=device,
                    seed=weights.sub_seed(seed, 5) % (1 << 62),
                    tokenizer=tok, quantize=serving.get("quantize"),
                    quantize_kv=bool(serving.get("quantize_kv")))
    srv = ContinuousBatchingServer(
        eng, lanes=mix["lanes"], capacity=mix["capacity"],
        chunk_frames=mix["chunk_frames"], text_bucket=mix["text_bucket"],
        share_prefix=bool(serving.get("share_prefix")))
    lengths = traffic.voice_order(mix, seed)
    prompts = weights.voices(conf["model"], lengths, seed, device)
    srv.register_voices({f"v{i}": p.cpu().numpy()
                         for i, p in enumerate(prompts)})
    return srv


def warm_prefills(srv, mix: dict, planned):
    """One admission prefill at each power-of-two group size up to the
    mix's `warm_groups` (admission pads a group to a power of two), on
    requests of the plan; the ramp warms its own group size."""
    k = 1
    while k <= mix["warm_groups"]:
        reqs = []
        for p in planned[:k]:
            r = srv.submit(p.text, p.voice, temp=p.temp, seed=p.seed)
            srv._validate(r)
            reqs.append(r)
        srv._queue.clear()
        srv._prefill_many(reqs)
        k *= 2


def serve(mix: dict, srv, planned, run: Run, seconds: float, device,
          trace: bool, kernel_specs: dict):
    """The warm-up, the window, and with trace the profiled chunks after
    it; returns the Capture."""
    import torch
    cf = mix["chunk_frames"]
    run.chunk_frames, run.lanes = cf, mix["lanes"]
    cap = Capture(srv, cf)
    client = Client(srv, mix, planned, run)
    timers = Timers(run, device) if trace else None
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
        profile_chunks(srv, client, cap, run, mix, device, kernel_specs)
    if timers:
        timers.close()
    return cap


def profile_chunks(srv, client, cap, run: Run, mix: dict, device,
                   kernel_specs: dict):
    """`trace_chunks` chunks under torch.profiler after the window."""
    import tempfile
    import torch
    from torch.profiler import ProfilerActivity, profile
    from . import trace as tr
    calls = KernelCalls(kernel_specs)
    cap.annotate = True
    # name the host's phases of a step for the idle gaps: admission, the
    # decode chunk; the rest of a step is its host read and bookkeeping
    from pocket_tts_tpu_torch.runtime import batched
    admit = srv._admit

    def annotated(name, fn):
        def wrapper(*a, **k):
            with torch.profiler.record_function(name):
                return fn(*a, **k)
        return same_attributes(wrapper, fn)

    srv._admit = annotated("server::admit", admit)
    chunk = patch_everywhere(batched.continuous_decode_chunk, annotated(
        "batched::continuous_decode_chunk",
        batched.continuous_decode_chunk))
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
    unpatch(chunk)
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
