"""The lane scheduler: continuous batching over B lanes, whatever the
model.

A step (`step`) is the admission (`_admit`: idle lanes taken from the
queue, then the group's lane write), one decode chunk of `chunk_frames`
frames on the device, its one host read (pcm, valid, done) and the
bookkeeping, in the spans ptt.step > {ptt.admit, ptt.chunk, ptt.read,
ptt.bookkeep} (utils/profiling.span); ptt.admit carries the ids and lanes
taken, ptt.bookkeep the ids completed. `stats` summarizes time to first
audio, queue wait and latency p50/p95.

A model family subclasses it with `lane_frames` (the frames a lane
holds), `_validate(req)` (a request's frame need, checked at the queue
front), `_reset_epoch()` (an empty lane batch in `self.batch`, with
`done` and `graphs`; called when there is none), `_write_lanes(group)`
(the model's part of writing [(lane, request)] into the lanes; seeds
are drawn by then) and `_decode_chunk()` ((pcm (B, chunk, frame), valid
(B, chunk)) on the device); it may replace `_to_host` and `_take_lanes`
(ring admission: an idle lane takes the queue front when its need fits
a lane). The families: runtime/server.ContinuousBatchingServer (Pocket
TTS) and runtime/moshi.MoshiServer.

A lane write or a chunk that fails part-way leaves the batch, updated in
place, half-written: the epoch is dropped and every request held goes
back to the queue front, stamps cleared, to restart (a seeded request
reproduces its audio).
"""
from __future__ import annotations

import dataclasses
import itertools
import time
from typing import List, Optional

import numpy as np

from ..utils.profiling import span


@dataclasses.dataclass(kw_only=True)
class Job:
    """What the scheduler keeps of a request: its seed, its number and its
    stamps; a family's request adds what its model reads."""
    seed: Optional[int] = None   # noise seed; the engine's next when None
    submitted_at: float = 0.0
    ttfa_s: Optional[float] = None
    # the server's number for the request (from submit) and when it left
    # the queue into an admission group or a cohort (perf_counter)
    id: Optional[int] = None
    admitted_at: Optional[float] = None
    done_at: Optional[float] = None
    pcm: Optional[np.ndarray] = None
    chunks: Optional[List[np.ndarray]] = None
    # scheduling clock: decode chunks run before admission and until
    # first audio
    submit_step: Optional[int] = None
    admit_step: Optional[int] = None
    first_audio_step: Optional[int] = None

    @property
    def latency_s(self):
        return None if self.done_at is None else (self.done_at
                                                  - self.submitted_at)

    @property
    def queue_wait_s(self):
        return None if self.admitted_at is None else (self.admitted_at
                                                      - self.submitted_at)


def latency_stats(completed: List[Job], frame_size: int) -> dict:
    """Requests, frames and the p50/p95 of time to first audio, latency
    and queue wait over completed requests."""
    ttfa = sorted(r.ttfa_s for r in completed if r.ttfa_s is not None)
    lat = sorted(r.latency_s for r in completed if r.latency_s is not None)
    wait = sorted(r.queue_wait_s for r in completed
                  if r.queue_wait_s is not None)

    def pct(xs, p):
        return None if not xs else xs[min(len(xs) - 1, int(p * len(xs)))]

    frames = sum(r.pcm.size for r in completed
                 if r.pcm is not None) / frame_size
    return {
        "requests": len(completed),
        "frames": int(frames),
        "p50_ttfa_s": pct(ttfa, 0.50),
        "p95_ttfa_s": pct(ttfa, 0.95),
        "p50_latency_s": pct(lat, 0.50),
        "p95_latency_s": pct(lat, 0.95),
        "p50_queue_wait_s": pct(wait, 0.50),
        "p95_queue_wait_s": pct(wait, 0.95),
    }


class LaneScheduler:
    """`lanes` requests at a time over `engine` (`request_seed()`,
    `frame_size`), `capacity` slots a lane, `chunk_frames` a chunk."""

    def __init__(self, engine, lanes: int, capacity: int,
                 chunk_frames: int):
        self.engine = engine
        self.lanes = lanes
        self.capacity = capacity
        self.chunk_frames = chunk_frames
        self._queue: List[Job] = []
        self._ids = itertools.count()
        self._live: List[Optional[Job]] = [None] * lanes
        self._chunks: List[List[np.ndarray]] = [[] for _ in range(lanes)]
        self.completed: List[Job] = []
        self.steps = 0  # decode chunks executed (scheduling clock)
        self.batch = None

    def _to_host(self, x) -> np.ndarray:
        """A device tensor of every lane, on the host."""
        return x.detach().cpu().numpy()

    # -- the queue ----------------------------------------------------------
    def _submit(self, req: Job) -> Job:
        """Number and stamp a new request, and queue it."""
        req.submitted_at = time.perf_counter()
        req.submit_step = self.steps
        req.id = next(self._ids)
        self._queue.append(req)
        return req

    def _admit(self):
        """Fill idle lanes from the queue: pick the (lane, request) group,
        then write it into its lanes."""
        with span("ptt.admit") as sp:
            if self.batch is None:
                self._reset_epoch()
            group = []
            try:
                self._take_lanes(group)
            finally:
                # a raise mid-scan must not lose the already-popped group
                if sp:
                    sp.set(ids=[r.id for _, r in group],
                           lanes=[lane for lane, _ in group])
                self._admit_group(group)

    def _take(self, group, lane: int):
        """The queue's front request leaves the queue into the group."""
        req = self._queue.pop(0)
        req.admitted_at = time.perf_counter()
        group.append((lane, req))

    def _front_need(self) -> int:
        """The queue front's frame need; a request `_validate` refuses
        leaves the queue and its error is raised."""
        try:
            return self._validate(self._queue[0])
        except ValueError:
            self._queue.pop(0)  # evict the rejected request
            raise

    def _take_lanes(self, group):
        """Ring admission: a lane is admissible whenever it is idle; the
        request's worst-case frame need must fit a lane."""
        room = self.lane_frames
        for lane in range(self.lanes):
            if not self._queue or self._live[lane] is not None:
                continue
            need = self._front_need()
            if need > room:
                self._queue.pop(0)
                raise ValueError(
                    f"request needs {need} frames > the {room} a lane "
                    f"holds (capacity {self.capacity}); split it or grow "
                    "capacity")
            self._take(group, lane)

    def _admit_group(self, group):
        """Seeds drawn in order (the same on every rank of a mesh), the
        model's lane write, the lanes live."""
        if not group:
            return
        for _, req in group:
            if req.seed is None:
                req.seed = self.engine.request_seed()
        try:
            self._write_lanes(group)
        except Exception:
            self._drop_epoch(extra_requeue=[r for _, r in group])
            raise
        for lane, req in group:
            self._live[lane] = req
            self._chunks[lane] = []
            req.admit_step = self.steps

    def _drop_epoch(self, extra_requeue=()):
        """A decode or admission call failed part-way: the batch state may
        be half-written. Free the batch (the next admission starts a new
        epoch) and put every affected request back at the queue front,
        stamps cleared: the live ones, the last lane's first, then the
        group being admitted in its order."""
        back = [r for r in reversed(self._live) if r is not None]
        back += extra_requeue
        for req in back:
            req.ttfa_s = req.first_audio_step = None
            req.admit_step = req.admitted_at = None
        self._queue[:0] = back
        self._live[:] = [None] * self.lanes
        self._chunks[:] = [[] for _ in range(self.lanes)]
        self._free_batch()

    def _free_batch(self):
        """Drop the batch, and the CUDA graphs of its frames with it."""
        if self.batch is not None and self.batch.graphs is not None:
            self.batch.graphs.reset()
        self.batch = None

    # -- the step -----------------------------------------------------------
    def step(self) -> int:
        """One admission + one decode chunk. Returns frames emitted."""
        with span("ptt.step", step=self.steps):
            return self._step()

    def _step(self) -> int:
        self._admit()
        if all(r is None for r in self._live):
            return 0
        try:
            with span("ptt.chunk", frames=self.chunk_frames):
                pcm, valid = self._decode_chunk()
        except Exception:
            self._drop_epoch()
            raise
        # the one host read of the chunk
        with span("ptt.read"):
            pcm = self._to_host(pcm)
            valid = self._to_host(valid)
            done = self._to_host(self.batch.done)
        now = time.perf_counter()
        self.steps += 1
        emitted = 0
        with span("ptt.bookkeep") as sp:
            finished = []
            for lane, req in enumerate(self._live):
                if req is None:
                    continue
                nv = int(valid[lane].sum())
                if nv > 0:
                    if req.ttfa_s is None:
                        req.ttfa_s = now - req.submitted_at
                        req.first_audio_step = self.steps
                    self._chunks[lane].append(
                        pcm[lane, valid[lane]].reshape(-1))
                    emitted += nv
                if bool(done[lane]):
                    req.pcm = (np.concatenate(self._chunks[lane])
                               if self._chunks[lane]
                               else np.zeros(0, np.float32))
                    req.chunks = self._chunks[lane]
                    req.done_at = now
                    self.completed.append(req)
                    finished.append(req.id)
                    self._live[lane] = None
                    self._chunks[lane] = []
            if sp:
                sp.set(ids=finished)
        return emitted

    def run_pending(self, max_chunks: int = 10_000):
        for _ in range(max_chunks):
            if not self._queue and all(r is None for r in self._live):
                return
            self.step()
        raise RuntimeError("run_pending did not drain the queue")

    def stats(self) -> dict:
        return latency_stats(self.completed, self.engine.frame_size)
