"""Moshi on the lane scheduler: the engine, the call, and Moshi's lanes.

`MoshiEngine` holds Moshi's params and config on one device (bf16 on the
card) with the SEANet layouts of kernel K3. `MoshiServer` is the lane
scheduler (runtime/lanes.py) with Moshi's lanes: each call's uniforms,
drawn from its seed, and user codes; a call starts from the initial
tokens, or, resumed at a step, has its first steps prefilled.

A request is a `Call`: the user's stream of n_q Mimi codes a frame (n
frames); Moshi answers with n frames of PCM (the lane runs n + 1 frames:
its first decodes nothing, the delay of the acoustic codebooks). A call
resumed at its step a (`history`: the text and codes Moshi drew at its
first a steps) answers from its frame a - 1 on, n - a + 1 frames.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ..models import frame_graph, moshi
from ..ops.seanet_frame import prep_weights
from ..utils.profiling import span
from .engine import _device
from .lanes import Job, LaneScheduler


class MoshiEngine:
    """Moshi's params on one device. params: `io.moshi_params.
    params_from_flat`'s tree on that device; device: "cuda" when None
    (raises when there is no card; the CPU takes device="cpu"); dtype: the
    params' type, bf16 on the card and float32 on the CPU when None; seed:
    the source of the seeds of calls that bring none."""

    def __init__(self, params: dict, cfg, dtype: torch.dtype = None,
                 device=None, seed: int = 0):
        self.device = _device(device)
        self.params = params
        self.cfg = cfg
        self.dtype = dtype or (torch.bfloat16 if self.device.type == "cuda"
                               else torch.float32)
        self.frame_size = cfg.frame_size
        self.seanet_weights = (prep_weights(params["mimi"]["decoder"],
                                            cfg.mimi.seanet)
                               if self.device.type == "cuda" else None)
        self._seeds = np.random.default_rng(seed)

    def request_seed(self) -> int:
        return int(self._seeds.integers(1, 1 << 62))

    def draws(self, seed: int, frames: int) -> torch.Tensor:
        """A call's uniforms (frames, 1 + n_q) float32 on the device, from
        a torch.Generator there seeded with the call's seed: row t the
        draws of its step t (the text's, then each codebook's)."""
        g = torch.Generator(device=self.device)
        g.manual_seed(int(seed))
        return torch.rand(frames, 1 + self.cfg.n_q, generator=g,
                          device=self.device)


@dataclasses.dataclass
class Call(Job):
    """A full-duplex call: the user's codes (frames, n_q), and where it
    resumes, the text (a,) and codes (a, n_q) Moshi drew at its first a
    steps."""
    codes: np.ndarray
    history: Optional[Tuple[np.ndarray, np.ndarray]] = None

    @property
    def age(self) -> int:
        """The step the call starts at: 0, or a with a history."""
        return 0 if self.history is None else len(self.history[0])


class MoshiServer(LaneScheduler):
    """The lane scheduler over a MoshiEngine: ring admission on one
    device, `lanes` calls at a time, a temporal ring of `capacity` slots
    (the cfg's `kv_capacity` when None)."""

    def __init__(self, engine: MoshiEngine, lanes: int = 32,
                 capacity: Optional[int] = None, chunk_frames: int = 5):
        super().__init__(engine, lanes,
                         capacity or engine.cfg.kv_capacity, chunk_frames)
        # per lane: the call's uniforms (a row a step) and the user's
        # codes (a row a frame)
        self.cfg, self.params = engine.cfg, engine.params
        nq = engine.cfg.n_q
        self._noise = torch.zeros(lanes, self.capacity, 1 + nq,
                                  device=engine.device)
        self._user = torch.zeros(lanes, self.capacity, nq,
                                 dtype=torch.int64, device=engine.device)

    lane_frames = property(lambda self: self.capacity)   # no prompt

    def submit_call(self, codes, seed: Optional[int] = None,
                    history=None) -> Call:
        """A call: the user's Mimi codes (frames, n_q), one row a frame;
        history: None, or (text (a,), codes (a, n_q)), the tokens Moshi
        drew at the call's first a steps, 0 < a < frames, from which it
        resumes."""
        nq = self.engine.cfg.n_q
        codes = np.asarray(codes, np.int64)
        if codes.ndim != 2 or codes.shape[1] != nq or len(codes) < 1:
            raise ValueError(f"a call's codes are (frames, {nq}), not "
                             f"{codes.shape}")
        if history is not None:
            text, own = (np.asarray(x, np.int64) for x in history)
            a = len(text)
            if not (0 < a < len(codes) and own.shape == (a, nq)):
                raise ValueError(f"a call's history is (a,) and (a, {nq}) "
                                 f"with 0 < a < {len(codes)}")
            history = (text, own)
        return self._submit(Call(seed=seed, codes=codes, history=history))

    def _validate(self, req: Call) -> int:
        # its frames and the one that decodes nothing
        return len(req.codes) + 1

    def _reset_epoch(self):
        eng = self.engine
        self.batch = moshi.empty_lanes(eng.cfg, self.lanes, eng.dtype,
                                       eng.device)

    def _write_lanes(self, group):
        """Each call's uniforms and user codes into its lane's rows, the
        lanes reset for it (models/moshi.admit), and each call with a
        history resumed (models/moshi.resume, in a `ptt.prefill` span)."""
        eng = self.engine
        n = self.capacity
        with span("ptt.lane_write", lanes=len(group)):
            for lane, req in group:
                self._noise[lane] = eng.draws(req.seed, n)
                user = torch.from_numpy(req.codes).to(eng.device)
                self._user[lane, : len(user)] = user
            moshi.admit(eng.cfg, self.batch, [lane for lane, _ in group],
                        [len(req.codes) for _, req in group])
        aged = [(lane, req) for lane, req in group if req.history]
        if not aged:
            return
        rows = sum(req.age for _, req in aged)
        with span("ptt.prefill", lanes=len(aged), lanes_padded=len(aged),
                  tokens=rows, token_slots=rows), torch.no_grad():
            for lane, req in aged:
                text, own = (torch.from_numpy(x).to(eng.device)
                             for x in req.history)
                moshi.resume(eng.params, eng.cfg, self.batch, lane,
                             moshi.history_columns(
                                 eng.cfg, text, own, self._user[lane]))

    def _decode_chunk(self):
        self.batch, pcm, valid = decode_chunk(
            self.params, self.cfg, self.chunk_frames, self.batch,
            self._noise, self._user, self.engine.seanet_weights)
        return pcm, valid


def decode_chunk(p, cfg, chunk_frames: int, batch: moshi.MoshiLanes, noise,
                 user, seanet_weights: dict = None):
    """chunk_frames frames of every lane (`frame_graph.run_frames`): (batch,
    pcm (B, chunk, frame), valid (B, chunk)), on the device."""
    return frame_graph.run_frames(
        batch, chunk_frames, lambda i: moshi.frame_step_lanes(
            p, cfg, batch, noise, user, seanet_weights))
