"""Moshi 7B on the port's continuous-batching server
(`runtime/moshi.MoshiServer`, the ContinuousBatchingServer with Moshi's
model methods, over a `runtime/moshi.MoshiEngine` on a random checkpoint
drawn from the seed on the device by `moshi/weights.py`).

A planned request (`moshi/traffic.py`) is a full-duplex call: the user's
stream of n_q Mimi codes a frame, drawn from the request's own seed, and
a length, and for a call already under way when the run starts its age
and the tokens of its first steps; it is submitted with `submit_call`.
The probe (`Capture`) records, at every frame of every live call, the
text logits, the 8 sub-steps' logits and the drawn tokens, as
`models/moshi.frame_step_lanes` leaves them (~3 MB a frame at 32 lanes,
kept on the device), and which request every lane holds at the first
frame of a chunk; in the traced run it adds the device time of the
kernels launched under the program's `ptt.temporal`, `ptt.depth` and
`ptt.mimi` spans to the trace's summary (`moshi/spans.py`). The judge
(`moshi/judge.py`) teacher-forces the plain float32 reference
(`moshi/reference.py`) on the tokens of 8 calls finished in the window.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

from .. import serve, weights
from ..moshi import flops, judge as _judge, spans, traffic
from ..moshi import weights as moshi_weights

MOSHI = "pocket_tts_tpu_torch.runtime.moshi"
TIMED = {"chunk_s": (MOSHI, "decode_chunk")}
PHASES = {"moshi::decode_chunk": (MOSHI, "decode_chunk")}

plan = traffic.plan
judge = _judge.judge


def frame_size(conf: dict) -> int:
    """PCM samples a frame: the Mimi upsample times SEANet's strides."""
    mimi = conf["model"]["mimi"]
    n = mimi["upsample_stride"]
    for st in mimi["seanet"]["stages"]:
        n *= st["stride"]
    return n


def model_config(conf: dict, mix: Optional[dict] = None):
    """The port's MoshiConfig with the sizes of a configuration file (and
    a mix's sampling)."""
    from pocket_tts_tpu_torch import config as pc

    def fill(obj, spec):
        ch = {}
        for k, v in spec.items():
            cur = getattr(obj, k)
            if dataclasses.is_dataclass(cur):
                ch[k] = fill(cur, v)
            elif k == "stages":
                ch[k] = tuple(pc.SeanetStage(**s) for s in v)
            elif isinstance(cur, tuple):
                ch[k] = tuple(v)
            else:
                ch[k] = v
        return dataclasses.replace(obj, **ch)

    cfg = fill(pc.MoshiConfig(), conf["model"])
    if mix is not None:
        s = mix["sampling"]
        cfg = dataclasses.replace(
            cfg, text_temp=s["text_temp"], text_topk=s["text_topk"],
            audio_temp=s["audio_temp"], audio_topk=s["audio_topk"])
    return cfg


def checkpoint(conf: dict, seed: int, device, dtype):
    """The run's random checkpoint (`moshi/weights.py`), on the device."""
    return moshi_weights.draw(conf["model"], weights.sub_seed(seed, 1),
                              device, dtype)


def build(conf: dict, mix: dict, seed: int, device, dtype):
    """The server of a configuration and mix: a MoshiServer over a
    MoshiEngine on the checkpoint drawn on the device."""
    from pocket_tts_tpu_torch.io import moshi_params
    from pocket_tts_tpu_torch.runtime.moshi import MoshiEngine, MoshiServer
    cfg = model_config(conf, mix)
    flat = checkpoint(conf, seed, device, dtype)
    eng = MoshiEngine(moshi_params.params_from_flat(flat, cfg, dtype,
                                                    device),
                      cfg, dtype, device,
                      seed=weights.sub_seed(seed, 5) % (1 << 62))
    return MoshiServer(eng, lanes=mix["lanes"], capacity=mix["capacity"],
                       chunk_frames=mix["chunk_frames"])


def submit(srv, p: traffic.Planned):
    return srv.submit_call(traffic.user_codes(p), seed=p.seed,
                           history=traffic.history(p))


def warm(srv, mix: dict, planned):
    """Nothing to warm ahead of the first step: the calls under way are
    resumed at their admission, and the first frame captures the lane
    frame's graphs."""


class Capture:
    """At each frame, the text and audio logits and the drawn tokens of
    every live call; at each chunk's first frame, which request every
    lane holds."""

    def __init__(self, srv, chunk_frames: int):
        import torch
        from pocket_tts_tpu_torch.models import moshi
        from .. import trace
        self.srv = srv
        self.cf = chunk_frames
        self.frames = 0
        self.lanes: Dict[int, list] = {}
        self.rec: Dict[int, dict] = {}
        self.sel, self.idx = [], None
        self.annotate = False
        self.orig = moshi.frame_step_lanes
        self._trace, self._reduce = trace, trace.reduce
        trace.reduce = spans.with_spans(trace.reduce)
        cap = self

        def keep(state):
            i = cap.frames
            if i % cap.cf == 0:
                live = list(cap.srv._live)
                cap.lanes[i // cap.cf] = live
                cap.sel = [(lane, r) for lane, r in enumerate(live)
                           if r is not None]
                cap.idx = torch.tensor([lane for lane, _ in cap.sel],
                                       dtype=torch.long,
                                       device=state.pos.device)
            cap.frames += 1
            if not cap.sel:
                return
            text = state.text_logits.index_select(0, cap.idx)
            audio = state.audio_logits.index_select(0, cap.idx)
            tok = state.tokens.index_select(0, cap.idx)
            for j, (_, r) in enumerate(cap.sel):
                d = cap.rec.setdefault(id(r), {"text": [], "audio": [],
                                               "tokens": []})
                d["text"].append(text[j])
                d["audio"].append(audio[j])
                d["tokens"].append(tok[j])

        def frame_step_lanes(p, cfg, state, *a, **k):
            if not cap.annotate:
                out = cap.orig(p, cfg, state, *a, **k)
                keep(state)
                return out
            with torch.profiler.record_function("moshi::frame"):
                out = cap.orig(p, cfg, state, *a, **k)
            with torch.profiler.record_function("bench::probe"):
                keep(state)
            return out

        self.hits = serve.patch_everywhere(
            self.orig, serve.same_attributes(frame_step_lanes, self.orig))

    def lane_of(self, req, admit_step: int) -> Optional[int]:
        live = self.lanes.get(admit_step)
        if live is None:
            return None
        for lane, r in enumerate(live):
            if r is req:
                return lane
        return None

    def recorded(self, req, steps: int):
        """(tokens (steps, 1 + n_q), text (steps, V), audio (steps, n_q,
        card)) of the first `steps` frames the server ran of a call, or
        None."""
        import torch
        d = self.rec.get(id(req))
        if d is None or len(d["tokens"]) < steps:
            return None
        return tuple(torch.stack(d[k][:steps]) for k in ("tokens", "text",
                                                         "audio"))

    def close(self):
        serve.unpatch(self.hits)
        self._trace.reduce = self._reduce


def model_flops(run, cap, conf, mix) -> float:
    """Moshi's operations for each frame a lane emitted in the traced
    chunks (`moshi/flops.py`): a call's step t emits from t = 1 on, or
    from its age on where it was resumed, and Mimi decodes its frames
    from that first one."""
    m = conf["model"]
    first, last = run.notes["traced_steps"]
    total = 0.0
    for c in range(first, last):
        for req in cap.lanes.get(c, []):
            if req is None:
                continue
            n, lo = len(req.codes), max(req.age, 1)
            for i in range(run.chunk_frames):
                t = req.age + (c - req.admit_step) * run.chunk_frames + i
                if lo <= t <= n:
                    total += flops.frame(m, t, t - lo)
    return total


@dataclasses.dataclass
class Case:
    """One sampled call with what the server gave it: `frames` the
    positions it reached (its length), the longest one sampled first."""
    sent: object
    lane: int
    frames: int
    tokens: object = None
    text: object = None
    audio: object = None
    pcm: object = None


def sample(run, cap, mix, seed) -> list:
    """`mix["sample"]` of the calls finished in the window (the longest,
    the rest drawn from the seed), each with its tokens, logits and
    PCM."""
    from ..compare import pick
    cands = []
    for s in run.sent:
        if s.done_step is None or not (run.open_step < s.done_step
                                       <= run.close_step):
            continue
        lane = cap.lane_of(s.req, s.req.admit_step)
        n = len(s.req.codes)
        if lane is not None and s.req.pcm.size and cap.recorded(
                s.req, _served(s.req)):
            cands.append(Case(s, lane, n))
    cases = pick(cands, mix["sample"], seed)
    for c in cases:
        c.tokens, c.text, c.audio = cap.recorded(c.sent.req,
                                                 _served(c.sent.req))
        c.pcm = c.sent.req.pcm
    # the rest of the records go before the reference runs
    cap.rec.clear()
    return cases


def _served(req) -> int:
    """The steps the server ran of a call: n + 1 from step 0, or n + 1 -
    a from its age a."""
    return len(req.codes) + 1 - req.age

