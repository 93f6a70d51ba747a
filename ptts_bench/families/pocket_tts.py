"""Kyutai Pocket TTS on the port's continuous-batching server
(`runtime/server.ContinuousBatchingServer` over a `runtime/engine.TTSEngine`
on the benchmark's weights and voices).

A planned request (`traffic.py`: words and a Zipf voice) is submitted as
`(text, voice)`. Each frame's latents are copied as
`models/tts.frame_step_lanes` returns (one small device copy a frame, for
the comparison), and the lane each live request holds is read from the
server at the first frame of a chunk. The traced run times
`runtime/batched.batched_sentence_prefill` (`prefill_s`) and
`continuous_decode_chunk` (`chunk_s`), names the latter's range, and counts
the model's operations with `model_flops.py`. The judge is `compare.judge`
against the float32 reference (`reference.py`, `weights.py`).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

from .. import compare, reference, serve, traffic, weights
from .. import model_flops as mf

BATCHED = "pocket_tts_tpu_torch.runtime.batched"
TIMED = {"prefill_s": (BATCHED, "batched_sentence_prefill"),
         "chunk_s": (BATCHED, "continuous_decode_chunk")}
PHASES = {"batched::continuous_decode_chunk":
          (BATCHED, "continuous_decode_chunk")}

plan = traffic.plan
judge = compare.judge


def frame_size(conf: dict) -> int:
    """PCM samples a frame: the Mimi upsample times SEANet's strides."""
    mimi = conf["model"]["mimi"]
    return mimi["upsample_stride"] * math.prod(
        s["stride"] for s in mimi["seanet"]["stages"])


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


def submit(srv, p: traffic.Planned):
    return srv.submit(p.text, p.voice, temp=p.temp, seed=p.seed)


def warm(srv, mix: dict, planned):
    """One admission prefill at each power-of-two group size up to the
    mix's `warm_groups` (admission pads a group to a power of two), on
    requests of the plan; the ramp warms its own group size."""
    k = 1
    while k <= mix["warm_groups"]:
        reqs = []
        for p in planned[:k]:
            r = submit(srv, p)
            srv._validate(r)
            reqs.append(r)
        srv._queue.clear()
        srv._prefill_many(reqs)
        k *= 2


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

        self.hits = serve.patch_everywhere(
            self.orig, serve.same_attributes(traced, self.orig))

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
        serve.unpatch(self.hits)


def model_flops(run, cap, conf, mix) -> float:
    """The model's operations over the traced chunks: each frame a lane
    emitted there and each text row admitted there."""
    m = conf["model"]
    tok = traffic.WordTokenizer(m["lut"]["n_bins"])
    voice_len = traffic.voice_order(mix, run.seed)
    first, last = run.notes["traced_steps"]
    total = 0.0
    sizes = {}
    for c in range(first, last):
        for req in cap.lanes.get(c, []):
            if req is None:
                continue
            if id(req) not in sizes:
                text = reference.prepare_text(req.text)[0]
                sizes[id(req)] = (voice_len[int(req.voice[1:])],
                                  len(tok.encode(text)))
            nv, nt = sizes[id(req)]
            frames = (req.pcm.size // run.frame_size if req.pcm is not None
                      else math.inf)
            if req.admit_step == c:
                total += sum(mf.prefill_row(m, nv + i + 1)
                             for i in range(nt))
            for i in range(run.chunk_frames):
                j = (c - req.admit_step) * run.chunk_frames + i
                if j < frames:
                    total += mf.frame(m, nv + nt + j + 1, j)
    return total


def sample(run, cap, mix, seed) -> list:
    """The requests the judge compares: `mix["sample"]` of those finished
    in the window (`compare.pick`), each with its latents and PCM."""
    cands = []
    for s in run.sent:
        if s.done_step is None or not (run.open_step < s.done_step
                                       <= run.close_step):
            continue
        lane = cap.lane_of(s.req, s.req.admit_step)
        n = s.req.pcm.size // run.frame_size
        if lane is not None and n > 0:
            cands.append(compare.Case(s, lane, n, None, None))
    cases = compare.pick(cands, mix["sample"], seed)
    for c in cases:
        c.latents = cap.request_latents(c.sent.req, c.lane, c.frames)
        c.pcm = c.sent.req.pcm.reshape(c.frames, run.frame_size)
    return cases
