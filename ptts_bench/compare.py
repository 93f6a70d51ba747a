"""The comparison that decides `correct`.

After the window a sample of the requests the server finished in it, drawn
from the seed and holding the longest, is run through the plain reference
(`reference.py`), teacher-forced on the latents the server emitted and
driven by each request's noise, which the reference draws again from the
request's seed. For every sampled request it compares:

- `latent_rel`: the flow step of each served latent (the latent less the
  request's noise, which both sides share) against the reference's, frame
  by frame (each frame conditioned on the served latents before it): the
  norm of the difference over the reference's norm, over the request's
  frames. Covers the text conditioner, the backbone's prefill and decode
  through its KV cache, and the flow net.
- `pcm_rel`: the served PCM against the reference's Mimi decoder over the
  served latents, the same way. Covers de-normalisation, the quantizer
  projection and upsample, the Mimi transformer and SEANet.
- `eos_miss`: requests whose served length disagrees with the reference's
  EOS logits where they lie more than `eos_band` from the threshold (the
  EOS head and the stopping rule). Exact: its limit is 0.

Each number is the worst over the sample; each has its limit in the
configuration file. The control (`lower` precision put in the program's
place) gives the same three numbers from its own latents, PCM and EOS
decisions, on the same served history.
"""
from __future__ import annotations

import math
from typing import List

import numpy as np

from . import reference, traffic, weights


def pick(candidates: list, k: int, seed: int) -> list:
    """k of the candidates (each with `.frames`), the longest among them,
    the rest drawn from the seed."""
    if not candidates:
        return []
    longest = max(range(len(candidates)), key=lambda i: candidates[i].frames)
    rest = [i for i in range(len(candidates)) if i != longest]
    rng = np.random.default_rng(weights.sub_seed(seed, 6))
    chosen = [longest] + list(rng.choice(rest, size=min(k - 1, len(rest)),
                                         replace=False))
    return [candidates[i] for i in chosen]


def noise(seed: int, width: int, latent: int, temp: float, dtype: str,
          device):
    """A request's noise as the configuration serves it: N(0, temp) from
    a torch.Generator seeded with the request's seed on the device,
    `width` frames drawn at once, in the serving type."""
    import torch
    if temp == 0:
        return torch.zeros(width, latent, device=device)
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    z = torch.randn(width, latent, generator=g, device=device,
                    dtype=torch.float32)
    return (float(np.sqrt(np.float32(temp))) * z).to(
        getattr(torch, dtype)).float()


def eos_agrees(logits, n: int, after: int, most: int, thr: float,
               band: float) -> bool:
    """Does a stream that ran n frames agree with these EOS logits? It
    stops `after` frames after its first EOS frame, or at `most`."""
    lg = logits.tolist()
    if n <= 0 or n > most:
        return False
    if n < most:
        e = n - after
        if e < 0 or lg[e] <= thr - band:
            return False
        return not any(x > thr + band for x in lg[:e])
    return not any(x > thr + band for x in lg[:max(most - after, 0)])


def stop_of(logits, n_max: int, after: int, most: int, thr: float) -> int:
    """Frames a stream with these EOS logits runs, up to n_max known."""
    for j, x in enumerate(logits.tolist()[:n_max]):
        if x > thr:
            return min(j + after, most, n_max)
    return n_max


def _rel(a, b) -> float:
    d = float((a - b).norm())
    r = float(b.norm())
    return d / r if r > 0 else (0.0 if d == 0 else math.inf)


class Case:
    """One sampled request with what the server gave it."""

    def __init__(self, sent, lane, frames, latents, pcm):
        self.sent = sent
        self.lane = lane
        self.frames = frames
        self.latents = latents
        self.pcm = pcm


def judge(conf: dict, mix: dict, cases: List[Case], seed: int, device,
          control: bool = False) -> dict:
    """{"checks": {name: (value, limit)}, "correct": bool, ...}; with
    control also {"control": {name: value}}."""
    import torch
    model_spec = conf["model"]
    dims = reference.dims_of(conf)
    flat = weights.checkpoint(model_spec, seed, device)
    lengths = traffic.voice_order(mix, seed)
    prompts = weights.voices(model_spec, lengths, seed, device)
    tok = traffic.WordTokenizer(model_spec["lut"]["n_bins"])
    ref = reference.Model(flat, dims, reference.configured(
        conf["reference"]), device)
    low = (reference.Model(flat, dims, reference.lower(conf["reference"]),
                           device) if control else None)
    del flat
    thr, band = model_spec["eos_threshold"], conf["eos_band"]
    lat_dim = model_spec["latent_dim"]
    worst = {"latent_rel": 0.0, "pcm_rel": 0.0, "eos_miss": 0}
    ctrl = {"latent_rel": 0.0, "pcm_rel": 0.0, "eos_miss": 0}
    rows = []
    for case in cases:
        p = case.sent.plan
        text, after, most = reference.prepare_text(p.text)
        toks = torch.tensor(tok.encode(text), dtype=torch.long,
                            device=device)
        voice = prompts[int(p.voice[1:])]
        n = case.frames
        z = noise(p.seed, mix["capacity"], lat_dim, p.temp,
                  conf["serving"]["dtype"], device)[:n]
        served = case.latents.float().to(device)
        pcm = torch.as_tensor(case.pcm, device=device).float()
        eos, lat, ref_pcm = reference.run_request(ref, voice, toks, served, z)
        row = {"frames": n, "words": p.words, "voice": p.voice,
               "latent_rel": _rel(served - z, lat - z),
               "pcm_rel": _rel(pcm, ref_pcm),
               "eos_max": float(eos.max())}
        worst["latent_rel"] = max(worst["latent_rel"], row["latent_rel"])
        worst["pcm_rel"] = max(worst["pcm_rel"], row["pcm_rel"])
        worst["eos_miss"] += int(not eos_agrees(eos, n, after, most, thr,
                                                band))
        if low is not None:
            c_eos, c_lat, c_pcm = reference.run_request(low, voice, toks,
                                                        served, z)
            ctrl["latent_rel"] = max(ctrl["latent_rel"],
                                     _rel(c_lat - z, lat - z))
            ctrl["pcm_rel"] = max(ctrl["pcm_rel"], _rel(c_pcm, ref_pcm))
            row["control_latent_rel"] = _rel(c_lat - z, lat - z)
            row["control_pcm_rel"] = _rel(c_pcm, ref_pcm)
            n_c = stop_of(c_eos, n, after, most, thr)
            ctrl["eos_miss"] += int(not eos_agrees(eos, n_c, after, most,
                                                   thr, band))
        rows.append(row)
    limits = conf["limits"]
    checks = {k: (worst[k], limits[k]) for k in ("latent_rel", "pcm_rel",
                                                 "eos_miss")}
    out = {"checks": checks, "sampled": len(cases), "rows": rows,
           "correct": bool(cases) and all(v <= lim
                                           for v, lim in checks.values())}
    if control:
        out["control"] = ctrl
        out["control_fails"] = any(ctrl[k] > limits[k] for k in ctrl)
    return out
