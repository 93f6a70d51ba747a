"""The comparison that decides `correct` in Moshi's cells.

After the window, `sample` of the calls the server finished in it
(drawn from the seed, with the longest) are run through the plain float32
reference (`reference.py`) on the same checkpoint (drawn again from the
seed by `weights.py`, apart from the program), teacher-forced on the
tokens the server drew and the user's codes; a call that was under way
when the run started (its age a > 0) is forced on its history's tokens
too, and compared from its step a on, over positions up to its length.
For every sampled call it compares:

- `text_logit_rel`: the served text logits of each step against the
  reference's: the norm of the difference over the reference's norm, the
  worst over the call's steps. Covers the 17 streams' embeddings and the
  delay grid, the temporal transformer through its KV ring (K7) and the
  text head.
- `audio_logit_rel`: the same for each sub-step's logits, the worst over
  steps and sub-steps. Covers the depth transformer, its per-step
  weights and its per-frame KV.
- `pcm_vs_bf16`: the served PCM's distance from the reference's Mimi
  decode of the served codes, over the distance that rounding the
  reference's matrix-product inputs and its PCM to bfloat16 makes
  (`reference.bf16_inputs`). Covers the RVQ, the upsample, the Mimi
  transformer (K2) and SEANet (K3).

Logits are compared, not drawn tokens. Each number is the worst over the
sample; each has its limit in the configuration file. The control
(`reference.lower`: fp8 e4m3 weights and product inputs) gives the same
three numbers in the program's place.
"""
from __future__ import annotations

import gc
import math

import numpy as np

from . import reference, traffic


def _rel(a, b) -> float:
    d, n = float((a - b).norm()), float(b.norm())
    return d / n if n > 0 else (0.0 if d == 0 else math.inf)


def _worst_rel(a, b) -> float:
    """The worst relative error over the leading rows of a and b."""
    a = a.reshape(-1, a.shape[-1]).float()
    b = b.reshape(-1, b.shape[-1]).float()
    return float(((a - b).norm(dim=-1) / b.norm(dim=-1)).max())


def judge(conf: dict, mix: dict, cases, seed: int, device,
          control: bool = False) -> dict:
    """{"checks": {name: (value, limit)}, "correct": bool, "rows": [...],
    "sampled": n}; with control also {"control": {...}, "control_fails"}."""
    import torch
    from ..families.moshi import checkpoint
    flat = checkpoint(conf, seed, device, torch.bfloat16)
    dims = conf["model"]
    ref = reference.Model(flat, dims, reference.configured(), device)
    yard = reference.Model(flat, dims, reference.bf16_inputs(), device)
    low = (reference.Model(flat, dims, reference.lower(), device)
           if control else None)
    names = ("text_logit_rel", "audio_logit_rel", "pcm_vs_bf16")
    worst = dict.fromkeys(names, 0.0)
    ctrl = dict.fromkeys(names, 0.0)
    rows = []
    for case in cases:
        plan = case.sent.plan
        tok = case.tokens.to(device)
        hist = traffic.history(plan)
        if hist is not None:
            tok = torch.cat([torch.from_numpy(
                np.concatenate([hist[0][:, None], hist[1]], 1)).to(device),
                tok])
        a = plan.age
        user = torch.from_numpy(traffic.user_codes(plan)).to(device)
        text, audio, pcm = reference.run_call(ref, tok[:, 0], tok[:, 1:],
                                              user, a)
        yard_d = float((reference.run_mimi(yard, tok[:, 1:], a)
                        - pcm).norm())
        served = torch.as_tensor(case.pcm, device=device).float()
        row = {"frames": case.frames, "age": a,
               "text_logit_rel": _worst_rel(case.text, text),
               "audio_logit_rel": _worst_rel(case.audio, audio),
               "pcm_rel": _rel(served, pcm),
               "pcm_vs_bf16": (float((served - pcm).norm()) / yard_d
                               if yard_d > 0 else math.inf)}
        for k in names:
            worst[k] = max(worst[k], row[k])
        if low is not None:
            c_text, c_audio, c_pcm = reference.run_call(
                low, tok[:, 0], tok[:, 1:], user, a)
            c = {"text_logit_rel": _worst_rel(c_text, text),
                 "audio_logit_rel": _worst_rel(c_audio, audio),
                 "pcm_vs_bf16": float((c_pcm - pcm).norm()) / yard_d}
            for k in names:
                ctrl[k] = max(ctrl[k], c[k])
                row["control_" + k] = c[k]
        rows.append(row)
        del text, audio, pcm
        gc.collect()
    limits = conf["limits"]
    checks = {k: (worst[k], limits[k]) for k in names}
    out = {"checks": checks, "sampled": len(cases), "rows": rows,
           "correct": bool(cases) and all(v <= lim
                                           for v, lim in checks.values())}
    if control:
        out["control"] = ctrl
        out["control_fails"] = any(ctrl[k] > limits[k] for k in names)
    return out
