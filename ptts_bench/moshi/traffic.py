"""Moshi's traffic: a mix's parameters and a seed -> a plan of calls.

A mix (`traffic/<name>.json`, the family `moshi`) gives the server's shape
(`lanes`, `chunk_frames`, `capacity`: the temporal ring's slots and the
longest call), `arrivals` as `traffic.py` reads them, and what a call
holds:

- `frames`: {"median", "sigma", "min", "max"}: frames a call, log-normal
  (a frame is 80 ms of both sides' audio);
- `codes`: {"codebooks", "bins"}: the user's stream, uniform codes;
- `sampling`: the text's and the audio's temperature and top-k;
- `pool`: calls in the plan; `sample`: finished calls the correctness
  check compares; `trace_chunks`: chunks the traced run profiles;
- `aged` (a closed loop): {"text_bins"}: the sessions' first calls are
  already under way when the run starts, as in the loop's stationary
  state, so that the window sees the mix of held calls from its first
  step: a call under way at a random instant is drawn with odds in
  proportion to its length (the first `sessions` calls of the plan are
  a draw of the pool without replacement, weighted by length), and its
  age, the steps it has run, is uniform over 0..frames - 1. Its first
  `age` steps' tokens (`history`: text uniform over `text_bins`, codes
  uniform over the codes' bins) are given to the server, which resumes
  the call there.

Every seed gets the same multiset of lengths (the log-normal's quantiles
at the pool's midpoints); the seed orders them and draws each call's seed
(its sampling draws), its user stream's seed and, for an aged call, its
age and its history's seed.
"""
from __future__ import annotations

import dataclasses
import statistics
from typing import List

import numpy as np

from ..weights import sub_seed


@dataclasses.dataclass
class Planned:
    index: int
    frames: int
    seed: int          # the call's draws (the server's request seed)
    codes_seed: int    # the user's stream
    codebooks: int
    bins: int
    due_s: float = 0.0
    age: int = 0            # steps run before the server takes the call
    history_seed: int = 0
    text_bins: int = 0


def lengths(mix: dict) -> np.ndarray:
    """The pool's call lengths in frames, in quantile order."""
    f, pool = mix["frames"], mix["pool"]
    nd = statistics.NormalDist()
    z = np.array([nd.inv_cdf((i + 0.5) / pool) for i in range(pool)])
    n = np.round(f["median"] * np.exp(f["sigma"] * z))
    return np.clip(n, f["min"], f["max"]).astype(int)


def plan(mix: dict, seed: int) -> List[Planned]:
    """The pool of calls in the order they are sent."""
    pool = mix["pool"]
    rng = np.random.default_rng(sub_seed(seed, 3))
    frames = rng.permutation(lengths(mix))
    seeds = rng.integers(1, 1 << 62, size=pool)
    code_seeds = rng.integers(1, 1 << 62, size=pool)
    c = mix["codes"]
    arr = mix["arrivals"]
    aged = mix.get("aged")
    if aged:
        # weighted sampling without replacement: key u^(1 / length)
        n = arr["sessions"]
        keys = rng.random(pool) ** (1.0 / frames)
        first = np.argsort(-keys, kind="stable")[:n]
        rest = np.setdiff1d(np.arange(pool), first)
        frames = frames[np.concatenate([first, rest])]
        ages = rng.integers(0, frames[:n])
        hist_seeds = rng.integers(1, 1 << 62, size=n)
    out = [Planned(i, int(frames[i]), int(seeds[i]), int(code_seeds[i]),
                   c["codebooks"], c["bins"]) for i in range(pool)]
    if aged:
        for i in range(n):
            out[i].age = int(ages[i])
            out[i].history_seed = int(hist_seeds[i])
            out[i].text_bins = aged["text_bins"]
    if arr["kind"] == "open":
        t = 0.0
        for r in out:
            t += float(rng.exponential(1.0 / arr["rate_per_s"]))
            r.due_s = t
    return out


def history(p: Planned):
    """An aged call's tokens of its first `age` steps, (text (age,),
    codes (age, codebooks)) int64, uniform; None for a fresh call."""
    if not p.age:
        return None
    rng = np.random.default_rng(p.history_seed)
    return (rng.integers(0, p.text_bins, size=p.age, dtype=np.int64),
            rng.integers(0, p.bins, size=(p.age, p.codebooks),
                         dtype=np.int64))


def user_codes(p: Planned) -> np.ndarray:
    """The user's codes of a call, (frames, codebooks) int64, uniform."""
    rng = np.random.default_rng(p.codes_seed)
    return rng.integers(0, p.bins, size=(p.frames, p.codebooks),
                        dtype=np.int64)
