"""The one traffic generator: a mix file's parameters and a seed -> a plan.

A mix (`traffic/<name>.json`) gives the server's shape (`lanes`,
`chunk_frames`, `capacity`, `text_bucket`), how requests arrive, and what
they hold:

- `arrivals`: {"kind": "closed", "sessions": N, "ramp_chunks": R,
  "think_chunks": T}: N sessions, session s sending its first request
  before chunk floor(s * R / N) and each next one T chunks after its
  previous one finished; or {"kind": "open", "rate_per_s": r,
  "burst_factor": b, "burst_s": on, "calm_s": off}: Poisson arrivals at r a
  second, b times r during bursts of `burst_s` every `burst_s + calm_s`
  seconds (b = 1: no bursts).
- `words`: {"median", "sigma", "min", "max"}: words a request, log-normal.
- `voices`: {"count", "zipf_s", "min_frames", "max_frames"}: how many
  voices, their Zipf popularity, and the prompt lengths, spaced evenly.
- `temp`: sampling temperature (each request draws its noise from a seed
  of its own); `pool`: requests in the plan; `sample`: finished requests
  the correctness check compares; `trace_chunks`: chunks the traced run
  profiles.

Every seed gets the same multiset of sizes: the word counts are the
log-normal's quantiles at the pool's midpoints, the voice counts Zipf's
shares of the pool, the prompt lengths evenly spaced; the seed only orders
them (and draws the words, the request seeds and, for an open loop, the
arrival times). So two seeds differ in order, never in the work.
"""
from __future__ import annotations

import dataclasses
import json
import re
import statistics
import zlib
from pathlib import Path
from typing import List

import numpy as np

from .weights import sub_seed

_ONSETS = ("b c d f g h j k l m n p r s t v w z br ch cl dr fl gr pl sh st "
           "tr").split()
_VOWELS = "a e i o u ai ea ou".split()
_CODAS = ["", "", "n", "r", "s", "t", "l", "m", "nd", "st"]


@dataclasses.dataclass
class Planned:
    index: int
    text: str
    voice: str
    words: int
    seed: int
    temp: float
    due_s: float = 0.0   # open loop: seconds after the window opens


def load(name: str, root: Path) -> dict:
    return json.loads((root / "traffic" / f"{name}.json").read_text())


def _quantile_words(w: dict, pool: int) -> np.ndarray:
    nd = statistics.NormalDist()
    z = np.array([nd.inv_cdf((i + 0.5) / pool) for i in range(pool)])
    n = np.round(w["median"] * np.exp(w["sigma"] * z))
    return np.clip(n, w["min"], w["max"]).astype(int)


def _zipf_counts(count: int, s: float, pool: int) -> np.ndarray:
    p = 1.0 / np.arange(1, count + 1) ** s
    p /= p.sum()
    c = np.floor(p * pool).astype(int)
    c[: pool - c.sum()] += 1
    return c


def voice_lengths(mix: dict) -> List[int]:
    v = mix["voices"]
    return [int(round(x)) for x in np.linspace(v["min_frames"],
                                               v["max_frames"], v["count"])]


def _word(rng) -> str:
    n = 1 + int(rng.integers(0, 3))
    return "".join(_ONSETS[rng.integers(len(_ONSETS))]
                   + _VOWELS[rng.integers(len(_VOWELS))]
                   + _CODAS[rng.integers(len(_CODAS))] for _ in range(n))


def sentence(rng, words: int) -> str:
    out = []
    for i in range(words):
        w = _word(rng)
        if i and i % 7 == 0 and i < words - 1:
            out[-1] += ","
        out.append(w)
    return " ".join(out)


def plan(mix: dict, seed: int) -> List[Planned]:
    """The pool of requests in the order they are sent."""
    pool = mix["pool"]
    rng = np.random.default_rng(sub_seed(seed, 3))
    words = rng.permutation(_quantile_words(mix["words"], pool))
    names = [f"v{i}" for i in range(mix["voices"]["count"])]
    counts = _zipf_counts(len(names), mix["voices"]["zipf_s"], pool)
    voices = rng.permutation(np.repeat(np.arange(len(names)), counts))
    seeds = rng.integers(1, 1 << 62, size=pool)
    out = [Planned(i, sentence(rng, int(words[i])), names[voices[i]],
                   int(words[i]), int(seeds[i]), float(mix["temp"]))
           for i in range(pool)]
    arr = mix["arrivals"]
    if arr["kind"] == "open":
        t = 0.0
        period = arr.get("burst_s", 0.0) + arr.get("calm_s", 0.0)
        for r in out:
            bursting = period and (t % period) < arr.get("burst_s", 0.0)
            rate = arr["rate_per_s"] * (arr.get("burst_factor", 1.0)
                                        if bursting else 1.0)
            t += float(rng.exponential(1.0 / rate))
            r.due_s = t
    return out


def voice_order(mix: dict, seed: int) -> List[int]:
    """Which prompt length each voice gets (voice v0 is the most popular):
    the evenly spaced lengths in one fixed order, the same for every seed,
    so that every seed's requests carry the same prompt lengths."""
    del seed
    rng = np.random.default_rng(0)
    return [int(x) for x in rng.permutation(voice_lengths(mix))]


class WordTokenizer:
    """The benchmark's tokenizer: words and punctuation marks, each word's
    id its CRC-32 modulo the vocabulary (ids below 16 kept for
    punctuation). Handed to the program and the reference alike."""

    PUNCT = {".": 3, ",": 4, "!": 5, "?": 6, ";": 7, ":": 8}

    def __init__(self, n_bins: int):
        self.n_bins = n_bins

    def encode(self, text: str) -> List[int]:
        ids = []
        for tok in re.findall(r"[A-Za-z']+|[.,!?;:]", text):
            if tok in self.PUNCT:
                ids.append(self.PUNCT[tok])
            else:
                ids.append(16 + zlib.crc32(tok.lower().encode())
                           % (self.n_bins - 16))
        return ids
