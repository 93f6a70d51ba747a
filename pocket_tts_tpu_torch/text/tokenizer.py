"""Tokenizer front-end.

The port's own copy of `pocket_tts_tpu/text/tokenizer.py`.

The real model uses a SentencePiece unigram tokenizer
(ref: src/config.h:19-20, conditioners/text.h:10-27). The execution path is
the self-contained parser+Viterbi in `spm.py` (no pip dependency); a
deterministic word/punct fallback (`MockTokenizer`) exists ONLY for
random-weights runs and tests. `load_tokenizer` fails loudly when a model
file should exist but can't be used — real weights must never silently pair
with the mock.
"""
from __future__ import annotations

import hashlib
import os
import re
from typing import List

from .spm import UnigramTokenizer


class SentencePieceTokenizer:
    """Real tokenizer over a `tokenizer.model` file (self-contained spm)."""

    def __init__(self, model_path: str):
        self._sp = UnigramTokenizer.from_file(model_path)
        self.model_path = model_path

    def encode(self, text: str) -> List[int]:
        return self._sp.encode(text)

    def decode(self, ids: List[int]) -> str:
        return self._sp.decode(list(ids))

    @property
    def vocab_size(self) -> int:
        return self._sp.vocab_size


class MockTokenizer:
    """Deterministic fallback tokenizer with the same interface.

    Tokenizes into words and punctuation pieces. Mirrors the real tokenizer's
    protocol used by split_into_best_sentences (text.h:135-143):
    encode(".!...?") = [<wordsep>, '.', '!', '...', '?'] where the first id is
    dropped by the caller.
    """

    # fixed ids matching the reference's observed sentencepiece ids
    PUNCT_IDS = {"▁": 260, ".": 263, "!": 682, "...": 799, "?": 292}
    _SPLIT = re.compile(r"(\.\.\.|[.!?,;:])|\s+")

    def __init__(self, n_bins: int = 4000):
        self.n_bins = n_bins
        self._id2piece = {v: k for k, v in self.PUNCT_IDS.items()}

    def _word_id(self, word: str) -> int:
        h = int(hashlib.md5(word.encode()).hexdigest(), 16)
        wid = 1000 + (h % (self.n_bins - 1000))
        self._id2piece[wid] = word
        return wid

    def encode(self, text: str) -> List[int]:
        ids: List[int] = [self.PUNCT_IDS["▁"]]
        pos = 0
        for m in self._SPLIT.finditer(text):
            if m.start() > pos:
                ids.append(self._word_id(text[pos:m.start()]))
            punct = m.group(1)
            if punct:
                ids.append(self.PUNCT_IDS.get(punct, self._word_id(punct)))
            pos = m.end()
        if pos < len(text):
            ids.append(self._word_id(text[pos:]))
        return ids

    def decode(self, ids: List[int]) -> str:
        pieces = []
        for i in ids:
            piece = self._id2piece.get(i, "")
            if piece == "▁":
                continue
            pieces.append(piece)
        out = ""
        for piece in pieces:
            if piece in (".", "!", "?", "...", ",", ";", ":"):
                out += piece
            else:
                out += (" " if out else "") + piece
        return out


def load_tokenizer(model_path=None, n_bins: int = 4000,
                   allow_mock: bool = False):
    """Load the real tokenizer; fail LOUDLY instead of degrading.

    - model_path exists      -> parse it; parse errors propagate (a corrupt
                                or non-unigram model must never silently
                                become the mock).
    - model_path missing     -> FileNotFoundError, unless allow_mock=True
                                (random-weights / test runs).
    - model_path is None     -> MockTokenizer (explicitly mock-only mode).
    """
    if model_path is None:
        return MockTokenizer(n_bins)
    if os.path.exists(model_path):
        return SentencePieceTokenizer(model_path)
    if allow_mock:
        return MockTokenizer(n_bins)
    raise FileNotFoundError(
        f"tokenizer model not found: {model_path}. Real weights require the "
        "release tokenizer.model; pass tokenizer=MockTokenizer(...) or "
        "allow_mock=True only for random-weight runs.")
