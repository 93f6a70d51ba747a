"""Text preprocessing + streaming sentence splitter.

The port's own copy of `pocket_tts_tpu/text/preprocess.py`.

Behavioral port of src/pocket_tts/conditioners/text.h:39-251.
"""
from __future__ import annotations

from collections import deque
from typing import List, Tuple

EOS_CHARS = ".!?"


def merge_whitespaces(text: str) -> str:
    """Collapse whitespace runs to single spaces. ref: text.h:53-67."""
    out = []
    was_space = True
    for c in text:
        if not c.isspace():
            out.append(c)
        elif not was_space:
            out.append(" ")
        was_space = c.isspace()
    return "".join(out)


def count_words(text: str) -> int:
    return len(text.split())


def prepare_text_prompt(text: str) -> Tuple[str, int]:
    """Normalize a prompt; returns (text, frames_after_eos_guess).

    ref: text.h:102-124 — strip, merge whitespace, capitalize first char,
    ensure trailing punctuation, pad 8 leading spaces when under 5 words;
    frames_after_eos = 3 if <=4 words else 1.
    """
    text = text.strip()
    if not text:
        raise ValueError("Text prompt cannot be empty")
    text = merge_whitespaces(text)
    n_words = count_words(text)
    frames_after_eos_guess = 3 if n_words <= 4 else 1
    text = text[0].upper() + text[1:]
    if text[-1].isalnum():
        text += "."
    if n_words < 5:
        text = "        " + text
    return text, frames_after_eos_guess


def hard_chunk_token_ids(tokenizer, ids: List[int],
                         max_tokens: int = 50) -> List[str]:
    """Force-split an over-long token run at plain token boundaries.

    The reference never bounds a single sentence (text.h:157-175 only
    groups whole sentences), so a punctuation-free run-on overflows its KV
    cache (the unhandled TODO at src/pocket_tts.cpp:425). We instead slice
    the ids into <= max_tokens windows and decode each back to text.
    """
    return [tokenizer.decode(ids[i:i + max_tokens]).strip()
            for i in range(0, len(ids), max_tokens)]


def split_into_best_sentences(tokenizer, text: str,
                              max_tokens: int = 50) -> List[str]:
    """Split on EOS token ids, then greedily re-chunk to <= max_tokens.

    ref: text.h:126-178 — EOS ids are encode(".!...?") minus its first
    token; sentences are token runs ending on an EOS id; chunks join
    sentences with a space while the token budget allows. Divergence: a
    single sentence longer than max_tokens is hard-split (see
    hard_chunk_token_ids) instead of passed through unbounded.
    """
    tokens = tokenizer.encode(text)
    eos_ids = tokenizer.encode(".!...?")[1:]
    sentences: List[List[int]] = [[]]
    for tok in tokens:
        sentences[-1].append(tok)
        if tok in eos_ids:
            sentences.append([])
    if not sentences[-1]:
        sentences.pop()

    chunks = [""]
    n_in_chunk = 0
    for toks in sentences:
        if len(toks) > max_tokens:
            if chunks[-1]:
                chunks.append("")
            hard = hard_chunk_token_ids(tokenizer, toks, max_tokens)
            chunks[-1] = hard[0]
            chunks.extend(hard[1:])
            chunks.append("")
            n_in_chunk = 0
            continue
        if n_in_chunk != 0:
            if n_in_chunk + len(toks) > max_tokens:
                n_in_chunk = 0
                chunks.append("")
            else:
                chunks[-1] += " "
        chunks[-1] += tokenizer.decode(toks)
        n_in_chunk += len(toks)
    return [c for c in chunks if c]


class StrProcessor:
    """Char-level incremental sentence splitter for the streaming API.

    A sentence boundary is the first non-EOS char after an EOS char;
    whitespace runs merge; first char of each sentence is capitalized;
    flush appends '.' if needed. ref: str_processor_*, text.h:191-251.
    """

    def __init__(self):
        self.reset()

    def reset(self):
        self.tail = ""
        self.sentences: deque = deque()
        self.was_whitespace = True
        self.was_eos = False
        self.leading_char = True

    def ingest(self, chunk: str):
        if not chunk:
            return
        for c in chunk:
            is_eos = c in EOS_CHARS
            if not is_eos and self.was_eos:
                self.sentences.append(self.tail)
                self.tail = ""
                self.was_whitespace = True
                self.leading_char = True
            is_ws = c.isspace()
            if is_ws and not self.was_whitespace:
                self.tail += " "
            elif not is_ws:
                if self.leading_char:
                    c = c.upper()
                    self.leading_char = False
                self.tail += c
            self.was_whitespace = is_ws
            self.was_eos = is_eos

    def flush(self):
        if self.tail:
            if self.tail[-1].isalnum():
                self.tail += "."
            self.sentences.append(self.tail)
            self.tail = ""
        self.was_whitespace = True
        self.was_eos = False
        self.leading_char = True
