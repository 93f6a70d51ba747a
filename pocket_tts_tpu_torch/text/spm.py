"""Self-contained SentencePiece unigram tokenizer (zero dependencies).

The port's own copy of `pocket_tts_tpu/text/spm.py`.

The reference links libsentencepiece and loads the shipped
``tokenizer.model`` (ref: src/pocket_tts.cpp:8,
src/pocket_tts/conditioners/text.h:10-27).  This module re-implements the
inference half of that library from scratch so the package can consume
the exact release artifact without a pip dependency:

* a protobuf **wire-format** parser for the ``ModelProto`` message
  (sentencepiece_model.proto) — pieces, scores, piece types, trainer spec
  (unk/bos/eos ids, byte_fallback), normalizer spec;
* unigram **Viterbi** encoding over the normalized text with unknown-piece
  penalty (min_score − 10, matching unigram_model.cc) and optional byte
  fallback;
* decoding with byte-piece reassembly, control-piece skipping and the
  dummy-prefix space strip.

Normalization: when the model ships a ``precompiled_charsmap`` (the
release ``nmt_nfkc`` artifact does), the EXACT normalizer runs — the
compiled rule trie applied with libsentencepiece's normalizer.cc
algorithm (text/charsmap.py), byte-identical to the reference for any
input.  Models without a charsmap fall back to a documented
approximation: ``unicodedata.normalize("NFKC")`` plus NMT
whitespace/control cleanup (identical for ASCII prompts).
"""
from __future__ import annotations

import struct
import unicodedata
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from .charsmap import PrecompiledCharsmap

SPACE = "▁"  # ▁ — sentencepiece whitespace escape

# ModelProto.SentencePiece.Type
NORMAL = 1
UNKNOWN = 2
CONTROL = 3
USER_DEFINED = 4
UNUSED = 5
BYTE = 6

_UNK_PENALTY = 10.0  # kUnkPenalty, unigram_model.cc
_DEFAULT_UNK_SURFACE = " ⁇ "  # " ⁇ ", sentencepiece_processor.cc


# ---------------------------------------------------------------------------
# protobuf wire format (read + write) — just enough for ModelProto
# ---------------------------------------------------------------------------

def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        if pos >= len(buf):
            raise ValueError("truncated varint in tokenizer.model")
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7
        if shift > 63:
            raise ValueError("varint too long in tokenizer.model")


def _scan_fields(buf: bytes):
    """Yield (field_number, wire_type, value) over one message's bytes."""
    pos = 0
    n = len(buf)
    while pos < n:
        tag, pos = _read_varint(buf, pos)
        fnum, wtype = tag >> 3, tag & 7
        if wtype == 0:  # varint
            val, pos = _read_varint(buf, pos)
        elif wtype == 1:  # fixed64
            val = buf[pos:pos + 8]
            pos += 8
        elif wtype == 2:  # length-delimited
            ln, pos = _read_varint(buf, pos)
            val = buf[pos:pos + ln]
            if len(val) != ln:
                raise ValueError("truncated field in tokenizer.model")
            pos += ln
        elif wtype == 5:  # fixed32
            val = buf[pos:pos + 4]
            pos += 4
        else:
            raise ValueError(f"unsupported protobuf wire type {wtype}")
        yield fnum, wtype, val


def _write_varint(out: bytearray, v: int):
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return


def _write_tag(out: bytearray, fnum: int, wtype: int):
    _write_varint(out, (fnum << 3) | wtype)


def _write_len(out: bytearray, fnum: int, payload: bytes):
    _write_tag(out, fnum, 2)
    _write_varint(out, len(payload))
    out.extend(payload)


def _write_float(out: bytearray, fnum: int, v: float):
    _write_tag(out, fnum, 5)
    out.extend(struct.pack("<f", v))


def _write_uvarint_field(out: bytearray, fnum: int, v: int):
    _write_tag(out, fnum, 0)
    _write_varint(out, v & 0xFFFFFFFFFFFFFFFF if v >= 0
                  else v + (1 << 64))


# ---------------------------------------------------------------------------
# model proto
# ---------------------------------------------------------------------------

@dataclass
class SentencePieceModel:
    pieces: List[str] = field(default_factory=list)
    scores: List[float] = field(default_factory=list)
    types: List[int] = field(default_factory=list)
    model_type: int = 1          # TrainerSpec.ModelType.UNIGRAM
    unk_id: int = 0
    bos_id: int = 1
    eos_id: int = 2
    pad_id: int = -1
    byte_fallback: bool = False
    unk_surface: str = _DEFAULT_UNK_SURFACE
    normalizer_name: str = "nmt_nfkc"
    precompiled_charsmap: bytes = b""
    add_dummy_prefix: bool = True
    remove_extra_whitespaces: bool = True
    escape_whitespaces: bool = True

    @classmethod
    def parse(cls, data: bytes) -> "SentencePieceModel":
        m = cls()
        saw_piece = False
        for fnum, wtype, val in _scan_fields(data):
            if fnum == 1 and wtype == 2:  # repeated SentencePiece
                piece, score, ptype = "", 0.0, NORMAL
                for f2, w2, v2 in _scan_fields(val):
                    if f2 == 1 and w2 == 2:
                        piece = v2.decode("utf-8")
                    elif f2 == 2 and w2 == 5:
                        score = struct.unpack("<f", v2)[0]
                    elif f2 == 3 and w2 == 0:
                        ptype = v2
                m.pieces.append(piece)
                m.scores.append(score)
                m.types.append(ptype)
                saw_piece = True
            elif fnum == 2 and wtype == 2:  # TrainerSpec
                for f2, w2, v2 in _scan_fields(val):
                    if w2 != 0:
                        continue
                    sv = v2 - (1 << 64) if v2 >> 63 else v2
                    if f2 == 3:
                        m.model_type = v2
                    elif f2 == 35:
                        m.byte_fallback = bool(v2)
                    elif f2 == 40:
                        m.unk_id = sv
                    elif f2 == 41:
                        m.bos_id = sv
                    elif f2 == 42:
                        m.eos_id = sv
                    elif f2 == 43:
                        m.pad_id = sv
            elif fnum == 3 and wtype == 2:  # NormalizerSpec
                for f2, w2, v2 in _scan_fields(val):
                    if f2 == 1 and w2 == 2:
                        m.normalizer_name = v2.decode("utf-8")
                    elif f2 == 2 and w2 == 2:
                        m.precompiled_charsmap = v2
                    elif f2 == 3 and w2 == 0:
                        m.add_dummy_prefix = bool(v2)
                    elif f2 == 4 and w2 == 0:
                        m.remove_extra_whitespaces = bool(v2)
                    elif f2 == 5 and w2 == 0:
                        m.escape_whitespaces = bool(v2)
        if not saw_piece:
            raise ValueError(
                "not a SentencePiece model: no pieces found in ModelProto")
        if m.model_type != 1:
            raise ValueError(
                f"unsupported SentencePiece model_type={m.model_type} "
                "(only UNIGRAM=1 is implemented)")
        return m

    def serialize(self) -> bytes:
        """Write the ModelProto back to wire format (fixtures + export)."""
        out = bytearray()
        for piece, score, ptype in zip(self.pieces, self.scores, self.types):
            sub = bytearray()
            _write_len(sub, 1, piece.encode("utf-8"))
            _write_float(sub, 2, score)
            if ptype != NORMAL:
                _write_uvarint_field(sub, 3, ptype)
            _write_len(out, 1, bytes(sub))
        tspec = bytearray()
        _write_uvarint_field(tspec, 3, self.model_type)
        if self.byte_fallback:
            _write_uvarint_field(tspec, 35, 1)
        _write_uvarint_field(tspec, 40, self.unk_id)
        _write_uvarint_field(tspec, 41, self.bos_id)
        _write_uvarint_field(tspec, 42, self.eos_id)
        _write_uvarint_field(tspec, 43, self.pad_id)
        _write_len(out, 2, bytes(tspec))
        nspec = bytearray()
        _write_len(nspec, 1, self.normalizer_name.encode("utf-8"))
        if self.precompiled_charsmap:
            _write_len(nspec, 2, self.precompiled_charsmap)
        _write_uvarint_field(nspec, 3, int(self.add_dummy_prefix))
        _write_uvarint_field(nspec, 4, int(self.remove_extra_whitespaces))
        _write_uvarint_field(nspec, 5, int(self.escape_whitespaces))
        _write_len(out, 3, bytes(nspec))
        return bytes(out)


# ---------------------------------------------------------------------------
# unigram tokenizer
# ---------------------------------------------------------------------------

class UnigramTokenizer:
    """Viterbi encoder / decoder over a parsed SentencePieceModel."""

    def __init__(self, model: SentencePieceModel):
        self.model = model
        self._vocab: Dict[str, int] = {}
        self._byte_ids: Dict[int, int] = {}
        min_score = 0.0
        for i, (piece, score, ptype) in enumerate(
                zip(model.pieces, model.scores, model.types)):
            if ptype in (NORMAL, USER_DEFINED):
                # latest duplicate wins in sentencepiece; keep the first
                # (release vocabs have no duplicates)
                self._vocab.setdefault(piece, i)
                min_score = min(min_score, score)
            elif ptype == BYTE:
                # pieces are "<0xNN>"
                self._byte_ids[int(piece[1:-1], 16)] = i
        self._max_piece_len = max(
            (len(p) for p in self._vocab), default=1)
        self._unk_score = min_score - _UNK_PENALTY
        self._charsmap = (PrecompiledCharsmap(model.precompiled_charsmap)
                          if model.precompiled_charsmap else None)
        if model.byte_fallback and len(self._byte_ids) != 256:
            raise ValueError(
                "byte_fallback model is missing byte pieces "
                f"({len(self._byte_ids)}/256 found)")

    @classmethod
    def from_file(cls, path: str) -> "UnigramTokenizer":
        with open(path, "rb") as f:
            data = f.read()
        try:
            return cls(SentencePieceModel.parse(data))
        except ValueError as e:
            raise ValueError(f"failed to load tokenizer model {path}: {e}") \
                from e

    # -- normalization ------------------------------------------------------
    def normalize(self, text: str) -> str:
        if self._charsmap is not None:
            return self._normalize_exact(text)
        m = self.model
        if "nfkc" in m.normalizer_name:
            text = unicodedata.normalize("NFKC", text)
        if m.normalizer_name.startswith("nmt"):
            # NMT rules: control/format chars drop (ws-like ones -> space),
            # all whitespace unifies to ' '
            out = []
            for c in text:
                if unicodedata.category(c) in ("Cc", "Cf"):
                    if c in "\t\n\r\v\f":
                        out.append(" ")
                    continue
                out.append(" " if c.isspace() else c)
            text = "".join(out)
        if m.remove_extra_whitespaces:
            text = " ".join(text.split())
        if not text:
            return ""
        if m.add_dummy_prefix:
            text = " " + text
        if m.escape_whitespaces:
            text = text.replace(" ", SPACE)
        return text

    def _normalize_exact(self, text: str) -> str:
        """libsentencepiece normalizer.cc Normalize(), byte level: the
        charsmap trie supplies every per-character rule (for nmt_nfkc the
        compiled rules subsume NFKC *and* the NMT control/whitespace
        cleanup); this loop adds only the spec-driven framing — leading
        whitespace skip, dummy prefix, in-piece heading-space removal
        after a space, ▁-escaping, trailing-space strip."""
        m = self.model
        cm = self._charsmap
        data = text.encode("utf-8")
        i, n = 0, len(data)
        if m.remove_extra_whitespaces:
            while i < n:
                sp, consumed = cm.normalize_prefix(data, i)
                if sp != b" ":
                    break
                i += consumed
        if i >= n:
            return ""
        space = SPACE.encode("utf-8") if m.escape_whitespaces else b" "
        out = bytearray()
        if m.add_dummy_prefix:
            out += space
        is_prev_space = m.remove_extra_whitespaces
        while i < n:
            sp, consumed = cm.normalize_prefix(data, i)
            if is_prev_space:
                sp = sp.lstrip(b" ")
            if sp:
                if m.escape_whitespaces:
                    out += sp.replace(b" ", space)
                else:
                    out += sp
                is_prev_space = sp.endswith(b" ")
            i += consumed
            if not m.remove_extra_whitespaces:
                is_prev_space = False
        if m.remove_extra_whitespaces:
            while out.endswith(space):
                del out[len(out) - len(space):]
        return out.decode("utf-8")

    # -- encode -------------------------------------------------------------
    def encode(self, text: str) -> List[int]:
        s = self.normalize(text)
        n = len(s)
        if n == 0:
            return []
        NEG = float("-inf")
        best = [NEG] * (n + 1)
        best[0] = 0.0
        # back[i] = (start, piece_id or -1 for unk char)
        back: List[Optional[Tuple[int, int]]] = [None] * (n + 1)
        vocab = self._vocab
        scores = self.model.scores
        maxlen = self._max_piece_len
        for i in range(n):
            b = best[i]
            if b == NEG:
                continue
            top = min(maxlen, n - i)
            for ln in range(1, top + 1):
                pid = vocab.get(s[i:i + ln])
                if pid is not None:
                    cand = b + scores[pid]
                    if cand > best[i + ln]:
                        best[i + ln] = cand
                        back[i + ln] = (i, pid)
            # unknown single-char edge (always available)
            cand = b + self._unk_score
            if cand > best[i + 1]:
                best[i + 1] = cand
                back[i + 1] = (i, -1)
        # walk back
        rev: List[int] = []
        pos = n
        m = self.model
        while pos > 0:
            start, pid = back[pos]  # type: ignore[misc]
            if pid >= 0:
                rev.append(pid)
            elif m.byte_fallback:
                for byte in reversed(s[start:pos].encode("utf-8")):
                    rev.append(self._byte_ids[byte])
            else:
                # merge runs of unknown chars into one unk token
                # (unigram_model.cc merges consecutive unknowns)
                if not rev or rev[-1] != m.unk_id:
                    rev.append(m.unk_id)
            pos = start
        rev.reverse()
        return rev

    def encode_as_pieces(self, text: str) -> List[str]:
        return [self.model.pieces[i] for i in self.encode(text)]

    # -- decode -------------------------------------------------------------
    def decode(self, ids: List[int]) -> str:
        m = self.model
        parts: List[str] = []
        byte_buf = bytearray()

        def flush_bytes():
            if byte_buf:
                parts.append(byte_buf.decode("utf-8", errors="replace"))
                byte_buf.clear()

        for i in ids:
            if not 0 <= i < len(m.pieces):
                raise ValueError(f"token id {i} out of range "
                                 f"(vocab {len(m.pieces)})")
            ptype = m.types[i]
            if ptype == BYTE:
                byte_buf.append(int(m.pieces[i][1:-1], 16))
                continue
            flush_bytes()
            if ptype == CONTROL:
                continue
            if ptype == UNKNOWN:
                parts.append(m.unk_surface)
            else:
                parts.append(m.pieces[i])
        flush_bytes()
        text = "".join(parts).replace(SPACE, " ")
        if text.startswith(" "):
            text = text[1:]  # dummy-prefix strip (decoder symmetry)
        return text

    @property
    def vocab_size(self) -> int:
        return len(self.model.pieces)
