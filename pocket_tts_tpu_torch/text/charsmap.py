"""Precompiled-charsmap normalization (sentencepiece `nmt_nfkc`), exact.

The port's own copy of `pocket_tts_tpu/text/charsmap.py` (the port
imports nothing of the JAX package).

The release ``tokenizer.model`` ships its normalizer as a *precompiled
charsmap* inside ``NormalizerSpec.precompiled_charsmap`` — the reference
gets this applied for free by libsentencepiece
(src/pocket_tts.cpp:8, normalizer.cc in the library).
The blob is::

    <trie_size: uint32 LE> <darts-clone double-array trie> <replacements>

where the trie maps UTF-8 byte prefixes to offsets into ``replacements``
(a pool of NUL-terminated UTF-8 strings).  Normalization walks the input
byte stream taking the LONGEST trie match at each position and emitting
its replacement; unmatched positions pass one valid UTF-8 character
through (or U+FFFD for a malformed byte).  For ``nmt_nfkc`` the compiled
rules subsume both NFKC and the NMT control/whitespace cleanup, so no
other per-character logic runs when a charsmap is present.

This module implements:

* :class:`PrecompiledCharsmap` — blob parser + darts-clone
  ``commonPrefixSearch`` reader (unit encoding per darts_clone's
  ``DoubleArrayUnit``: label = ``unit & 0x800000FF``, has_leaf = bit 8,
  offset = ``(unit >> 10) << ((unit & 0x200) >> 6)``, leaf value =
  ``unit & 0x7FFFFFFF`` with bit 31 set);
* :func:`build_charsmap` — a small first-fit double-array *builder*
  producing blobs the reader (and libsentencepiece) accepts, used by
  tests to synthesize rule sets and available for model export.

The pure-python trie walk costs one dict-free array chase per input
byte — microseconds per prompt, nothing for the device path.
"""
from __future__ import annotations

import struct
from typing import Dict, List, Optional, Tuple

_HAS_LEAF = 1 << 8
_EXT = 1 << 9
_LEAF = 1 << 31
_REPLACEMENT = b"\xEF\xBF\xBD"  # U+FFFD


def valid_utf8_len(data: bytes, i: int) -> int:
    """Length of one strictly-valid UTF-8 char at data[i], else 0.

    Mirrors sentencepiece string_util's DecodeUTF8 validity rules:
    trail-byte structure, no overlongs (range floor per length), no
    surrogates, max U+10FFFF.  A literal U+FFFD (EF BF BD) is valid.
    """
    n = len(data)
    b0 = data[i]
    if b0 < 0x80:
        return 1
    if 0xC0 <= b0 < 0xE0:
        if i + 1 < n and 0x80 <= data[i + 1] < 0xC0:
            cp = ((b0 & 0x1F) << 6) | (data[i + 1] & 0x3F)
            if cp >= 0x80:
                return 2
    elif 0xE0 <= b0 < 0xF0:
        if (i + 2 < n and 0x80 <= data[i + 1] < 0xC0
                and 0x80 <= data[i + 2] < 0xC0):
            cp = (((b0 & 0x0F) << 12) | ((data[i + 1] & 0x3F) << 6)
                  | (data[i + 2] & 0x3F))
            if cp >= 0x800 and not 0xD800 <= cp < 0xE000:
                return 3
    elif 0xF0 <= b0 < 0xF8:
        if (i + 3 < n and 0x80 <= data[i + 1] < 0xC0
                and 0x80 <= data[i + 2] < 0xC0
                and 0x80 <= data[i + 3] < 0xC0):
            cp = (((b0 & 0x07) << 18) | ((data[i + 1] & 0x3F) << 12)
                  | ((data[i + 2] & 0x3F) << 6) | (data[i + 3] & 0x3F))
            if 0x10000 <= cp <= 0x10FFFF:
                return 4
    return 0


class PrecompiledCharsmap:
    """Parsed precompiled charsmap: darts trie + replacement pool."""

    def __init__(self, blob: bytes):
        if len(blob) < 4:
            raise ValueError("precompiled_charsmap too short")
        (trie_size,) = struct.unpack_from("<I", blob, 0)
        if trie_size % 4 or 4 + trie_size > len(blob):
            raise ValueError(
                f"precompiled_charsmap: bad trie size {trie_size} "
                f"(blob {len(blob)} bytes)")
        n_units = trie_size // 4
        self._units: Tuple[int, ...] = struct.unpack_from(
            f"<{n_units}I", blob, 4)
        self._normalized = blob[4 + trie_size:]
        self.blob = blob

    def longest_match(self, data: bytes, start: int) -> Tuple[int, int]:
        """(matched_length, value) of the longest trie prefix of
        data[start:], or (0, 0).  darts-clone commonPrefixSearch keeping
        only the longest hit (what normalizer.cc's loop reduces to)."""
        units = self._units
        nu = len(units)
        unit = units[0]
        pos = (unit >> 10) << ((unit & _EXT) >> 6)
        best_len = best_val = 0
        i = start
        n = len(data)
        while i < n:
            c = data[i]
            pos ^= c
            if pos >= nu:
                break
            unit = units[pos]
            if (unit & 0x800000FF) != c:
                break
            pos ^= (unit >> 10) << ((unit & _EXT) >> 6)
            if unit & _HAS_LEAF:
                if pos >= nu:
                    break
                best_len = i + 1 - start
                best_val = units[pos] & 0x7FFFFFFF
            i += 1
        return best_len, best_val

    def replacement(self, value: int) -> bytes:
        """NUL-terminated replacement string at pool offset ``value``."""
        end = self._normalized.find(b"\0", value)
        if end < 0:
            end = len(self._normalized)
        return self._normalized[value:end]

    def normalize_prefix(self, data: bytes, start: int) -> Tuple[bytes, int]:
        """(normalized piece, consumed bytes) at data[start:] — the exact
        Normalizer::NormalizePrefix: longest rule match, else one valid
        UTF-8 char verbatim, else one byte -> U+FFFD."""
        length, value = self.longest_match(data, start)
        if length:
            return self.replacement(value), length
        ln = valid_utf8_len(data, start)
        if ln == 0:
            return _REPLACEMENT, 1
        return data[start:start + ln], ln


# ---------------------------------------------------------------------------
# builder (tests / export)
# ---------------------------------------------------------------------------

class _Node:
    __slots__ = ("children", "value")

    def __init__(self):
        self.children: Dict[int, "_Node"] = {}
        self.value: Optional[int] = None


def _build_darts(keys_values: List[Tuple[bytes, int]]) -> List[int]:
    """First-fit double-array construction in darts-clone's unit
    encoding.  Small rule sets only (normalization charsmaps are; the
    search is O(nodes * probe) but probes rarely pass ~vocab bytes)."""
    root = _Node()
    for key, value in keys_values:
        if not key:
            raise ValueError("charsmap rules cannot map the empty string")
        node = root
        for b in key:
            node = node.children.setdefault(b, _Node())
        node.value = value

    units: Dict[int, int] = {0: 0}
    used = {0}

    def place(node: _Node, pos: int):
        labels = sorted(node.children)
        slots = ([0] if node.value is not None else []) + labels
        base = 1
        while not (all((base ^ c) not in used and (base ^ c) != 0
                       for c in slots)
                   and _enc_offset(pos ^ base) is not None):
            base += 1
        for c in slots:
            used.add(base ^ c)
        # keep the label bits the parent wrote at pos, add offset (+leaf)
        units[pos] = units.get(pos, 0) | _enc_offset(pos ^ base)
        if node.value is not None:
            units[base] = _LEAF | node.value
            units[pos] |= _HAS_LEAF
        for c in labels:
            units[base ^ c] = c
        for c in labels:
            place(node.children[c], base ^ c)

    def _enc_offset(off: int) -> Optional[int]:
        if off < (1 << 21):
            return off << 10
        if off & 0xFF == 0 and (off >> 8) < (1 << 21):
            return ((off >> 8) << 10) | _EXT
        return None

    place(root, 0)
    size = max(units) + 1
    return [units.get(i, 0) for i in range(size)]


def build_charsmap(rules: Dict[str, str]) -> bytes:
    """Compile {source -> replacement} normalization rules into the
    sentencepiece precompiled-charsmap blob format (keys/values as text;
    byte-level rules may be passed as bytes)."""
    pool = bytearray()
    offsets: Dict[bytes, int] = {}
    keys_values: List[Tuple[bytes, int]] = []
    for src in sorted(rules, key=lambda s: s.encode("utf-8")
                      if isinstance(s, str) else s):
        rep = rules[src]
        sb = src.encode("utf-8") if isinstance(src, str) else src
        rb = rep.encode("utf-8") if isinstance(rep, str) else rep
        if rb not in offsets:
            offsets[rb] = len(pool)
            pool += rb + b"\0"
        keys_values.append((sb, offsets[rb]))
    units = _build_darts(keys_values)
    trie = struct.pack(f"<{len(units)}I", *units)
    return struct.pack("<I", len(trie)) + trie + bytes(pool)
