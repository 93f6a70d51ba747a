"""GGUF read/write for the PyTorch port.

Counterpart of `pocket_tts_tpu/io/gguf.py`, byte for byte on the wire: the
GGUF v3 container (header, metadata codec, tensor infos, aligned data), the
reference's CRC32 shortening of names of GGML_MAX_NAME characters or more
(`shorten_name`), the ggml block codecs Q8_0, Q4_0, Q8_K and Q4_K in
numpy, and `write_gguf`'s divisibility and alignment fallbacks (K-quant ->
32-block -> the source dtype). A file written by either package reads in
the other.

numpy has no bfloat16 and the port loads no ml_dtypes: a BF16 tensor is
read as its raw 16-bit words into a torch.bfloat16 tensor (the same bits),
and `write_gguf` takes torch tensors as well as numpy arrays, writing
torch.bfloat16 as BF16 words. Every other tensor is read as numpy.

Notes carried over from the JAX package:
- dims are stored ggml-style (ne[0] = fastest/contiguous) -- i.e. the
  reversed numpy shape; bytes are identical row-major.
- the reference's shortening loop overwrites each output char, so the
  effective short name is hexdigit((crc >> 8*i) & 0xf) for i in 0..7 --
  with a 32-bit CRC that is 4 low-nibble digits followed by "0000".
"""
from __future__ import annotations

import json
import struct
import zlib
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

GGUF_MAGIC = b"GGUF"
GGUF_VERSION = 3
GGML_MAX_NAME = 64
DEFAULT_ALIGNMENT = 32

# ggml tensor types (ggml.h enum values)
F32, F16, Q4_0, Q8_0 = 0, 1, 2, 8
Q4_K, Q8_K = 12, 15
I8, I16, I32, I64, F64, BF16 = 24, 25, 26, 27, 28, 30

# metadata value types
(_U8, _I8V, _U16, _I16V, _U32, _I32V, _F32V, _BOOL, _STR, _ARR,
 _U64, _I64V, _F64V) = range(13)

_QBLOCK = 32    # elements per Q4_0/Q8_0 block
_QBLOCK_K = 256  # elements per K-quant super-block
_TYPE_SIZES = {F32: 4, F16: 2, BF16: 2, I8: 1, I16: 2, I32: 4, I64: 8,
               F64: 8}
_BLOCK_BYTES = {Q8_0: 2 + _QBLOCK, Q4_0: 2 + _QBLOCK // 2,
                # Q4_K: f16 d + f16 dmin + 12B 6-bit scales/mins + 128B qs
                Q4_K: 2 + 2 + 12 + _QBLOCK_K // 2,
                # Q8_K: f32 d + 256 int8 qs + 16 int16 group sums
                Q8_K: 4 + _QBLOCK_K + 2 * (_QBLOCK_K // 16)}
_BLOCK_ELEMS = {Q8_0: _QBLOCK, Q4_0: _QBLOCK, Q4_K: _QBLOCK_K,
                Q8_K: _QBLOCK_K}


def shorten_name(name: str) -> str:
    """Reference-compatible short name for names >= GGML_MAX_NAME."""
    if len(name) < GGML_MAX_NAME:
        return name
    crc = zlib.crc32(name.encode("utf-8"))  # same params as crc-bbf.h
    out = []
    for _ in range(8):
        out.append("0123456789abcdef"[crc & 0xF])
        crc >>= 8
    return "".join(out)


# ---------------------------------------------------------------------------
# quantized block codecs
# ---------------------------------------------------------------------------

def _rows_for_quant(arr: np.ndarray,
                    block: int = _QBLOCK) -> Optional[np.ndarray]:
    """2-D float view (rows, cols % block == 0) if `arr` is quantizable
    else None. Mirrors the reference's alignment fallback
    (loader.h:162-173)."""
    if arr.ndim < 1 or arr.shape[-1] % block != 0:
        return None
    if isinstance(arr, torch.Tensor):
        if not arr.is_floating_point():
            return None
        arr = arr.detach().cpu().float().numpy()
    if arr.dtype.kind != "f":
        return None
    return np.ascontiguousarray(arr, dtype=np.float32).reshape(
        -1, arr.shape[-1])


def _effective_qtype(qtype: Optional[int],
                     arr: np.ndarray) -> Optional[int]:
    """The reference's divisibility fallback chain (loader.h:162-173):
    Q4_K needs ne[0] % 256 else Q4_0; Q4_0 needs % 32 else the source
    dtype -- and the same for Q8_K -> Q8_0 -> source."""
    if qtype in (Q4_K, Q8_K) and _rows_for_quant(arr, _QBLOCK_K) is None:
        qtype = Q4_0 if qtype == Q4_K else Q8_0
    if qtype in (Q4_0, Q8_0) and _rows_for_quant(arr, _QBLOCK) is None:
        return None
    return qtype


def quantize_q8_0(arr: np.ndarray) -> bytes:
    """ggml Q8_0: per-32-block fp16 scale + 32 int8."""
    rows = _rows_for_quant(arr)
    assert rows is not None
    blocks = rows.reshape(-1, _QBLOCK)
    amax = np.abs(blocks).max(axis=1)
    d = (amax / 127.0).astype(np.float32)
    inv = np.where(d > 0, 1.0 / np.where(d == 0, 1.0, d), 0.0)
    q = np.clip(np.rint(blocks * inv[:, None]), -127, 127).astype(np.int8)
    out = np.zeros((blocks.shape[0], 2 + _QBLOCK), np.uint8)
    out[:, :2] = d.astype(np.float16).view(np.uint8).reshape(-1, 2)
    out[:, 2:] = q.view(np.uint8)
    return out.tobytes()


def dequantize_q8_0(raw: bytes, nelements: int) -> np.ndarray:
    blk = np.frombuffer(raw, np.uint8).reshape(-1, 2 + _QBLOCK)
    d = blk[:, :2].copy().view(np.float16).astype(np.float32).reshape(-1)
    q = blk[:, 2:].copy().view(np.int8).astype(np.float32)
    return (q * d[:, None]).reshape(-1)[:nelements]


def quantize_q4_0(arr: np.ndarray) -> bytes:
    """ggml Q4_0: per-32-block fp16 scale, 4-bit offsets (q-8), nibble j
    holds elem j (low) and elem j+16 (high)."""
    rows = _rows_for_quant(arr)
    assert rows is not None
    blocks = rows.reshape(-1, _QBLOCK)
    # scale from the max-|x| element keeping its sign (ggml convention:
    # d = max_abs_signed / -8 so the extreme maps to index 0 or 15)
    idx = np.abs(blocks).argmax(axis=1)
    mx = blocks[np.arange(blocks.shape[0]), idx]
    d = (mx / -8.0).astype(np.float32)
    inv = np.where(d != 0, 1.0 / np.where(d == 0, 1.0, d), 0.0)
    q = np.clip(np.rint(blocks * inv[:, None]) + 8, 0, 15).astype(np.uint8)
    lo, hi = q[:, :16], q[:, 16:]
    packed = (lo | (hi << 4)).astype(np.uint8)
    out = np.zeros((blocks.shape[0], 2 + 16), np.uint8)
    out[:, :2] = d.astype(np.float16).view(np.uint8).reshape(-1, 2)
    out[:, 2:] = packed
    return out.tobytes()


def dequantize_q4_0(raw: bytes, nelements: int) -> np.ndarray:
    blk = np.frombuffer(raw, np.uint8).reshape(-1, 18)
    d = blk[:, :2].copy().view(np.float16).astype(np.float32).reshape(-1)
    packed = blk[:, 2:]
    lo = (packed & 0xF).astype(np.float32) - 8.0
    hi = (packed >> 4).astype(np.float32) - 8.0
    q = np.concatenate([lo, hi], axis=1)
    return (q * d[:, None]).reshape(-1)[:nelements]


def quantize_q8_k(arr: np.ndarray) -> bytes:
    """ggml Q8_K: per-256 super-block f32 scale + 256 int8 + 16 int16
    group-of-16 sums. Scale convention is ggml's signed-extreme mapping
    (d = max_signed / -128, so the extreme element lands on -128)."""
    rows = _rows_for_quant(arr, _QBLOCK_K)
    assert rows is not None
    blocks = rows.reshape(-1, _QBLOCK_K)
    nb = blocks.shape[0]
    idx = np.abs(blocks).argmax(axis=1)
    mx = blocks[np.arange(nb), idx]
    nz = mx != 0
    iscale = np.where(nz, -128.0 / np.where(nz, mx, 1.0), 0.0)
    q = np.clip(np.rint(blocks * iscale[:, None]), -128, 127).astype(np.int8)
    d = np.where(nz, 1.0 / np.where(nz, iscale, 1.0), 0.0).astype(np.float32)
    bsums = q.astype(np.int32).reshape(nb, 16, 16).sum(axis=2).astype(
        np.int16)
    out = np.zeros((nb, _BLOCK_BYTES[Q8_K]), np.uint8)
    out[:, :4] = d.view(np.uint8).reshape(nb, 4)
    out[:, 4:4 + _QBLOCK_K] = q.view(np.uint8)
    out[:, 4 + _QBLOCK_K:] = bsums.view(np.uint8).reshape(nb, 32)
    return out.tobytes()


def dequantize_q8_k(raw: bytes, nelements: int) -> np.ndarray:
    blk = np.frombuffer(raw, np.uint8).reshape(-1, _BLOCK_BYTES[Q8_K])
    d = blk[:, :4].copy().view(np.float32).reshape(-1)
    q = blk[:, 4:4 + _QBLOCK_K].copy().view(np.int8).astype(np.float32)
    return (q * d[:, None]).reshape(-1)[:nelements]


def _pack_scale_min_k4(ls: np.ndarray, lm: np.ndarray) -> np.ndarray:
    """8x 6-bit scales + 8x 6-bit mins -> 12 bytes per super-block,
    ggml's K_SCALE_SIZE layout (inverse of get_scale_min_k4): bytes 0-3
    carry scales 0-3 (low 6) + scale 4-7 top bits; 4-7 carry mins 0-3 +
    min 4-7 top bits; 8-11 carry the low nibbles of scales/mins 4-7."""
    nb = ls.shape[0]
    out = np.zeros((nb, 12), np.uint8)
    out[:, 0:4] = (ls[:, :4] & 63) | ((ls[:, 4:] >> 4) << 6)
    out[:, 4:8] = (lm[:, :4] & 63) | ((lm[:, 4:] >> 4) << 6)
    out[:, 8:12] = (ls[:, 4:] & 0xF) | ((lm[:, 4:] & 0xF) << 4)
    return out


def _unpack_scale_min_k4(s12: np.ndarray):
    """12 scale bytes -> (8 scales, 8 mins) per super-block, uint8."""
    lo_s = s12[:, 0:4] & 63
    lo_m = s12[:, 4:8] & 63
    hi_s = (s12[:, 8:12] & 0xF) | ((s12[:, 0:4] >> 6) << 4)
    hi_m = (s12[:, 8:12] >> 4) | ((s12[:, 4:8] >> 6) << 4)
    return (np.concatenate([lo_s, hi_s], axis=1),
            np.concatenate([lo_m, hi_m], axis=1))


def quantize_q4_k(arr: np.ndarray) -> bytes:
    """ggml Q4_K: 256-element super-blocks of 8x 32-element sub-blocks;
    per-sub 6-bit scale/min quantized against f16 super scales (d, dmin),
    4-bit offsets with value = d*sc*q - dmin*m. Direct min/max encoder
    (ggml's make_qkx2_quants adds an iterative refinement; the wire format
    is identical and our error stays within one quantization step)."""
    rows = _rows_for_quant(arr, _QBLOCK_K)
    assert rows is not None
    sub = rows.reshape(-1, 8, _QBLOCK)
    nb = sub.shape[0]
    vmax = sub.max(axis=2)
    vmin = np.minimum(sub.min(axis=2), 0.0)   # mins are stored >= 0
    sub_scale = np.maximum(vmax - vmin, 0.0) / 15.0
    sub_min = -vmin
    # quantize the per-sub scales/mins against the STORED f16 supers so
    # encode/decode use identical factors
    d = (sub_scale.max(axis=1) / 63.0).astype(np.float16)
    dmin = (sub_min.max(axis=1) / 63.0).astype(np.float16)
    df = d.astype(np.float32)
    dmf = dmin.astype(np.float32)
    inv_d = np.where(df > 0, 1.0 / np.where(df > 0, df, 1.0), 0.0)
    inv_m = np.where(dmf > 0, 1.0 / np.where(dmf > 0, dmf, 1.0), 0.0)
    ls = np.clip(np.rint(sub_scale * inv_d[:, None]), 0, 63).astype(np.uint8)
    lm = np.clip(np.rint(sub_min * inv_m[:, None]), 0, 63).astype(np.uint8)
    d1 = df[:, None] * ls
    m1 = dmf[:, None] * lm
    inv1 = np.where(d1 > 0, 1.0 / np.where(d1 > 0, d1, 1.0), 0.0)
    q = np.clip(np.rint((sub + m1[:, :, None]) * inv1[:, :, None]),
                0, 15).astype(np.uint8)
    # qs: per 64-element chunk c, byte l = sub[2c][l] | sub[2c+1][l] << 4
    qp = q.reshape(nb, 4, 2, _QBLOCK)
    qs = (qp[:, :, 0] | (qp[:, :, 1] << 4)).reshape(nb, _QBLOCK_K // 2)
    out = np.zeros((nb, _BLOCK_BYTES[Q4_K]), np.uint8)
    out[:, 0:2] = d.view(np.uint8).reshape(nb, 2)
    out[:, 2:4] = dmin.view(np.uint8).reshape(nb, 2)
    out[:, 4:16] = _pack_scale_min_k4(ls, lm)
    out[:, 16:] = qs
    return out.tobytes()


def dequantize_q4_k(raw: bytes, nelements: int) -> np.ndarray:
    blk = np.frombuffer(raw, np.uint8).reshape(-1, _BLOCK_BYTES[Q4_K])
    nb = blk.shape[0]
    d = blk[:, 0:2].copy().view(np.float16).astype(np.float32).reshape(-1)
    dmin = blk[:, 2:4].copy().view(np.float16).astype(np.float32).reshape(-1)
    sc, mn = _unpack_scale_min_k4(blk[:, 4:16])
    qs = blk[:, 16:].reshape(nb, 4, _QBLOCK)
    lo = (qs & 0xF).astype(np.float32)
    hi = (qs >> 4).astype(np.float32)
    vals = np.stack([lo, hi], axis=2).reshape(nb, 8, _QBLOCK)
    out = (d[:, None, None] * sc[:, :, None].astype(np.float32) * vals
           - dmin[:, None, None] * mn[:, :, None].astype(np.float32))
    return out.reshape(-1)[:nelements]


def _tensor_nbytes(ggml_type: int, nelements: int) -> int:
    if ggml_type in _BLOCK_BYTES:
        be = _BLOCK_ELEMS[ggml_type]
        assert nelements % be == 0
        return nelements // be * _BLOCK_BYTES[ggml_type]
    return nelements * _TYPE_SIZES[ggml_type]


def _np_to_ggml(arr) -> Tuple[int, np.ndarray]:
    """(ggml type, numpy array of the bytes to write) of a numpy array or a
    torch tensor (torch.bfloat16: its 16-bit words)."""
    if isinstance(arr, torch.Tensor):
        t = arr.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return BF16, t.view(torch.int16).numpy()
        arr = t.numpy()
    name = arr.dtype.name
    if name == "float32":
        return F32, arr
    if name == "float16":
        return F16, arr
    if name == "int8":
        return I8, arr
    if name == "int16":
        return I16, arr
    if name in ("int32", "uint32"):
        return I32, arr.astype(np.int32)
    if name in ("int64", "uint64"):
        return I64, arr.astype(np.int64)
    if name == "float64":
        return F64, arr
    if name == "bool":
        return I8, arr.astype(np.int8)
    raise ValueError(f"unsupported dtype for GGUF: {arr.dtype}")


def _ggml_to_np(ggml_type: int, raw: bytes, shape: Tuple[int, ...],
                dequantize: bool = True) -> np.ndarray:
    n = int(np.prod(shape)) if shape else 1
    if ggml_type == Q8_0:
        return dequantize_q8_0(raw, n).reshape(shape)
    if ggml_type == Q4_0:
        return dequantize_q4_0(raw, n).reshape(shape)
    if ggml_type == Q8_K:
        return dequantize_q8_k(raw, n).reshape(shape)
    if ggml_type == Q4_K:
        return dequantize_q4_k(raw, n).reshape(shape)
    if ggml_type == BF16:
        words = np.frombuffer(raw, np.int16).reshape(shape).copy()
        return torch.from_numpy(words).view(torch.bfloat16)
    dt = {F32: np.float32, F16: np.float16, I8: np.int8, I16: np.int16,
          I32: np.int32, I64: np.int64, F64: np.float64}[ggml_type]
    return np.frombuffer(raw, dt).reshape(shape)


# ---------------------------------------------------------------------------
# metadata KV codec
# ---------------------------------------------------------------------------

def _w_str(out: bytearray, s: str):
    b = s.encode("utf-8")
    out += struct.pack("<Q", len(b)) + b


def _w_value(out: bytearray, v: Any):
    if isinstance(v, bool):
        out += struct.pack("<I", _BOOL) + struct.pack("<?", v)
    elif isinstance(v, int):
        out += struct.pack("<I", _I64V) + struct.pack("<q", v)
    elif isinstance(v, float):
        out += struct.pack("<I", _F64V) + struct.pack("<d", v)
    elif isinstance(v, str):
        out += struct.pack("<I", _STR)
        _w_str(out, v)
    elif isinstance(v, (list, tuple)):
        out += struct.pack("<I", _ARR)
        if all(isinstance(x, str) for x in v):
            out += struct.pack("<IQ", _STR, len(v))
            for x in v:
                _w_str(out, x)
        elif all(isinstance(x, bool) for x in v):
            out += struct.pack("<IQ", _BOOL, len(v))
            out += struct.pack(f"<{len(v)}?", *v)
        elif all(isinstance(x, int) for x in v):
            out += struct.pack("<IQ", _I64V, len(v))
            out += struct.pack(f"<{len(v)}q", *v)
        elif all(isinstance(x, (int, float)) for x in v):
            out += struct.pack("<IQ", _F64V, len(v))
            out += struct.pack(f"<{len(v)}d", *[float(x) for x in v])
        else:
            raise ValueError("heterogeneous metadata arrays unsupported")
    else:
        raise ValueError(f"unsupported metadata value: {type(v)}")


class _Reader:
    def __init__(self, buf: bytes):
        self.buf = buf
        self.pos = 0

    def take(self, n: int) -> bytes:
        b = self.buf[self.pos:self.pos + n]
        if len(b) != n:
            raise ValueError("truncated GGUF file")
        self.pos += n
        return b

    def u32(self) -> int:
        return struct.unpack("<I", self.take(4))[0]

    def u64(self) -> int:
        return struct.unpack("<Q", self.take(8))[0]

    def s(self) -> str:
        return self.take(self.u64()).decode("utf-8")

    def value(self, vt: int):
        fmt = {_U8: "<B", _I8V: "<b", _U16: "<H", _I16V: "<h", _U32: "<I",
               _I32V: "<i", _F32V: "<f", _BOOL: "<?", _U64: "<Q",
               _I64V: "<q", _F64V: "<d"}
        if vt == _STR:
            return self.s()
        if vt == _ARR:
            et = self.u32()
            n = self.u64()
            return [self.value(et) for _ in range(n)]
        f = fmt[vt]
        return struct.unpack(f, self.take(struct.calcsize(f)))[0]


# ---------------------------------------------------------------------------
# file-level API
# ---------------------------------------------------------------------------

def write_gguf(path: str, tensors: Dict[str, object],
               metadata: Optional[Dict[str, Any]] = None,
               quantize: Optional[str] = None,
               min_quant_size: int = 64 * 64):
    """Write a GGUF v3 file ggml can read.

    tensors: numpy arrays or torch tensors. quantize: None | "q8_0" |
    "q4_0" | "q8_k" | "q4_k" -- applied to float tensors with >=
    min_quant_size elements whose last dim divides the block size; others
    fall down the reference's divisibility chain (K-quant -> 32-block ->
    source dtype, loader.h:162-173).
    """
    qtype = {None: None, "q8_0": Q8_0, "q4_0": Q4_0,
             "q8_k": Q8_K, "q4_k": Q4_K}[quantize]
    metadata = dict(metadata or {})
    metadata.setdefault("general.alignment", DEFAULT_ALIGNMENT)
    align = int(metadata["general.alignment"])

    names = list(tensors.keys())
    short = [shorten_name(n) for n in names]
    if short != names:
        # additive metadata so OUR reader can restore original keys; the
        # reference resolves long keys by shortening at lookup time instead
        metadata["pocket_tts.tensor_names"] = names

    entries = []  # (short_name, ggml_type, ne, payload_bytes)
    for name, sname in zip(names, short):
        arr = tensors[name]
        if not isinstance(arr, torch.Tensor):
            arr = np.asarray(arr)
        gt = None
        eff = (_effective_qtype(qtype, arr)
               if qtype is not None
               and int(np.prod(tuple(arr.shape))) >= min_quant_size
               else None)
        if eff is not None:
            gt = eff
            payload = {Q8_0: quantize_q8_0, Q4_0: quantize_q4_0,
                       Q8_K: quantize_q8_k, Q4_K: quantize_q4_k}[eff](arr)
        else:
            gt, arr2 = _np_to_ggml(arr)
            payload = np.ascontiguousarray(arr2).tobytes()
        ne = list(reversed(tuple(arr.shape))) or [1]
        entries.append((sname, gt, ne, payload))

    out = bytearray()
    out += GGUF_MAGIC
    out += struct.pack("<I", GGUF_VERSION)
    out += struct.pack("<q", len(entries))
    out += struct.pack("<q", len(metadata))
    for k, v in metadata.items():
        _w_str(out, k)
        _w_value(out, v)
    offset = 0
    for sname, gt, ne, payload in entries:
        _w_str(out, sname)
        out += struct.pack("<I", len(ne))
        out += struct.pack(f"<{len(ne)}q", *ne)
        out += struct.pack("<I", gt)
        out += struct.pack("<Q", offset)
        offset += (len(payload) + align - 1) // align * align
    # data section starts aligned
    data_start = (len(out) + align - 1) // align * align
    out += b"\x00" * (data_start - len(out))
    for _, _, _, payload in entries:
        out += payload
        pad = (-len(payload)) % align
        out += b"\x00" * pad
    with open(path, "wb") as f:
        f.write(bytes(out))


class GGUFFile:
    """Parsed GGUF container with by-name (long or short) tensor access."""

    def __init__(self, path: str):
        self.path = path
        with open(path, "rb") as f:
            buf = f.read()
        if buf[:4] != GGUF_MAGIC:
            raise ValueError(f"{path}: not a GGUF file")
        r = _Reader(buf)
        r.take(4)
        self.version = r.u32()
        if self.version not in (2, 3):
            raise ValueError(f"{path}: unsupported GGUF version "
                             f"{self.version}")
        n_tensors = struct.unpack("<q", r.take(8))[0]
        n_kv = struct.unpack("<q", r.take(8))[0]
        self.metadata: Dict[str, Any] = {}
        for _ in range(n_kv):
            k = r.s()
            vt = r.u32()
            self.metadata[k] = r.value(vt)
        align = int(self.metadata.get("general.alignment",
                                      DEFAULT_ALIGNMENT))
        self.infos: Dict[str, Tuple[int, Tuple[int, ...], int]] = {}
        self._order: List[str] = []
        for _ in range(n_tensors):
            name = r.s()
            nd = r.u32()
            ne = struct.unpack(f"<{nd}q", r.take(8 * nd))
            gt = r.u32()
            off = r.u64()
            shape = tuple(reversed(ne))
            self.infos[name] = (gt, shape, off)
            self._order.append(name)
        self._data_start = (r.pos + align - 1) // align * align
        self._buf = buf
        # map original long names (if our writer recorded them)
        self._longnames: Dict[str, str] = {}
        orig = self.metadata.get("pocket_tts.tensor_names")
        if isinstance(orig, list) and len(orig) == len(self._order):
            self._longnames = dict(zip(orig, self._order))

    def names(self) -> List[str]:
        if self._longnames:
            return list(self._longnames.keys())
        return list(self._order)

    def _resolve(self, name: str) -> str:
        if name in self.infos:
            return name
        if name in self._longnames:
            return self._longnames[name]
        sn = shorten_name(name)
        if sn in self.infos:
            return sn
        raise KeyError(f"tensor not found in {self.path}: {name}")

    def get(self, name: str, dequantize: bool = True) -> np.ndarray:
        gt, shape, off = self.infos[self._resolve(name)]
        nbytes = _tensor_nbytes(gt, int(np.prod(shape)) if shape else 1)
        start = self._data_start + off
        raw = self._buf[start:start + nbytes]
        if len(raw) != nbytes:
            raise ValueError(f"truncated tensor data for {name}")
        return _ggml_to_np(gt, raw, shape, dequantize)

    def to_dict(self) -> Dict[str, np.ndarray]:
        return {n: self.get(n) for n in self.names()}


def read_gguf(path: str) -> Tuple[Dict[str, np.ndarray], Dict[str, Any]]:
    f = GGUFFile(path)
    return f.to_dict(), f.metadata
