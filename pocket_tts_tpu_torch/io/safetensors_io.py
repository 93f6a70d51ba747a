"""Minimal safetensors reader/writer for the port, with no ml_dtypes.

The port's own counterpart of `pocket_tts_tpu/io/safetensors_io.py`: an
8-byte little-endian header length, a JSON header of {dtype, shape,
data_offsets}, then the raw tensor bytes. numpy has no bfloat16, so BF16
tensors are read as raw 16-bit words and widened to float32 exactly (the
word becomes the high half of the float32), as the params cache reads
them (`io/quant.py`); a later cast back to torch.bfloat16 gives the file's
bits again. The writer stores torch.bfloat16 tensors as BF16 words.

Supports F64/F32/F16/BF16/I64/I32/I16/I8/U8/BOOL.
"""
from __future__ import annotations

import json
import struct
from typing import Dict

import numpy as np
import torch

_DTYPES = {
    "F64": np.dtype(np.float64),
    "F32": np.dtype(np.float32),
    "F16": np.dtype(np.float16),
    "I64": np.dtype(np.int64),
    "I32": np.dtype(np.int32),
    "I16": np.dtype(np.int16),
    "I8": np.dtype(np.int8),
    "U8": np.dtype(np.uint8),
    "BOOL": np.dtype(np.bool_),
}
_DTYPE_NAMES = {v: k for k, v in _DTYPES.items()}


def bf16_words_to_f32(words: np.ndarray) -> np.ndarray:
    """uint16 bfloat16 bit patterns -> the float32 values they hold."""
    return (words.astype(np.uint32) << 16).view(np.float32)


def read_header(path: str):
    """Returns (header dict, data start offset, metadata dict)."""
    with open(path, "rb") as f:
        (hlen,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(hlen).decode("utf-8"))
    meta = header.pop("__metadata__", {}) or {}
    return header, 8 + hlen, meta


def load_safetensors(path: str, with_metadata: bool = False):
    """name -> np.ndarray: views over one memmap of the file, except BF16
    tensors, which come back as float32 copies holding the same values."""
    header, base, meta = read_header(path)
    buf = np.memmap(path, dtype=np.uint8, mode="r", offset=base)
    out = {}
    for name, info in header.items():
        beg, end = info["data_offsets"]
        if info["dtype"] == "BF16":
            arr = bf16_words_to_f32(buf[beg:end].view(np.uint16))
        else:
            arr = buf[beg:end].view(_DTYPES[info["dtype"]])
        out[name] = arr.reshape(info["shape"])
    if with_metadata:
        return out, meta
    return out


def save_safetensors(tensors: Dict[str, object], path: str,
                     metadata: Dict[str, str] = None):
    """Write numpy arrays or torch tensors (torch.bfloat16 as BF16) in name
    order, the header padded to 8 bytes."""
    header = {}
    if metadata:
        header["__metadata__"] = {str(k): str(v)
                                  for k, v in metadata.items()}
    offset = 0
    blobs = []
    for name in sorted(tensors):
        t = tensors[name]
        if isinstance(t, torch.Tensor) and t.dtype == torch.bfloat16:
            arr = t.detach().cpu().contiguous().view(torch.int16).numpy()
            dt = "BF16"
        else:
            if isinstance(t, torch.Tensor):
                t = t.detach().cpu().numpy()
            arr = np.ascontiguousarray(t)
            dt = _DTYPE_NAMES.get(arr.dtype)
            if dt is None:
                arr = arr.astype(np.float32)
                dt = "F32"
        blob = arr.tobytes()
        header[name] = {
            "dtype": dt,
            "shape": list(arr.shape),
            "data_offsets": [offset, offset + len(blob)],
        }
        offset += len(blob)
        blobs.append(blob)
    hjson = json.dumps(header).encode("utf-8")
    hjson += b" " * ((-(8 + len(hjson))) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(hjson)))
        f.write(hjson)
        for blob in blobs:
            f.write(blob)
