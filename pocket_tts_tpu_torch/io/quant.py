"""Weight quantization of a params tree, and the params cache.

Counterpart of `pocket_tts_tpu/io/quant.py`. `quantize_params` (bits 8 or
4, group 0 or 32, convs=False) is byte-identical to the JAX package's: the
same numpy arithmetic runs on the float32 upcast of each weight (exact
from bf16 in both frameworks), under the same eligibility rule, and every
array is C order (the kernels read row-major bytes):

  int8       {"w": (.., K, N)} -> {"q": int8 (.., K, N),
                                   "scale": float32 (.., N)}
  int4       -> {"q4": int8 (.., K/2, N) packed halves
                 (ops/quant_matmul.pack_int4), "scale": float32 (.., N)}
  int4, g32  -> {"q4", "scale": bfloat16 (.., K/32, N)}: K-grouped (q4_0),
                 the scales rounded to bf16 BEFORE the division, so the
                 stored scale is the one the weights were quantized against

A grouped request falls back to per-channel scales when K is not a
multiple of 2 x group (at full width: input_linear and the flow net's
input_proj, K = 32), and an int4 weight with odd K stays plain. Other keys
("b") stay; small weights, biases, norms, the LUT and every conv stay as
they are.

The params cache is the JAX package's safetensors container: one tensor
per leaf named by its `jax.tree_util.keystr` path (`['layers']['in_proj']
['q4']`), the tree skeleton as JSON under the metadata key
`pocket_tts_tree`, and the layout stamp under `pocket_tts_layout`. A file
written by either package loads in the other. The port reads and writes
BF16 itself (raw 16-bit words as torch.bfloat16), so it needs no
ml_dtypes. The GGUF container is not ported.
"""
from __future__ import annotations

import json
import struct

import numpy as np
import torch

from ..ops.quant_matmul import pack_int4

# quantize only weights with at least this many elements
_MIN_QUANT_SIZE = 64 * 64

# the JAX package's params-cache layout stamp (in_proj q/k columns are
# stored rope-permuted); a cache without it is refused
_LAYOUT_VERSION = "rope-halves-v1"


def _eligible(w) -> bool:
    """A 2-D weight, or a stacked linear (L, in, out) (a conv's trailing
    kernel dim is small), of at least _MIN_QUANT_SIZE elements."""
    if w.numel() < _MIN_QUANT_SIZE:
        return False
    return w.ndim == 2 or (w.ndim == 3 and w.shape[2] >= 128)


def _quantize_weight(w32: np.ndarray, bits: int, group: int = 0):
    """w32 (..., in, out) float32 -> {"q"/"q4": ..., "scale": ...} as torch
    tensors on the CPU, or None (int4 with odd K: left plain)."""
    k = w32.shape[-2]
    if group and (bits != 4 or k % (2 * group)):
        group = 0  # fall back to per-channel
    qmax = 127.0 if bits == 8 else 7.0
    if group:
        blk = w32.reshape(w32.shape[:-2] + (k // group, group, w32.shape[-1]))
        amax = np.abs(blk).max(axis=-2)               # (..., K/g, out)
        scale = np.where(amax > 0, amax / qmax, 1.0).astype(np.float32)
        # round to bf16 (nearest even, as jnp.asarray(.., bfloat16) does)
        # and quantize against the rounded scale
        scale_t = torch.from_numpy(np.ascontiguousarray(scale)).to(
            torch.bfloat16)
        q = np.clip(np.round(blk / scale_t.float().numpy()[..., None, :]),
                    -qmax, qmax).reshape(w32.shape)
    else:
        amax = np.abs(w32).max(axis=-2)               # (..., out)
        scale = np.where(amax > 0, amax / qmax, 1.0).astype(np.float32)
        scale_t = torch.from_numpy(np.ascontiguousarray(scale))
        q = np.clip(np.round(w32 / scale[..., None, :]), -qmax, qmax)
    if bits == 8:
        return {"q": torch.from_numpy(np.ascontiguousarray(
            q.astype(np.int8))), "scale": scale_t}
    if k % 2:
        return None  # odd contraction dim: leave unquantized
    return {"q4": torch.from_numpy(np.ascontiguousarray(pack_int4(q))),
            "scale": scale_t}


def quantize_params(params, bits: int = 8, convs: bool = False,
                    group: int = 0):
    """Quantize every eligible linear weight of a params tree (bits 8 or
    4; group > 0: K-grouped int4 scales); the tensors stay on their
    device. Quantized convs are not ported."""
    if bits not in (4, 8):
        raise ValueError(f"bits must be 8 or 4, not {bits}")
    if convs:
        raise NotImplementedError(
            "quantize_params(convs=True): quantized convs are not ported")

    def walk(node):
        if isinstance(node, dict):
            out = {}
            for key, val in node.items():
                if key == "w" and _eligible(val):
                    qd = _quantize_weight(val.detach().float().cpu().numpy(),
                                          bits, group)
                    if qd is not None:
                        out.update({k: v.to(val.device)
                                    for k, v in qd.items()})
                        continue
                out[key] = walk(val)
            return out
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v) for v in node)
        return node
    return walk(params)


# ---------------------------------------------------------------------------
# params cache: any params tree <-> one safetensors file
# ---------------------------------------------------------------------------

_DTYPES = {"F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
           "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
           "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8,
           "BOOL": torch.bool}
_NAMES = {v: k for k, v in _DTYPES.items()}


def _flatten(node, prefix=""):
    """[(keystr path, tensor)] of a tree's leaves."""
    if isinstance(node, dict):
        return [kv for k, v in node.items()
                for kv in _flatten(v, f"{prefix}['{k}']")]
    if isinstance(node, (tuple, list)):
        return [kv for i, v in enumerate(node)
                for kv in _flatten(v, f"{prefix}[{i}]")]
    return [(prefix, node)]


def _skeleton(node):
    if isinstance(node, dict):
        return {"__kind__": "dict",
                "items": {k: _skeleton(v) for k, v in node.items()}}
    if isinstance(node, (tuple, list)):
        return {"__kind__": "tuple" if isinstance(node, tuple) else "list",
                "items": [_skeleton(v) for v in node]}
    return {"__kind__": "leaf"}


def _unskeleton(skel, flat, prefix=""):
    kind = skel["__kind__"]
    if kind == "leaf":
        return flat[prefix]
    if kind == "dict":
        return {k: _unskeleton(v, flat, f"{prefix}['{k}']")
                for k, v in skel["items"].items()}
    seq = [_unskeleton(v, flat, f"{prefix}[{i}]")
           for i, v in enumerate(skel["items"])]
    return tuple(seq) if kind == "tuple" else seq


def save_params_cache(params, path: str) -> None:
    """Write a params tree (quantized or not) to a safetensors cache file,
    tensors in name order, the header padded to 8 bytes, as the JAX
    package writes it."""
    if path.endswith(".gguf"):
        raise NotImplementedError("the GGUF params cache is not ported")
    header = {"__metadata__": {
        "pocket_tts_tree": json.dumps(_skeleton(params)),
        "pocket_tts_layout": _LAYOUT_VERSION}}
    blobs, offset = [], 0
    for name, t in sorted(_flatten(params), key=lambda kv: kv[0]):
        t = t.detach().cpu().contiguous()
        words = t.view(torch.int16) if t.dtype == torch.bfloat16 else t
        blob = words.numpy().tobytes()
        header[name] = {"dtype": _NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + len(blob)]}
        offset += len(blob)
        blobs.append(blob)
    hjson = json.dumps(header).encode("utf-8")
    hjson += b" " * ((-(8 + len(hjson))) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(hjson)))
        f.write(hjson)
        for blob in blobs:
            f.write(blob)


def load_params_cache(path: str, device="cpu"):
    """Read a params cache written by either package onto `device`. Raises
    ValueError when the layout stamp is not this build's."""
    if path.endswith(".gguf"):
        raise NotImplementedError("the GGUF params cache is not ported")
    with open(path, "rb") as f:
        (hlen,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(hlen).decode("utf-8"))
        data = bytearray(f.read())
    meta = header.pop("__metadata__", None) or {}
    layout = meta.get("pocket_tts_layout")
    if layout != _LAYOUT_VERSION:
        raise ValueError(
            f"params cache {path!r} has layout {layout!r}, this build needs "
            f"{_LAYOUT_VERSION!r} (in_proj RoPE column permutation); re-save "
            "it from the original checkpoint")
    flat = {}
    for name, info in header.items():
        beg, end = info["data_offsets"]
        dtype = _DTYPES[info["dtype"]]
        t = (torch.frombuffer(data, dtype=dtype, offset=beg,
                              count=(end - beg) // dtype.itemsize)
             if end > beg else torch.empty(0, dtype=dtype))
        # a copy: aligned storage of its own, not a view of the file buffer
        flat[name] = t.reshape(info["shape"]).to(device, copy=True)
    return _unskeleton(json.loads(meta["pocket_tts_tree"]), flat)
