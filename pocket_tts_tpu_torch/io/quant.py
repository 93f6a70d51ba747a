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
("b") stay; small weights, biases, norms and the LUT stay as they are.

convs=True also quantizes the SEANet decoder's large convs, per output
channel in every mode (q4_0's group is never applied to a conv), over the
2-D weight the conv ops multiply by (ops/conv.py):

  conv1d  {"w": (Cout, Cin, K)} -> {"qc"/"qc4", "scale" (Cout,)} over
          wf (K*Cin, Cout), wf[j*Cin + c, o] = w[o, c, j]
  convtr  {"w": (Cin, Cout, K)} -> {"qt"/"qt4", "scale" (K*Cout,)} over
          the j-major w2 (Cin, K*Cout)

A conv of fewer than _MIN_CONV_QUANT_SIZE elements stays as it is (at
full width: model_6's 1x1, model_9's blocked resnet, model_11), and so do
the depthwise upsample and the quantizer projection.
`quantization_error_report` gives each quantized weight's largest error
relative to its column's largest magnitude, keyed by the JAX package's
`keystr` paths.

The params cache is the JAX package's safetensors container: one tensor
per leaf named by its `jax.tree_util.keystr` path (`['layers']['in_proj']
['q4']`), the tree skeleton as JSON under the metadata key
`pocket_tts_tree`, and the layout stamp under `pocket_tts_layout`. A
`.gguf` path takes the GGUF container (io/gguf.py) instead, the same
tensors and names, the skeleton under `pocket_tts.tree` and the stamp
under `pocket_tts.layout`; `gguf_quantize` block-quantizes its large float
tensors (q8_0, q4_0, q8_k, q4_k), which read back dequantized to float32.
A file written by either package loads in the other. The port reads and
writes BF16 itself (raw 16-bit words as torch.bfloat16), so it needs no
ml_dtypes.
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


# conv weights below this many elements stay as they are: the blocked-time
# tail (model_9's resnet, model_11) and the 1x1 convs of narrow stages
_MIN_CONV_QUANT_SIZE = 16384

# module names whose "w" is a conv1d (Cout, Cin, K) / convtr (Cin, Cout, K)
# weight in the SEANet decoder (models/seanet.py naming)
_CONV1D_MODULES = frozenset({"model_0", "model_11", "block_1", "block_3"})
_CONVTR_MODULES = frozenset({"model_2", "model_5", "model_8"})
_CONV_KEYS = {("conv1d", 8): "qc", ("conv1d", 4): "qc4",
              ("convtr", 8): "qt", ("convtr", 4): "qt4"}


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


def conv_matrix(w32: np.ndarray, kind: str) -> np.ndarray:
    """A conv weight as the 2-D matrix its quantized layout holds: conv1d
    (Cout, Cin, K) -> wf (K*Cin, Cout); convtr (Cin, Cout, K) -> the
    j-major w2 (Cin, K*Cout)."""
    a, b, k = w32.shape
    if kind == "conv1d":
        return np.transpose(w32, (2, 1, 0)).reshape(k * b, a)
    return np.transpose(w32, (0, 2, 1)).reshape(a, k * b)


def _conv_kind(name: str, w):
    """"conv1d", "convtr" or None for a "w" under module `name`."""
    if w.dim() != 3 or w.numel() < _MIN_CONV_QUANT_SIZE:
        return None
    if name in _CONV1D_MODULES:
        return "conv1d"
    if name in _CONVTR_MODULES and w.shape[2] >= 2:
        return "convtr"
    return None


def quantize_params(params, bits: int = 8, convs: bool = False,
                    group: int = 0):
    """Quantize every eligible linear weight of a params tree (bits 8 or
    4; group > 0: K-grouped int4 scales) and, with convs, the SEANet
    decoder's large convs (per-channel scales whatever the group); the
    tensors stay on their device."""
    if bits not in (4, 8):
        raise ValueError(f"bits must be 8 or 4, not {bits}")

    def walk(node, name=""):
        if isinstance(node, dict):
            out = {}
            for key, val in node.items():
                if key == "w":
                    kind = _conv_kind(name, val) if convs else None
                    qd = None
                    if kind is not None:
                        qd = _quantize_weight(conv_matrix(
                            val.detach().float().cpu().numpy(), kind), bits)
                        if qd is not None:
                            qd = {_CONV_KEYS[kind, bits]:
                                  qd["q" if bits == 8 else "q4"],
                                  "scale": qd["scale"]}
                    elif _eligible(val):
                        qd = _quantize_weight(
                            val.detach().float().cpu().numpy(), bits, group)
                    if qd is not None:
                        out.update({k: v.to(val.device)
                                    for k, v in qd.items()})
                        continue
                out[key] = walk(val, key)
            return out
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v, name) for v in node)
        return node
    return walk(params)


_QKEYS = ("q", "q4", "qc", "qc4", "qt", "qt4")


def quantization_error_report(params, bits: int = 4, convs: bool = False,
                              group: int = 0) -> dict:
    """{keystr path of a weight "w": the largest |dequantized - w| over
    the largest |w| of its column}, for every weight `quantize_params(
    params, bits, convs, group)` quantizes; conv weights are compared as
    the 2-D matrix their layout holds (`conv_matrix`). The JAX package's
    instrument for per-channel against grouped scales (its ab runner
    writes it beside the probes): int8 sits near 0.005, per-channel int4
    near 0.08; a weight far above needs grouped scales or a fallback."""
    from ..ops.quant_matmul import unpack_int4
    pq = quantize_params(params, bits=bits, convs=convs, group=group)
    orig = dict(_flatten(params))
    qmap = dict(_flatten(pq))
    report = {}
    for path, qv in qmap.items():
        kind = path[path.rfind("['") + 2: -2]
        if kind not in _QKEYS:
            continue
        parent = path[: path.rfind("[")]
        base = parent + "['w']"
        if base not in orig:
            continue
        w = orig[base].detach().float().cpu().numpy()
        if kind in ("qc", "qc4"):
            w = conv_matrix(w, "conv1d")
        elif kind in ("qt", "qt4"):
            w = conv_matrix(w, "convtr")
        scale = qmap[parent + "['scale']"].detach().float().cpu().numpy()
        if kind.endswith("4"):
            deq = unpack_int4(qv.detach().cpu()).numpy()
            if scale.ndim == deq.ndim:    # K-grouped: repeat per block
                scale = np.repeat(scale, deq.shape[-2] // scale.shape[-2],
                                  axis=-2)
                deq = deq * scale
            else:
                deq = deq * scale[..., None, :]
        else:
            deq = qv.detach().cpu().numpy().astype(np.float32) \
                * scale[..., None, :]
        denom = np.abs(w).max(axis=-2, keepdims=True) + 1e-12
        report[base] = float((np.abs(deq - w) / denom).max())
    return report


# ---------------------------------------------------------------------------
# params cache: any params tree <-> one safetensors or GGUF file
# ---------------------------------------------------------------------------

_DTYPES = {"F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
           "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
           "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8,
           "BOOL": torch.bool}
_NAMES = {v: k for k, v in _DTYPES.items()}


def _flatten(node, prefix=""):
    """[(keystr path, tensor)] of a tree's leaves in `jax.tree_util`'s
    order: each dict's keys sorted, sequences in index order (the GGUF
    cache writes its tensors so, as the JAX package does)."""
    if isinstance(node, dict):
        return [kv for k in sorted(node)
                for kv in _flatten(node[k], f"{prefix}['{k}']")]
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


def save_params_cache(params, path: str, gguf_quantize=None) -> None:
    """Write a params tree (quantized or not) to a cache file: a `.gguf`
    path the GGUF container (gguf_quantize: None, "q8_0", "q4_0", "q8_k"
    or "q4_k"), any other a safetensors file, tensors in name order, the
    header padded to 8 bytes, as the JAX package writes them. Raises
    ValueError for gguf_quantize on a path that is not `.gguf`."""
    structure = json.dumps(_skeleton(params))
    if path.endswith(".gguf"):
        from .gguf import write_gguf
        write_gguf(path, {name: t.detach().cpu().contiguous()
                          for name, t in _flatten(params)},
                   metadata={"pocket_tts.tree": structure,
                             "pocket_tts.layout": _LAYOUT_VERSION},
                   quantize=gguf_quantize)
        return
    if gguf_quantize:
        raise ValueError("gguf_quantize requires a .gguf path")
    header = {"__metadata__": {
        "pocket_tts_tree": structure,
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


def _check_layout(path: str, layout) -> None:
    if layout != _LAYOUT_VERSION:
        raise ValueError(
            f"params cache {path!r} has layout {layout!r}, this build needs "
            f"{_LAYOUT_VERSION!r} (in_proj RoPE column permutation); re-save "
            "it from the original checkpoint")


def cast_floats(tree, dtype):
    """The tree with its float leaves cast to `dtype`, except the `scale`
    of a quantized weight, which takes its storage type (bfloat16 for
    K-grouped int4, else float32) whatever it was read as: a GGUF cache
    block-quantized by `gguf_quantize` reads its large float tensors back
    in float32, those scales included."""
    if isinstance(tree, dict):
        quant = [k for k in _QKEYS if k in tree]
        out = {}
        for k, v in tree.items():
            if quant and k == "scale":
                grouped = quant[0].endswith("4") and v.dim() == tree[
                    quant[0]].dim()
                out[k] = v.to(torch.bfloat16 if grouped else torch.float32)
            else:
                out[k] = cast_floats(v, dtype)
        return out
    if isinstance(tree, (list, tuple)):
        return type(tree)(cast_floats(v, dtype) for v in tree)
    return tree.to(dtype) if tree.is_floating_point() else tree


def load_params_cache(path: str, device="cpu"):
    """Read a params cache (safetensors or `.gguf`) written by either
    package onto `device`. Raises ValueError when the layout stamp is not
    this build's."""
    if path.endswith(".gguf"):
        from .gguf import read_gguf
        tensors, meta = read_gguf(path)
        _check_layout(path, meta.get("pocket_tts.layout"))
        flat = {name: (t if isinstance(t, torch.Tensor)
                       else torch.from_numpy(np.array(t))).to(device)
                for name, t in tensors.items()}
        return _unskeleton(json.loads(meta["pocket_tts.tree"]), flat)
    with open(path, "rb") as f:
        (hlen,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(hlen).decode("utf-8"))
        data = bytearray(f.read())
    meta = header.pop("__metadata__", None) or {}
    _check_layout(path, meta.get("pocket_tts_layout"))
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
