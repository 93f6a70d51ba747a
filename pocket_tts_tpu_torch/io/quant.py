"""Weight quantization of a params tree (int8, per output channel).

Counterpart of `pocket_tts_tpu/io/quant.py:quantize_params` for bits=8,
group=0, convs=False, and byte-identical to it: the same numpy arithmetic
runs on the float32 upcast of each weight (exact from bf16 in both
frameworks), under the same eligibility rule. A linear {"w": (in, out)} or
stacked {"w": (L, in, out)} becomes {"q": int8, "scale": float32 (out,) /
(L, out)}; its other keys ("b") stay. Small weights, biases, norms, the
LUT and every conv stay as they are.

int4, K-grouped scales (q4_0), quantized convs and the params cache are
not ported yet.
"""
from __future__ import annotations

import numpy as np
import torch

# quantize only weights with at least this many elements
_MIN_QUANT_SIZE = 64 * 64


def _eligible(w) -> bool:
    """A 2-D weight, or a stacked linear (L, in, out) (a conv's trailing
    kernel dim is small), of at least _MIN_QUANT_SIZE elements."""
    if w.numel() < _MIN_QUANT_SIZE:
        return False
    return w.ndim == 2 or (w.ndim == 3 and w.shape[2] >= 128)


def _quantize_weight(w32: np.ndarray):
    """w32 (..., in, out) float32 -> (q int8, scale float32 (..., out)):
    symmetric, per output channel."""
    qmax = 127.0
    amax = np.abs(w32).max(axis=-2)
    scale = np.where(amax > 0, amax / qmax, 1.0).astype(np.float32)
    q = np.clip(np.round(w32 / scale[..., None, :]), -qmax, qmax)
    # C order: the loader's weights may be transposed views, and the
    # kernels read row-major (in, out) bytes
    return (np.ascontiguousarray(q.astype(np.int8)),
            np.ascontiguousarray(scale))


def quantize_params(params, bits: int = 8, convs: bool = False,
                    group: int = 0):
    """Quantize every eligible linear weight of a params tree to int8 with
    per-output-channel scales; the tensors stay on their device."""
    if bits != 8 or group or convs:
        raise NotImplementedError(
            f"quantize_params(bits={bits}, group={group}, convs={convs}): "
            "only bits=8 per-channel linears are ported")

    def walk(node):
        if isinstance(node, dict):
            out = {}
            for key, val in node.items():
                if key == "w" and _eligible(val):
                    q, scale = _quantize_weight(
                        val.detach().float().cpu().numpy())
                    out["q"] = torch.from_numpy(q).to(val.device)
                    out["scale"] = torch.from_numpy(scale).to(val.device)
                else:
                    out[key] = walk(val)
            return out
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v) for v in node)
        return node
    return walk(params)
