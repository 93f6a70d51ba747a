"""Roofline context for the decode loop: bytes and FLOPs per frame.

Counterpart of `pocket_tts_tpu/utils/roofline.py`, with the same
arithmetic over the params tree the port's engine holds (torch tensors;
the actual leaf dtypes count, so int8 `q`, packed int4 `q4` and their
float32 scales give the quantized stream). The decode step at B=1 reads
about every weight byte once per frame, so frames/s has a ceiling at
HBM bytes/s / bytes per frame; `hbm_bw_util` = frames/s x bytes per frame
/ peak bytes/s and `mfu` = frames/s x FLOPs per frame / peak FLOP/s (the
JAX package's bench.py keys).

All numbers are algorithmic estimates (standard 2*N matmul FLOPs; conv
FLOPs = 2 * in*out*k * L_in): MFU counts useful FLOPs. They are counted
from each linear's and each quantized conv's logical shape, so int8, int4
and q4_0 weights, with or without quantized convs, give the float tree's
FLOPs (the JAX package counts the elements of the packed
int4 leaves and of 2-D scales, so its int4 count is ~26% low at full
width); the bytes are the JAX package's, leaf dtypes as stored.

`device_peaks(name)` holds only the card's published peaks: the H100 SXM
(NVIDIA's data sheet, dense: 989e12 bf16 FLOP/s, 3.35e12 HBM bytes/s at
the 700 W limit), matched on `torch.cuda.get_device_name()` ("NVIDIA
H100 80GB HBM3"). Any other name raises: there is no default peak.
"""
from __future__ import annotations

from typing import Tuple

import torch

# peak specs by device-name substring: (bf16 dense FLOP/s, HBM bytes/s)
_PEAKS = {
    "H100 80GB HBM3": (989e12, 3.35e12),   # H100 SXM5
}


def device_peaks(name: str) -> Tuple[float, float]:
    """(bf16 FLOP/s, HBM bytes/s) of the card `name`
    (torch.cuda.get_device_name()); raises for a card not in the table."""
    for key, peaks in _PEAKS.items():
        if key in name:
            return peaks
    raise ValueError(f"no published peaks for the card {name!r} (known: "
                     f"{', '.join(_PEAKS)})")


def _leaves(tree):
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from _leaves(tree[key])
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    elif isinstance(tree, torch.Tensor):
        yield tree


def _tree_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in _leaves(tree))


# a quantized weight's key, and the weights a stored element holds: int8
# linears and convs (q, qc, qt) one, packed int4 (q4, qc4, qt4) two
_QUANT = {"q": 1, "qc": 1, "qt": 1, "q4": 2, "qc4": 2, "qt4": 2}


def _tree_numel(tree) -> int:
    """Weight elements of the leaves with 2 or more dims, by the logical
    shape of a quantized linear or conv: packed int4 holds two weights a
    byte and a `scale` is no weight, so every weight format counts what
    the float tree counts."""
    if isinstance(tree, dict):
        keys = [k for k in tree if k in _QUANT]
        n = sum(_QUANT[k] * tree[k].numel() for k in keys)
        if keys:
            tree = {k: v for k, v in tree.items()
                    if k not in keys and k != "scale"}
        return n + sum(_tree_numel(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_tree_numel(v) for v in tree)
    if isinstance(tree, torch.Tensor) and tree.dim() >= 2:
        return tree.numel()
    return 0


def _itemsize(params) -> int:
    return params["bos_emb"].element_size()


def decode_frame_costs_split(params, cfg,
                             kv_slots: int) -> Tuple[float, float, float]:
    """(weight_bytes, kv_bytes, useful_flops) for ONE frame at batch 1.

    Weights are read once per frame for a whole batch while KV reads
    scale with B: a batch of B reads weight_bytes + B * kv_bytes."""
    b, f = decode_frame_costs(params, cfg, kv_slots)
    kv_item = 1 if cfg.backbone.quantize_kv else _itemsize(params)
    mt = cfg.mimi.transformer
    mimi_kv_item = 1 if mt.quantize_kv else _itemsize(params)
    kv = (cfg.backbone.num_layers * 2 * kv_slots
          * (cfg.backbone.d_model * kv_item
             + (4 if cfg.backbone.quantize_kv else 0))
          + mt.num_layers * 2 * mt.capacity
          * (mt.d_model * mimi_kv_item + (4 if mt.quantize_kv else 0)))
    return b - kv, float(kv), f


def decode_frame_costs(params, cfg, kv_slots: int) -> Tuple[float, float]:
    """(hbm_bytes, useful_flops) for ONE generated frame at batch 1.

    kv_slots: the live backbone KV slot budget (attention reads scale with
    it; the engine picks it per sentence, `_sentence_capacity`)."""
    itemsize = _itemsize(params)
    mt = cfg.mimi.transformer

    # ---- bytes: every decode-path weight is read once per frame ----------
    weight_bytes = _tree_bytes(params)
    # the token embedding table is prefill-only
    weight_bytes -= _tree_bytes(params["conditioner"])
    # KV cache reads: backbone (kv_slots x d_model) k+v per layer (int8
    # rows + f32 scales when cfg.backbone.quantize_kv), plus the mimi ring
    # (capacity x d_model) k+v per layer once per frame
    kv_item = 1 if cfg.backbone.quantize_kv else itemsize
    kv_bytes = (cfg.backbone.num_layers * 2 * kv_slots
                * (cfg.backbone.d_model * kv_item
                   + (4 if cfg.backbone.quantize_kv else 0)))
    mimi_kv_item = 1 if mt.quantize_kv else itemsize
    kv_bytes += (mt.num_layers * 2 * mt.capacity
                 * (mt.d_model * mimi_kv_item
                    + (4 if mt.quantize_kv else 0)))
    bytes_total = float(weight_bytes + kv_bytes)

    # ---- FLOPs ------------------------------------------------------------
    flops = 0.0
    # backbone: one token through all layers (+ attention over kv_slots)
    flops += 2.0 * _tree_numel(params["layers"])
    flops += (cfg.backbone.num_layers * 2 * 2 * kv_slots
              * cfg.backbone.d_model)
    flops += 2.0 * _tree_numel(params["input_linear"])
    flops += 2.0 * _tree_numel(params["out_eos"])
    # flow net: one latent through all blocks
    flops += 2.0 * _tree_numel(params["flow_net"])
    # mimi decode chain: 16 timesteps through the decoder transformer
    up = cfg.mimi.upsample_stride
    flops += 2.0 * _tree_numel(params["mimi"]["decoder_transformer"]) * up
    flops += mt.num_layers * 2 * 2 * mt.capacity * mt.d_model * up
    flops += 2.0 * _tree_numel(params["mimi"]["quantizer"])
    flops += 2.0 * _tree_numel(params["mimi"]["upsample"])  # depthwise, T=1
    # seanet: conv FLOPs = 2 * numel(w) * L_in per stage (model_0 conv7,
    # model_{2,5,8} convtr stages, model_{3,6,9} resnets, model_11 final
    # conv)
    sc = cfg.mimi.seanet
    L = up
    dec = params["mimi"]["decoder"]
    flops += 2.0 * _tree_numel(dec["model_0"]) * L
    for i, stage in enumerate(sc.stages):
        flops += 2.0 * _tree_numel(dec[f"model_{3 * i + 2}"]) * L
        L *= stage.stride
        flops += 2.0 * _tree_numel(dec[f"model_{3 * i + 3}"]) * L
    flops += 2.0 * _tree_numel(dec["model_11"]) * L
    return bytes_total, flops

