"""Moshi's checkpoint and the port's params tree built from it.

The keys and torch layouts follow `kyutai/moshiko-pytorch-bf16` (the
language model's `text_emb`, `emb.N`, `transformer.layers.N.*`,
`out_norm`, `text_linear`, the depth transformer's `depformer_in.K`,
`depformer_text_emb`, `depformer_emb.K`, `depformer.layers.N.*` with one
linear a sub-step, `linears.K`) and Mimi's decoder (`mimi.quantizer.*`,
`mimi.upsample.*`, `mimi.decoder_transformer.*`, `mimi.decoder.model.N.*`),
with three simplifications of form: norms' `alpha` are (d,), the
codebooks are plain `embedding` tables (the checkpoint's
`embedding_sum / cluster_usage`), and the per-step depth linears are
listed under `in_projs.K`, `out_projs.K` and `gating.K` as moshi's
`weights_per_step` modules name them. (The benchmark draws a random
checkpoint in this layout: ptts_bench/moshi/weights.py.)

`params_from_flat` keeps the checkpoint's tensors where it can: a float
linear becomes {"w": W.T}, a view, so a bf16 checkpoint on the card is not
copied; the temporal and Mimi in_proj are the exceptions (their q/k
columns rope-permuted, as `io/params.py` does for Pocket TTS) and the
stacked embedding tables.
"""
from __future__ import annotations

from typing import Dict

import torch

from .params import _rope_permute, _stack
from ..ops.seanet_frame import last_key, stage_keys


def _w(flat, key, dtype, device):
    return flat.pop(key).to(device=device, dtype=dtype)


def _lin(flat, key, dtype, device) -> dict:
    """{"w": (in, out)}: a transposed view of the checkpoint's weight."""
    return {"w": _w(flat, key, dtype, device).t()}


def _conv(flat, key, dtype, device) -> dict:
    out = {"w": _w(flat, key + ".weight", dtype, device)}
    if key + ".bias" in flat:
        out["b"] = _w(flat, key + ".bias", dtype, device)
    return out


def params_from_flat(flat: Dict[str, torch.Tensor], cfg,
                     dtype: torch.dtype = torch.float32,
                     device="cpu") -> dict:
    """The port's Moshi params from a checkpoint dict, which it empties
    (each tensor is popped as it is taken, so that a tensor the tree does
    not keep is freed at once)."""
    dd = dict(dtype=dtype, device=device)
    d = cfg.d_model
    p = {"text_emb": _w(flat, "text_emb.weight", **dd),
         "emb": torch.stack([_w(flat, f"emb.{i}.weight", **dd)
                             for i in range(2 * cfg.n_q)])}
    layers = []
    for i in range(cfg.num_layers):
        pre = f"transformer.layers.{i}."
        layers.append({
            "norm1": {"alpha": _w(flat, pre + "norm1.alpha", **dd)},
            "in_proj": _rope_permute(
                _lin(flat, pre + "self_attn.in_proj_weight", **dd), d,
                cfg.head_dim),
            "out_proj": _lin(flat, pre + "self_attn.out_proj.weight", **dd),
            "norm2": {"alpha": _w(flat, pre + "norm2.alpha", **dd)},
            "linear_in": _lin(flat, pre + "gating.linear_in.weight", **dd),
            "linear_out": _lin(flat, pre + "gating.linear_out.weight",
                               **dd)})
    p["layers"] = layers
    p["out_norm"] = {"alpha": _w(flat, "out_norm.alpha", **dd)}
    p["text_linear"] = _lin(flat, "text_linear.weight", **dd)
    dep = cfg.depth
    dlayers = []
    for i in range(dep.num_layers):
        pre = f"depformer.layers.{i}."
        dlayers.append({
            "norm1": {"alpha": _w(flat, pre + "norm1.alpha", **dd)},
            "norm2": {"alpha": _w(flat, pre + "norm2.alpha", **dd)},
            "in_proj": [_lin(flat, pre + f"self_attn.in_projs.{k}.weight",
                             **dd) for k in range(dep.steps)],
            "out_proj": [_lin(flat, pre + f"self_attn.out_projs.{k}.weight",
                              **dd) for k in range(dep.steps)],
            "linear_in": [_lin(flat, pre + f"gating.{k}.linear_in.weight",
                               **dd) for k in range(dep.steps)],
            "linear_out": [_lin(flat, pre + f"gating.{k}.linear_out.weight",
                                **dd) for k in range(dep.steps)]})
    p["depth"] = {
        "in": [_lin(flat, f"depformer_in.{k}.weight", **dd)
               for k in range(dep.steps)],
        "text_emb": _w(flat, "depformer_text_emb.weight", **dd),
        "emb": torch.stack([_w(flat, f"depformer_emb.{k}.weight", **dd)
                            for k in range(dep.steps - 1)]),
        "layers": dlayers,
        "linears": [_lin(flat, f"linears.{k}.weight", **dd)
                    for k in range(dep.steps)]}
    p["mimi"] = mimi_from_flat(flat, cfg, dtype, device)
    return p


def mimi_from_flat(flat: Dict[str, torch.Tensor], cfg,
                   dtype: torch.dtype = torch.float32, device="cpu") -> dict:
    """The port's params of Moshi's Mimi decoder (models/mimi.
    decode_codes_frame) from the checkpoint's `mimi.*` keys, popped."""
    dd = dict(dtype=dtype, device=device)
    mi, rvq = cfg.mimi, cfg.rvq
    q = "mimi.quantizer."
    book = "._codebook.embedding"
    # the codebooks and projections stay float32 (the RVQ sums and
    # projects in float32, and rounds once)
    f32 = dict(dd, dtype=torch.float32)
    quant = {
        "first": torch.stack([_w(flat, q + f"rvq_first.vq.layers.{k}" + book,
                                 **f32) for k in range(rvq.n_semantic)]),
        "rest": torch.stack([_w(flat, q + f"rvq_rest.vq.layers.{k}" + book,
                                **f32)
                             for k in range(rvq.n_q - rvq.n_semantic)]),
        "proj_first": _w(flat, q + "rvq_first.output_proj.weight",
                         **f32)[:, :, 0].t(),
        "proj_rest": _w(flat, q + "rvq_rest.output_proj.weight",
                        **f32)[:, :, 0].t()}
    mlayers = []
    for i in range(mi.transformer.num_layers):
        pre = f"mimi.decoder_transformer.transformer.layers.{i}."
        mlayers.append({
            "norm1": {"scale": _w(flat, pre + "norm1.weight", **dd),
                      "bias": _w(flat, pre + "norm1.bias", **dd)},
            "in_proj": _rope_permute(
                {"w": _w(flat, pre + "self_attn.in_proj_weight",
                         **dd).t()}, mi.dim, mi.transformer.head_dim),
            "out_proj": {"w": _w(flat, pre + "self_attn.out_proj.weight",
                                 **dd).t().contiguous()},
            "layer_scale_1": {"scale": _w(flat, pre + "layer_scale_1.scale",
                                          **dd)},
            "norm2": {"scale": _w(flat, pre + "norm2.weight", **dd),
                      "bias": _w(flat, pre + "norm2.bias", **dd)},
            "linear1": {"w": _w(flat, pre + "linear1.weight",
                                **dd).t().contiguous()},
            "linear2": {"w": _w(flat, pre + "linear2.weight",
                                **dd).t().contiguous()},
            "layer_scale_2": {"scale": _w(flat, pre + "layer_scale_2.scale",
                                          **dd)}})
    sc = mi.seanet
    dec = {"model_0": _conv(flat, "mimi.decoder.model.0.conv", **dd)}
    for tr, rn in stage_keys(sc):
        dec[tr] = _conv(flat, f"mimi.decoder.model.{tr[6:]}.convtr", **dd)
        base = f"mimi.decoder.model.{rn[6:]}.block."
        dec[rn] = {"block_1": _conv(flat, base + "1.conv", **dd),
                   "block_3": _conv(flat, base + "3.conv", **dd)}
    last = last_key(sc)
    dec[last] = _conv(flat, f"mimi.decoder.model.{last[6:]}.conv", **dd)
    return {"quantizer": quant,
            "upsample": {"w": _w(flat, "mimi.upsample.convtr.convtr.weight",
                                 **dd)},
            "decoder_transformer": {"layers": _stack(mlayers)},
            "decoder": dec}
