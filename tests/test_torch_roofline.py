"""The port's utils/roofline.py against `pocket_tts_tpu/utils/roofline.py`:
`decode_frame_costs` and `decode_frame_costs_split` give the same bytes
on one `random_flat` tree at tiny_config(64) (where the linears
quantize), with f32, bf16, int8, int4 and q4_0 leaves, with and without
the int8 backbone KV cache and the int8 mimi ring, and the same FLOPs for
float leaves. Quantized leaves give the float tree's FLOPs (each linear
counts by its logical shape; the JAX package counts packed int4 bytes
and 2-D scales as weights). `device_peaks` holds the H100's published
peaks only and raises for any other name."""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pocket_tts_tpu.config import tiny_config
from pocket_tts_tpu.io.params import params_from_flat, random_flat
from pocket_tts_tpu.io.quant import quantize_params as jquant
from pocket_tts_tpu.utils import roofline as jroof
from pocket_tts_tpu_torch.io.params import from_jax_numpy
from pocket_tts_tpu_torch.io.quant import quantize_params as tquant
from pocket_tts_tpu_torch.utils import roofline as troof

CFG0 = tiny_config(64)
PJ, CFG = params_from_flat(random_flat(CFG0, seed=31), CFG0)
PT = from_jax_numpy(jax.tree.map(np.asarray, PJ))
WEIGHTS = {"int8": dict(bits=8), "int4": dict(bits=4),
           "q4_0": dict(bits=4, group=32)}


def _bf16(tree_j, tree_t):
    return (jax.tree.map(lambda x: x.astype(jnp.bfloat16)
                         if jnp.issubdtype(x.dtype, jnp.floating) else x,
                         tree_j),
            _map(lambda x: x.to(torch.bfloat16)
                 if x.is_floating_point() else x, tree_t))


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree) if isinstance(tree, torch.Tensor) else tree


def _trees(weights):
    if weights == "f32":
        return PJ, PT
    if weights == "bf16":
        return _bf16(PJ, PT)
    return jquant(PJ, **WEIGHTS[weights]), tquant(PT, **WEIGHTS[weights])


@pytest.mark.parametrize("kv", ["none", "backbone", "both"])
@pytest.mark.parametrize("weights", ["f32", "bf16", "int8", "int4", "q4_0"])
def test_costs_equal_jax(weights, kv):
    pj, pt = _trees(weights)
    cfg = CFG
    if kv != "none":
        cfg = dataclasses.replace(cfg, backbone=dataclasses.replace(
            cfg.backbone, quantize_kv=True))
    if kv == "both":
        cfg = dataclasses.replace(cfg, mimi=dataclasses.replace(
            cfg.mimi, transformer=dataclasses.replace(
                cfg.mimi.transformer, quantize_kv=True)))
    for slots in (128, 384):
        want = jroof.decode_frame_costs(pj, cfg, slots)
        want_split = jroof.decode_frame_costs_split(pj, cfg, slots)
        if weights in WEIGHTS:
            # the JAX package's FLOPs over the float tree
            flops = float(jroof.decode_frame_costs(PJ, cfg, slots)[1])
            want, want_split = (want[0], flops), (*want_split[:2], flops)
        got = troof.decode_frame_costs(pt, cfg, slots)
        assert got == tuple(float(w) for w in want)
        assert troof.decode_frame_costs_split(pt, cfg, slots) == tuple(
            float(w) for w in want_split)
    if weights in WEIGHTS:
        # the quantized stream is smaller than the f32 one
        assert got[0] < troof.decode_frame_costs(PT, cfg, 384)[0]


def test_device_peaks_h100_only():
    assert troof.device_peaks("NVIDIA H100 80GB HBM3") == (989e12, 3.35e12)
    for name in ("NVIDIA H100 PCIe", "NVIDIA A100-SXM4-80GB", "TPU v5 lite",
                 "v5e", ""):
        with pytest.raises(ValueError, match="no published peaks"):
            troof.device_peaks(name)

