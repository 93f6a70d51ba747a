"""Kernels K5a, K5b and K6 over many rows (quantized weights at batch): the
port's plain versions, which its wrappers run for CPU tensors, against the
JAX package's fused functions under `jax.vmap` (interpret mode: one call
up to 64 rows, the row-tiled call up to 256, the XLA composition above),
on one random checkpoint at tiny_config(64) quantized to int8, int4 and
q4_0 by the JAX package. K5a/K5b at 64, 128 and 512 mimi rows (4, 8 and 32
lanes x 16) and 4 backbone rows (4 lanes x 1); K6 at 4 rows. f32,
relative to max |JAX| 1e-5: both sides compute in f32 and round at the
same points, so they differ in summation order only.

Also the launch counts of many rows that the module docstring states
(`post_launches`), and that the wrappers count nothing on the CPU."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pocket_tts_tpu.config import tiny_config
from pocket_tts_tpu.io.params import params_from_flat, random_flat
from pocket_tts_tpu.io.quant import quantize_params as j_quantize
from pocket_tts_tpu.models import flow_mlp as j_flow_mlp
from pocket_tts_tpu.ops import fused_flow as j_fused_flow
from pocket_tts_tpu.ops import fused_layer as j_fused_layer
from pocket_tts_tpu.ops.basic import slice_layer_params as j_slice
from pocket_tts_tpu_torch.io.params import from_jax_numpy
from pocket_tts_tpu_torch.ops import fused_flow, fused_layer
from pocket_tts_tpu_torch.ops.basic import slice_layer_params

torch.set_num_threads(1)
REL = 1e-5
CFG0 = tiny_config(64)
PJ, CFG = params_from_flat(random_flat(CFG0, seed=51), CFG0)
KINDS = {"int8": dict(bits=8), "int4": dict(bits=4),
         "q4_0": dict(bits=4, group=32)}
QJ = {k: j_quantize(PJ, **kw) for k, kw in KINDS.items()}
QT = {k: from_jax_numpy(jax.tree.map(np.asarray, q)) for k, q in QJ.items()}


def rnd(rng, *shape, scale=1.0):
    return (rng.randn(*shape) * scale).astype(np.float32)


def close_rel(got, want):
    want = np.asarray(want)
    scale = np.abs(want).max()
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy() / scale, want / scale, atol=REL,
                               rtol=0)


def _layer(kind, layers, l):
    if layers == "backbone":
        sj, st = QJ[kind]["layers"], QT[kind]["layers"]
    else:
        sj = QJ[kind]["mimi"]["decoder_transformer"]["layers"]
        st = QT[kind]["mimi"]["decoder_transformer"]["layers"]
    return j_slice(sj, l), slice_layer_params(st, l)


# (layers, lanes, rows per lane, eps)
ROW_CASES = [("backbone", 4, 1, 1e-5),
             ("mimi", 4, 16, CFG.mimi.transformer.norm_eps),
             ("mimi", 8, 16, CFG.mimi.transformer.norm_eps),
             ("mimi", 32, 16, CFG.mimi.transformer.norm_eps)]


@pytest.mark.parametrize("kind", list(KINDS))
@pytest.mark.parametrize("layers,lanes,t,eps", ROW_CASES)
def test_k5a_rows_plain_matches_jax_vmap(layers, lanes, t, eps, kind):
    pj, pt = _layer(kind, layers, 1)
    assert fused_layer.supported(pt) and j_fused_layer.supported(pj)
    dm = pt["norm1"]["scale"].shape[0]
    x = rnd(np.random.RandomState(lanes * t), lanes, t, dm, scale=0.5)
    want = jax.vmap(lambda xi: j_fused_layer.pre_attention(
        pj, xi, eps=eps, interpret=True))(jnp.asarray(x))
    close_rel(fused_layer.pre_attention(pt, torch.from_numpy(x), eps=eps),
              want)


@pytest.mark.parametrize("kind", list(KINDS))
@pytest.mark.parametrize("layers,lanes,t,eps", ROW_CASES)
def test_k5b_rows_plain_matches_jax_vmap(layers, lanes, t, eps, kind):
    pj, pt = _layer(kind, layers, 0)
    dm = pt["norm2"]["scale"].shape[0]
    rng = np.random.RandomState(lanes * t + 1)
    x, attn = (rnd(rng, lanes, t, dm, scale=0.5) for _ in range(2))
    want = jax.vmap(lambda xi, ai: j_fused_layer.post_attention(
        pj, xi, ai, eps=eps, interpret=True))(jnp.asarray(x),
                                              jnp.asarray(attn))
    got = fused_layer.post_attention(pt, torch.from_numpy(x),
                                     torch.from_numpy(attn), eps=eps)
    close_rel(got, want)


@pytest.mark.parametrize("kind", list(KINDS))
def test_k6_rows_plain_matches_jax_vmap(kind):
    fj, ft = QJ[kind]["flow_net"], QT[kind]["flow_net"]
    assert fused_flow.supported(ft) and j_fused_flow.supported(fj)
    rng = np.random.RandomState(3)
    c = rnd(rng, 4, CFG.backbone.d_model, scale=0.3)
    x = rnd(rng, 4, CFG.latent_dim, scale=0.5)
    tc = j_flow_mlp.time_cond(PJ["flow_net"])
    want = jax.vmap(lambda ci, xi: j_fused_flow.flow_forward(
        fj, ci, xi, tc, interpret=True))(jnp.asarray(c), jnp.asarray(x))
    got = fused_flow.flow_forward(ft, torch.from_numpy(c),
                                  torch.from_numpy(x),
                                  torch.from_numpy(np.array(tc)))
    close_rel(got, want)
    # row i of the lane call is the solo call on row i
    solo = fused_flow.flow_forward(ft, torch.from_numpy(c[2]),
                                   torch.from_numpy(x[2]),
                                   torch.from_numpy(np.array(tc)))
    np.testing.assert_allclose(got[2].numpy(), solo.numpy(), atol=1e-6,
                               rtol=0)


@pytest.mark.parametrize("rows,dm,launches", [(1, 1024, 1), (16, 512, 1),
                                              (32, 1024, 3), (64, 512, 3),
                                              (256, 512, 3),
                                              (512, 512, 3)])
def test_k5b_launches_per_call(rows, dm, launches):
    """The launch counts the module docstring states: the solo shapes,
    32 lanes of the backbone, and 4 / 16 / 32 lanes of mimi."""
    assert fused_layer.post_launches(rows, dm) == launches


def test_lane_wrappers_count_nothing_on_cpu():
    pj, pt = _layer("int4", "mimi", 0)
    x = torch.zeros(2, 16, pt["norm2"]["scale"].shape[0])
    before = (fused_layer.pre_attention.launches_lanes,
              fused_layer.post_attention.launches_lanes,
              fused_flow.flow_forward.launches_lanes)
    fused_layer.pre_attention(pt, x)
    fused_layer.post_attention(pt, x, x)
    ft = QT["int4"]["flow_net"]
    fused_flow.flow_forward(ft, torch.zeros(2, CFG.backbone.d_model),
                            torch.zeros(2, CFG.latent_dim),
                            torch.zeros(CFG.flow.dim))
    assert before == (fused_layer.pre_attention.launches_lanes,
                      fused_layer.post_attention.launches_lanes,
                      fused_flow.flow_forward.launches_lanes)
