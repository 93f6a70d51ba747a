"""Plain versions of kernels K4a, K5a, K5b and K6 (what the port runs for
CPU tensors) against the JAX package's Pallas kernels in interpret mode,
on int8 weights from one random checkpoint at tiny_config(64) (every
backbone, mimi and flow linear quantizes there), f32, atol 1e-5 (the
flow net 2e-5: twenty dependent dots). Also: the port's `supported`
routing agrees with the JAX package's, and each wrapper counts no launch
on the CPU and refuses other devices.

The CUDA kernels themselves run only on the card; `chip_smoke.py` holds
each against these plain versions there."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pocket_tts_tpu.config import tiny_config
from pocket_tts_tpu.io.params import params_from_flat, random_flat
from pocket_tts_tpu.io.quant import quantize_params
from pocket_tts_tpu.models import flow_mlp as j_flow_mlp
from pocket_tts_tpu.ops import fused_flow as j_fused_flow
from pocket_tts_tpu.ops import fused_layer as j_fused_layer
from pocket_tts_tpu.ops.basic import slice_layer_params as j_slice
from pocket_tts_tpu.ops.quant_matmul import int8_matmul_pallas
from pocket_tts_tpu_torch.io.params import from_jax_numpy
from pocket_tts_tpu_torch.ops import fused_flow, fused_layer
from pocket_tts_tpu_torch.ops.basic import slice_layer_params
from pocket_tts_tpu_torch.ops.quant_matmul import int8_matmul

torch.set_num_threads(1)
ATOL = 1e-5
CFG0 = tiny_config(64)
PJ, CFG = params_from_flat(random_flat(CFG0, seed=31), CFG0)
QJ = quantize_params(PJ, bits=8)
QT = from_jax_numpy(jax.tree.map(np.asarray, QJ))


def rnd(rng, *shape, scale=1.0):
    return (rng.randn(*shape) * scale).astype(np.float32)


def close(got, want, atol=ATOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=atol,
                               rtol=0)


def _stack(layers):
    """(JAX, port) stacked layer trees: backbone or mimi transformer."""
    if layers == "backbone":
        return QJ["layers"], QT["layers"]
    return (QJ["mimi"]["decoder_transformer"]["layers"],
            QT["mimi"]["decoder_transformer"]["layers"])


# ----------------------------------------------------------------- K4a ---

@pytest.mark.parametrize("stacked", [False, True])
@pytest.mark.parametrize("k", [32, 256])
@pytest.mark.parametrize("t", [1, 16, 40])
def test_k4a_plain_matches_pallas(t, k, stacked):
    rng = np.random.RandomState(t * 100 + k + stacked)
    n, layers = 384, 3
    w = rnd(rng, layers, k, n, scale=0.05)
    pq = quantize_params({"lin": {"w": jnp.asarray(w if stacked
                                                   else w[1])}})["lin"]
    q, s = np.asarray(pq["q"]), np.asarray(pq["scale"])
    x = rnd(rng, t, k)
    if stacked:
        want = int8_matmul_pallas(jnp.asarray(x), jnp.asarray(q),
                                  jnp.asarray(s), layer=1, interpret=True)
        q, s = q[1], s[1]
    else:
        want = int8_matmul_pallas(jnp.asarray(x), jnp.asarray(q),
                                  jnp.asarray(s), interpret=True)
    got = int8_matmul(torch.from_numpy(x), torch.from_numpy(q),
                      torch.from_numpy(s))
    assert got.shape == (t, n) and got.dtype == torch.float32
    close(got, want)


# ----------------------------------------------------------- K5a / K5b ---

LAYER_CASES = [("backbone", 1, 1e-5), ("mimi", 16, CFG.mimi.transformer
                                        .norm_eps)]


@pytest.mark.parametrize("layers,t,eps", LAYER_CASES)
def test_k5a_plain_matches_pallas(layers, t, eps):
    sj, st = _stack(layers)
    dm = st["in_proj"]["q"].shape[1]
    rng = np.random.RandomState(t)
    for l in range(st["in_proj"]["q"].shape[0]):
        x = rnd(rng, t, dm, scale=0.5)
        want = j_fused_layer.pre_attention(j_slice(sj, l), jnp.asarray(x),
                                           eps=eps, interpret=True)
        got = fused_layer.pre_attention(slice_layer_params(st, l),
                                        torch.from_numpy(x), eps=eps)
        close(got, want)


@pytest.mark.parametrize("approx", [False, True])
@pytest.mark.parametrize("layers,t,eps", LAYER_CASES)
def test_k5b_plain_matches_pallas(layers, t, eps, approx):
    """Backbone (T=1, eps 1e-5, unit layer scales) and mimi (T=16, eps 0,
    its two layer scales), erf and tanh GELU."""
    sj, st = _stack(layers)
    dm = st["out_proj"]["q"].shape[1]
    rng = np.random.RandomState(t + approx)
    for l in range(st["out_proj"]["q"].shape[0]):
        x, attn = rnd(rng, t, dm, scale=0.5), rnd(rng, t, dm, scale=0.5)
        want = j_fused_layer.post_attention(
            j_slice(sj, l), jnp.asarray(x), jnp.asarray(attn), eps=eps,
            approx=approx, interpret=True)
        got = fused_layer.post_attention(
            slice_layer_params(st, l), torch.from_numpy(x),
            torch.from_numpy(attn), eps=eps, approx=approx)
        close(got, want)


# ------------------------------------------------------------------ K6 ---

@pytest.mark.parametrize("seed", [0, 1])
def test_k6_plain_matches_pallas(seed):
    """The whole flow net; input_proj and final.linear stay plain weights
    at this width, as the kernel allows."""
    rng = np.random.RandomState(seed)
    c = rnd(rng, CFG.backbone.d_model, scale=0.3)
    x = rnd(rng, CFG.latent_dim, scale=0.5)
    tc = j_flow_mlp.time_cond(PJ["flow_net"])
    assert "w" in QT["flow_net"]["input_proj"]
    want = j_fused_flow.flow_forward(QJ["flow_net"], jnp.asarray(c),
                                     jnp.asarray(x), tc, interpret=True)
    got = fused_flow.flow_forward(QT["flow_net"], torch.from_numpy(c),
                                  torch.from_numpy(x),
                                  torch.from_numpy(np.asarray(tc)))
    close(got, want, atol=2e-5)


# ------------------------------------------------------------- routing ---

@pytest.mark.parametrize("seed_dims,quantized", [(64, True), (64, False),
                                                 (16, True)])
def test_supported_agrees_with_jax(seed_dims, quantized):
    """tiny_config(16): the backbone's 64-wide out_proj stays plain, so
    neither package fuses the layer, and the flow net's 96-wide adaln stays
    plain, so neither fuses the net."""
    cfg0 = tiny_config(seed_dims)
    pj, _ = params_from_flat(random_flat(cfg0, seed=2), cfg0)
    if quantized:
        pj = quantize_params(pj, bits=8)
    pt = from_jax_numpy(jax.tree.map(np.asarray, pj))
    got, want = [], []
    for sj, st in ((pj["layers"], pt["layers"]),
                   (pj["mimi"]["decoder_transformer"]["layers"],
                    pt["mimi"]["decoder_transformer"]["layers"])):
        for l in range(2):
            want.append(j_fused_layer.supported(j_slice(sj, l)))
            got.append(fused_layer.supported(slice_layer_params(st, l)))
    want.append(j_fused_flow.supported(pj["flow_net"]))
    got.append(fused_flow.supported(pt["flow_net"]))
    assert got == want
    assert any(got) == (quantized and seed_dims == 64)


# ------------------------------------------------------------ wrappers ---

def _call_on(device, name):
    def dev(tree):
        if isinstance(tree, dict):
            return {k: dev(v) for k, v in tree.items()}
        if isinstance(tree, tuple):
            return tuple(dev(v) for v in tree)
        return tree.to(device)
    bb = dev(slice_layer_params(QT["layers"], 0))
    dm = CFG.backbone.d_model
    x = torch.zeros(1, dm, device=device)
    if name == "int8_matmul":
        lin = bb["in_proj"]
        return int8_matmul(x, lin["q"], lin["scale"])
    if name == "pre_attention":
        return fused_layer.pre_attention(bb, x)
    if name == "post_attention":
        return fused_layer.post_attention(bb, x, x)
    fp = dev(QT["flow_net"])
    return fused_flow.flow_forward(
        fp, torch.zeros(dm, device=device),
        torch.zeros(CFG.latent_dim, device=device),
        torch.zeros(CFG.flow.dim, device=device))


@pytest.mark.parametrize("name", ["int8_matmul", "pre_attention",
                                  "post_attention", "flow_forward"])
def test_wrapper_takes_plain_version_only_for_cpu(name):
    """A wrapper runs its plain version for CPU tensors, without counting a
    kernel launch, and refuses any device other than the CPU and CUDA
    instead of computing another way."""
    wrapper = {"int8_matmul": int8_matmul,
               "pre_attention": fused_layer.pre_attention,
               "post_attention": fused_layer.post_attention,
               "flow_forward": fused_flow.flow_forward}[name]
    launches = wrapper.launches
    assert torch.isfinite(_call_on("cpu", name)).all()
    assert wrapper.launches == launches
    with pytest.raises(ValueError, match="unsupported device"):
        _call_on("meta", name)
