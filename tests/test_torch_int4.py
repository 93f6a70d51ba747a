"""The port's int4 path against the JAX package's, at tiny_config(64)
(every backbone, mimi and flow linear quantizes there, K-grouped scales
included) with numpy-seeded inputs:

- quantize_params(bits=4, group=0|32) byte for byte (packed q4 bytes, f32
  and bf16 scale bits), with the per-channel fallback at K = 32 and an odd
  K left plain; pack_int4 / unpack_int4 against JAX's;
- the plain versions of K4b, K5a, K5b and K6 against the JAX functions in
  interpret mode, per-channel and grouped, f32, atol 1e-5 (the flow net
  2e-5: twenty dependent dots), as test_torch_fused.py holds the int8 ones;
  the JAX kernels' T = 1 per-channel scheme (rawf32m) sums the same
  products in another order, so they agree to float32 rounding;
- a hand-built flow net (latent 32, dim 128) whose q4_0 input_proj keeps
  per-channel int4 scales beside grouped big linears, as at full width;
- `supported` routing on int4, grouped and mixed-bits trees; the CPU
  wrappers' use of the plain versions;
- from_jax_numpy keeping int4 leaves and bf16 group scales.

The CUDA kernels run only on the card; chip_smoke.py holds each against
these plain versions there."""
import dataclasses

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
from pocket_tts_tpu.ops import quant_matmul as j_qmm
from pocket_tts_tpu.ops.basic import slice_layer_params as j_slice
from pocket_tts_tpu_torch.io.params import from_jax_numpy
from pocket_tts_tpu_torch.io.params import params_from_flat as \
    t_params_from_flat
from pocket_tts_tpu_torch.io.quant import quantize_params
from pocket_tts_tpu_torch.ops import fused_flow, fused_layer
from pocket_tts_tpu_torch.ops.basic import linear, slice_layer_params
from pocket_tts_tpu_torch.ops.quant_matmul import (int4_matmul,
                                                   int4_matmul_plain,
                                                   pack_int4, unpack_int4)

torch.set_num_threads(1)
ATOL = 1e-5
CFG0 = tiny_config(64)
FLAT = random_flat(CFG0, seed=41)
PJ, CFG = params_from_flat(FLAT, CFG0)
GROUPS = {"int4": 0, "q4_0": 32}
QJ = {name: j_quantize(PJ, bits=4, group=g) for name, g in GROUPS.items()}
QT = {name: from_jax_numpy(jax.tree.map(np.asarray, q))
      for name, q in QJ.items()}
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def rnd(rng, *shape, scale=1.0):
    return (rng.randn(*shape) * scale).astype(np.float32)


def close(got, want, atol=ATOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=atol,
                               rtol=0)


def _leaves(tree, prefix=""):
    """{path: tensor} of a port tree (the derived _time_cond left out:
    each package computes it in its own float order)."""
    if isinstance(tree, dict):
        return {p: t for k, v in tree.items() if k != "_time_cond"
                for p, t in _leaves(v, f"{prefix}/{k}").items()}
    if isinstance(tree, (tuple, list)):
        return {p: t for i, v in enumerate(tree)
                for p, t in _leaves(v, f"{prefix}/{i}").items()}
    return {prefix: tree}


def _bits_equal(a, b):
    if a.dtype == torch.bfloat16:
        a, b = a.view(torch.int16), b.view(torch.int16)
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)


# -------------------------------------------------------- quantization ---

@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("group", [0, 32])
def test_quantize_int4_byte_identical_to_jax(group, dtype):
    jdt, tdt = DTYPES[dtype]
    pj, _ = params_from_flat(FLAT, CFG0, jdt)
    pt, _ = t_params_from_flat(FLAT, CFG0, tdt)
    want = _leaves(from_jax_numpy(jax.tree.map(
        np.asarray, j_quantize(pj, bits=4, group=group))))
    got = _leaves(quantize_params(pt, bits=4, group=group))
    assert sorted(got) == sorted(want)
    sdt = torch.bfloat16 if group else torch.float32
    for path in ("/layers/in_proj", "/layers/linear2",
                 "/mimi/decoder_transformer/layers/out_proj",
                 "/flow_net/cond_embed", "/flow_net/res_blocks/adaln",
                 "/flow_net/final/adaln"):
        q4, s = got[path + "/q4"], got[path + "/scale"]
        assert q4.dtype == torch.int8 and s.dtype == sdt, path
        assert q4.is_contiguous() and s.is_contiguous(), path
        assert s.dim() == q4.dim() if group else s.dim() == q4.dim() - 1
    for path, t in got.items():
        assert _bits_equal(t, want[path]), path


def test_quantize_fallbacks_match_jax():
    """q4_0 at K = 32 (input_linear, input_proj at full width) keeps
    per-channel f32 scales; an odd K stays plain; int8 ignores group."""
    rng = np.random.RandomState(0)
    tree = {"k32": {"w": rnd(rng, 32, 256), "b": rnd(rng, 256)},
            "odd": {"w": rnd(rng, 65, 128)},
            "stacked": {"w": rnd(rng, 3, 128, 192)},
            "small": {"w": rnd(rng, 16, 64)}}
    for bits, group in ((4, 32), (4, 0), (8, 32)):
        want = _leaves(from_jax_numpy(jax.tree.map(np.asarray, j_quantize(
            jax.tree.map(jnp.asarray, tree), bits=bits, group=group))))
        got = _leaves(quantize_params(
            jax.tree.map(torch.from_numpy, tree), bits=bits, group=group))
        assert sorted(got) == sorted(want)
        for path, t in got.items():
            assert _bits_equal(t, want[path]), (bits, group, path)
        assert "/small/w" in got
        if bits == 4:
            assert "/odd/w" in got
            assert got["/k32/scale"].shape == (256,)
            assert got["/k32/scale"].dtype == torch.float32
            assert got["/stacked/scale"].shape == (
                (3, 4, 192) if group else (3, 192))


@pytest.mark.parametrize("shape", [(8, 12), (64, 256), (3, 32, 16)])
def test_pack_unpack_int4_match_jax(shape):
    rng = np.random.RandomState(len(shape))
    q = rng.randint(-8, 8, size=shape)
    packed = pack_int4(q)
    if len(shape) == 2:
        np.testing.assert_array_equal(packed, j_qmm.pack_int4(q))
        np.testing.assert_array_equal(
            unpack_int4(torch.from_numpy(packed)).numpy(),
            np.asarray(j_qmm.unpack_int4(jnp.asarray(packed))))
    assert packed.dtype == np.int8
    assert packed.shape == shape[:-2] + (shape[-2] // 2, shape[-1])
    np.testing.assert_array_equal(
        unpack_int4(torch.from_numpy(packed), torch.int32).numpy(), q)


def test_from_jax_numpy_keeps_int4_and_group_scales():
    tree = jax.tree.map(np.asarray, QJ["q4_0"])
    pt = from_jax_numpy(tree, dtype=torch.float32)
    lin = pt["layers"]["in_proj"]
    assert lin["q4"].dtype == torch.int8
    assert lin["scale"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        lin["scale"].float().numpy(),
        tree["layers"]["in_proj"]["scale"].astype(np.float32))


# ----------------------------------------------------------------- K4b ---

@pytest.mark.parametrize("stacked", [False, True])
@pytest.mark.parametrize("group", [0, 32])
@pytest.mark.parametrize("t", [1, 16, 40])
def test_k4b_plain_matches_pallas(t, group, stacked):
    rng = np.random.RandomState(t * 10 + group + stacked)
    k, n, layers = 256, 384, 3
    w = rnd(rng, layers, k, n, scale=0.05)
    pq = j_quantize({"lin": {"w": jnp.asarray(w if stacked else w[1])}},
                    bits=4, group=group)["lin"]
    q4, s = np.array(pq["q4"]), np.array(pq["scale"])
    x = rnd(rng, t, k)
    if stacked:
        want = j_qmm.int4_matmul_pallas(jnp.asarray(x), jnp.asarray(q4),
                                        jnp.asarray(s), layer=1,
                                        interpret=True)
        q4, s = q4[1], s[1]
    else:
        want = j_qmm.int4_matmul_pallas(jnp.asarray(x), jnp.asarray(q4),
                                        jnp.asarray(s), interpret=True)
    st = from_jax_numpy({"q4": q4, "scale": s})["scale"]
    assert st.dtype == (torch.bfloat16 if group else torch.float32)
    got = int4_matmul(torch.from_numpy(x), torch.from_numpy(q4), st)
    assert got.shape == (t, n) and got.dtype == torch.float32
    # at T = 1 with per-channel scales the JAX kernel (INT4_SCHEME rawf32m)
    # sums raw bytes x_lo . b, terms up to 16x the nibble products, then
    # cancels: its float32 rounding is that much larger (~1e-5 here)
    atol = 3e-5 if t == 1 and not group else ATOL
    close(got, want, atol)
    close(int4_matmul_plain(torch.from_numpy(x), torch.from_numpy(q4), st),
          want, atol)


@pytest.mark.parametrize("group", [0, 32])
def test_linear_routes_int4_like_jax(group):
    """ops.basic.linear on an int4 linear with a bias: the scaled product
    rounded to x's type, then the bias, as the JAX package's linear."""
    from pocket_tts_tpu.ops.basic import linear as j_linear
    rng = np.random.RandomState(group)
    lin = {"w": jnp.asarray(rnd(rng, 256, 128, scale=0.05)),
           "b": jnp.asarray(rnd(rng, 128))}
    lj = j_quantize({"lin": lin}, bits=4, group=group)["lin"]
    lt = from_jax_numpy(jax.tree.map(np.asarray, lj))
    x = rnd(rng, 5, 256)
    close(linear(lt, torch.from_numpy(x)), j_linear(lj, jnp.asarray(x)))


# ----------------------------------------------------------- K5a / K5b ---

def _stack(name, layers):
    if layers == "backbone":
        return QJ[name]["layers"], QT[name]["layers"]
    return (QJ[name]["mimi"]["decoder_transformer"]["layers"],
            QT[name]["mimi"]["decoder_transformer"]["layers"])


LAYER_CASES = [("backbone", 1, 1e-5),
               ("mimi", 16, CFG.mimi.transformer.norm_eps)]


@pytest.mark.parametrize("name", ["int4", "q4_0"])
@pytest.mark.parametrize("layers,t,eps", LAYER_CASES)
def test_k5a_int4_plain_matches_pallas(layers, t, eps, name):
    sj, st = _stack(name, layers)
    dm = st["in_proj"]["q4"].shape[1] * 2
    rng = np.random.RandomState(t)
    for l in range(st["in_proj"]["q4"].shape[0]):
        x = rnd(rng, t, dm, scale=0.5)
        want = j_fused_layer.pre_attention(j_slice(sj, l), jnp.asarray(x),
                                           eps=eps, interpret=True)
        got = fused_layer.pre_attention(slice_layer_params(st, l),
                                        torch.from_numpy(x), eps=eps)
        close(got, want)


@pytest.mark.parametrize("approx", [False, True])
@pytest.mark.parametrize("name", ["int4", "q4_0"])
@pytest.mark.parametrize("layers,t,eps", LAYER_CASES)
def test_k5b_int4_plain_matches_pallas(layers, t, eps, name, approx):
    """Backbone (T=1, eps 1e-5, unit layer scales) and mimi (T=16, eps 0,
    its two layer scales), erf and tanh GELU; W2's packed rows pair hidden
    units j and j + H/2."""
    sj, st = _stack(name, layers)
    dm = st["out_proj"]["scale"].shape[-1]
    rng = np.random.RandomState(t + approx)
    for l in range(st["out_proj"]["q4"].shape[0]):
        x, attn = rnd(rng, t, dm, scale=0.5), rnd(rng, t, dm, scale=0.5)
        want = j_fused_layer.post_attention(
            j_slice(sj, l), jnp.asarray(x), jnp.asarray(attn), eps=eps,
            approx=approx, interpret=True)
        got = fused_layer.post_attention(
            slice_layer_params(st, l), torch.from_numpy(x),
            torch.from_numpy(attn), eps=eps, approx=approx)
        close(got, want)


# ------------------------------------------------------------------ K6 ---

def _mixed_flow(group):
    """A flow net with latent 32 and dim 128, quantized by both packages:
    under q4_0 its input_proj (32 x 128, 4096 elements, K = 32) keeps
    per-channel int4 scales beside grouped big linears and a grouped
    final.linear, the full-width layout that tiny_config(64) cannot show."""
    cfg0 = dataclasses.replace(
        CFG0, latent_dim=32,
        flow=dataclasses.replace(CFG0.flow, dim=128, mlp_hidden=128),
        mimi=dataclasses.replace(CFG0.mimi, latent_dim=32))
    pj, cfg = params_from_flat(random_flat(cfg0, seed=43), cfg0)
    qj = j_quantize(pj, bits=4, group=group)
    return (pj["flow_net"], qj["flow_net"],
            from_jax_numpy(jax.tree.map(np.asarray, qj))["flow_net"], cfg)


@pytest.mark.parametrize("case", ["int4", "q4_0", "mixed_int4",
                                  "mixed_q4_0"])
def test_k6_int4_plain_matches_pallas(case):
    if case.startswith("mixed"):
        pf, fj, ft, cfg = _mixed_flow(GROUPS[case[6:]])
        assert "q4" in ft["input_proj"] and "q4" in ft["final"]["linear"]
        assert ft["input_proj"]["scale"].dtype == torch.float32
        if case == "mixed_q4_0":
            assert ft["cond_embed"]["scale"].dtype == torch.bfloat16
            assert ft["final"]["linear"]["scale"].dtype == torch.bfloat16
    else:
        pf, fj, ft, cfg = (PJ["flow_net"], QJ[case]["flow_net"],
                           QT[case]["flow_net"], CFG)
        assert "w" in ft["input_proj"]
    assert fused_flow.supported(ft) and j_fused_flow.supported(fj)
    rng = np.random.RandomState(len(case))
    tc = j_flow_mlp.time_cond(pf)
    for _ in range(2):
        c = rnd(rng, cfg.backbone.d_model, scale=0.3)
        x = rnd(rng, cfg.latent_dim, scale=0.5)
        want = j_fused_flow.flow_forward(fj, jnp.asarray(c), jnp.asarray(x),
                                         tc, interpret=True)
        got = fused_flow.flow_forward(ft, torch.from_numpy(c),
                                      torch.from_numpy(x),
                                      torch.from_numpy(np.asarray(tc)))
        close(got, want, atol=2e-5)


# ------------------------------------------------------------- routing ---

def _mix(a, b, keys):
    """Tree a with the subtrees at `keys` (paths) taken from tree b."""
    out = jax.tree.map(lambda v: v, a)
    for path in keys:
        node, src = out, b
        for k in path[:-1]:
            node, src = node[k], src[k]
        node[path[-1]] = src[path[-1]]
    return out


MIXES = {
    "int4": (QJ["int4"], ()),
    "q4_0": (QJ["q4_0"], ()),
    # backbone out_proj int8 beside int4: neither package fuses it
    "layer_bits": (QJ["int4"], [("layers", "out_proj")]),
    # grouped and per-channel int4 in one layer: one bits value, fused
    "layer_layouts": (QJ["q4_0"], [("layers", "linear1")]),
    # int8 input_proj beside int4 big linears: fused; int8 adaln: not
    "flow_small": (QJ["int4"], [("flow_net", "input_proj")]),
    "flow_big": (QJ["int4"], [("flow_net", "res_blocks", "adaln")]),
}


@pytest.mark.parametrize("mix", sorted(MIXES))
def test_supported_agrees_with_jax_on_int4(mix):
    base, keys = MIXES[mix]
    other = {"layer_layouts": QJ["int4"]}.get(mix, j_quantize(PJ, bits=8))
    if mix == "flow_small":
        # a plain 8 x 128 input_proj is under the size floor: quantize it
        # to int8 by hand, as a larger latent would be
        other = {"flow_net": {"input_proj": j_quantize(
            {"l": {"w": jnp.ones((64, 128))}}, bits=8)["l"]}}
    pj = _mix(base, other, keys)
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
    assert got[0] == (mix != "layer_bits")
    assert got[-1] == (mix != "flow_big")


# ------------------------------------------------------------ wrappers ---

def _dev(tree, device):
    if isinstance(tree, dict):
        return {k: _dev(v, device) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_dev(v, device) for v in tree)
    return tree.to(device)


def _call_on(device, name, tree):
    bb = _dev(slice_layer_params(QT[tree]["layers"], 0), device)
    dm = CFG.backbone.d_model
    x = torch.zeros(1, dm, device=device)
    if name == "int4_matmul":
        lin = bb["in_proj"]
        return int4_matmul(x, lin["q4"], lin["scale"])
    if name == "pre_attention":
        return fused_layer.pre_attention(bb, x)
    if name == "post_attention":
        return fused_layer.post_attention(bb, x, x)
    fp = _dev(QT[tree]["flow_net"], device)
    return fused_flow.flow_forward(
        fp, torch.zeros(dm, device=device),
        torch.zeros(CFG.latent_dim, device=device),
        torch.zeros(CFG.flow.dim, device=device))


@pytest.mark.parametrize("tree", ["int4", "q4_0"])
@pytest.mark.parametrize("name", ["int4_matmul", "pre_attention",
                                  "post_attention", "flow_forward"])
def test_int4_wrapper_takes_plain_version_only_for_cpu(name, tree):
    """On int4 weights a wrapper runs its plain version for CPU tensors,
    counting no launch (int8 or int4), and refuses any device other than
    the CPU and CUDA instead of computing another way."""
    wrapper = {"int4_matmul": int4_matmul,
               "pre_attention": fused_layer.pre_attention,
               "post_attention": fused_layer.post_attention,
               "flow_forward": fused_flow.flow_forward}[name]
    counts = (wrapper.launches, getattr(wrapper, "launches_int4", None))
    assert torch.isfinite(_call_on("cpu", name, tree)).all()
    assert (wrapper.launches, getattr(wrapper, "launches_int4", None)) \
        == counts
    with pytest.raises(ValueError, match="unsupported device"):
        _call_on("meta", name, tree)
