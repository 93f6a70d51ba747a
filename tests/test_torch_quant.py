"""The port's int8 quantization against the JAX package's: the same
quantized leaves, bit for bit (q bytes and scale bits), on one random
checkpoint at tiny_config(64), where every backbone, mimi and flow linear
is large enough to quantize; the leaves that must stay plain; the option
not ported yet (quantized convs; int4 is in tests/test_torch_int4.py);
and from_jax_numpy keeping int8 and float32 scale leaves in their own
type under a dtype cast."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pocket_tts_tpu.config import tiny_config
from pocket_tts_tpu.io.params import params_from_flat as j_params_from_flat
from pocket_tts_tpu.io.params import random_flat
from pocket_tts_tpu.io.quant import quantize_params as j_quantize
from pocket_tts_tpu_torch.io.params import from_jax_numpy, params_from_flat
from pocket_tts_tpu_torch.io.quant import quantize_params

torch.set_num_threads(1)
CFG0 = tiny_config(64)
FLAT = random_flat(CFG0, seed=21)
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _quantized(tree, prefix=""):
    """{path: (q, scale)} of every quantized linear of a port tree."""
    out = {}
    if isinstance(tree, dict):
        if "q" in tree:
            out[prefix] = (tree["q"], tree["scale"])
        for k, v in tree.items():
            out.update(_quantized(v, f"{prefix}/{k}"))
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            out.update(_quantized(v, f"{prefix}/{i}"))
    return out


def _pair(name):
    jdt, tdt = DTYPES[name]
    pj, _ = j_params_from_flat(FLAT, CFG0, jdt)
    pt, _ = params_from_flat(FLAT, CFG0, tdt)
    return (from_jax_numpy(jax.tree.map(np.asarray, j_quantize(pj, bits=8))),
            quantize_params(pt))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_quantize_params_bit_identical_to_jax(dtype):
    want, got = (_quantized(t) for t in _pair(dtype))
    assert sorted(got) == sorted(want)
    # every backbone, mimi and flow-net linear quantizes at this width
    for path in ("/layers/in_proj", "/layers/linear2",
                 "/mimi/decoder_transformer/layers/out_proj",
                 "/flow_net/cond_embed", "/flow_net/res_blocks/adaln",
                 "/flow_net/res_blocks/mlp_2", "/flow_net/final/adaln"):
        assert path in got, path
    for path, (q, s) in got.items():
        wq, ws = want[path]
        assert q.dtype == torch.int8 and s.dtype == torch.float32, path
        # the kernels read row-major bytes
        assert q.is_contiguous() and s.is_contiguous(), path
        assert torch.equal(q, wq), path
        assert torch.equal(s.view(torch.int32), ws.view(torch.int32)), path


def test_small_weights_stay_plain():
    pj, pt = _pair("f32")
    for tree in (pj, pt):
        assert set(tree["out_eos"]) == {"w", "b"}
        # 8 x 256: under the 4096-element floor at this width
        assert "w" in tree["input_linear"]
        assert "w" in tree["flow_net"]["input_proj"]
        assert "w" in tree["mimi"]["quantizer"]
        assert "w" in tree["mimi"]["decoder"]["model_0"]
        assert tree["conditioner"]["embed"].dtype == torch.float32


@pytest.mark.parametrize("kw", [dict(convs=True)])
def test_options_not_ported_raise(kw):
    pt, _ = params_from_flat(FLAT, CFG0)
    with pytest.raises(NotImplementedError):
        quantize_params(pt, **kw)


def test_from_jax_numpy_keeps_int8_and_f32_scales():
    pj, _ = j_params_from_flat(FLAT, CFG0)
    tree = jax.tree.map(np.asarray, j_quantize(pj, bits=8))
    pt = from_jax_numpy(tree, dtype=torch.bfloat16)
    lin = pt["layers"]["in_proj"]
    assert lin["q"].dtype == torch.int8
    assert lin["scale"].dtype == torch.float32
    np.testing.assert_array_equal(lin["scale"].numpy(),
                                  tree["layers"]["in_proj"]["scale"])
    # the norms' "scale" is a weight like any other: cast
    assert pt["layers"]["norm1"]["scale"].dtype == torch.bfloat16
    assert pt["flow_net"]["cond_embed"]["b"].dtype == torch.bfloat16
    assert pt["out_eos"]["w"].dtype == torch.bfloat16
