"""The checkpoint-driven modules end to end, the port against the JAX
package on the CPU:

- `synthesize` with SwiGLU gating and RMSNorm alphas in the mimi layers
  matches the JAX engine at temp 0 in float32 within 1e-3 of the audio's
  peak; with int8 weights (tiny_config(64), where the gating linears
  quantize) both engines give finite audio that agrees within 1e-3 too;
- a params tree carrying all four modules (gating, alphas, backbone and
  mimi cross-attention, the SEANet encoder), plain and quantized with
  convs, writes the JAX package's bytes to a safetensors params cache and
  to a `.gguf` one, and reads back leaf for leaf."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pocket_tts_tpu.config import tiny_config
from pocket_tts_tpu.io import quant as jq
from pocket_tts_tpu.io.params import params_from_flat as jload
from pocket_tts_tpu.runtime.engine import TTSEngine as JEngine
from pocket_tts_tpu.text.tokenizer import MockTokenizer
from pocket_tts_tpu_torch.io import quant as tq
from pocket_tts_tpu_torch.io.params import from_jax_numpy
from pocket_tts_tpu_torch.io.params import params_from_flat as tload
from pocket_tts_tpu_torch.io.params import random_voice_prompt
from pocket_tts_tpu_torch.runtime.engine import TTSEngine

from test_torch_cross import cross_flat
from test_torch_mimi_variants import gating_tree, mimi_flat
from test_torch_seanet_encoder import encoder_flat

torch.set_num_threads(1)
TEXT = "Hello world. Gated."


def with_gating(pj, pt, cfg, hdim):
    """Both packages' trees with the same SwiGLU weights in every mimi
    layer (gating reaches a model only through a tree)."""
    g = gating_tree(cfg.mimi.transformer, hdim)
    mj = pj["mimi"]["decoder_transformer"]
    mt = pt["mimi"]["decoder_transformer"]
    pj["mimi"]["decoder_transformer"] = {"layers": dict(
        mj["layers"], gating=jax.tree.map(jnp.asarray, g))}
    pt["mimi"]["decoder_transformer"] = {"layers": dict(
        mt["layers"], gating=from_jax_numpy(g))}
    return pj, pt


def gated_models(cfg0):
    flat = mimi_flat(cfg0, seed=13, rms=True)
    pj, cfg = jload(flat, cfg0)
    pt, _ = tload(flat, cfg0)
    return (*with_gating(pj, pt, cfg, 2 * cfg.mimi.transformer.d_model),
            cfg)


def _engines(pj, pt, cfg, quantize=None):
    tok = MockTokenizer(cfg.lut.n_bins)
    if quantize:
        pj = jq.quantize_params(pj, bits=8)
    return (JEngine(params=pj, cfg=cfg, tokenizer=tok),
            TTSEngine(params=pt, cfg=cfg, device="cpu", tokenizer=tok,
                      quantize=quantize))


@pytest.mark.parametrize("quantize", [None, "int8"])
def test_gated_alpha_synthesize_matches_jax(quantize):
    cfg0 = tiny_config(64) if quantize else tiny_config()
    pj, pt, cfg = gated_models(cfg0)
    je, te = _engines(pj, pt, cfg, quantize)
    if quantize:
        assert "q" in te.params["mimi"]["decoder_transformer"]["layers"][
            "gating"]["linear_in"]
    voice = random_voice_prompt(cfg, 16)
    want = je.synthesize(TEXT, voice, temp=0.0)
    got = te.synthesize(TEXT, voice, temp=0.0)
    assert got.shape == want.shape and got.size > 0
    assert np.isfinite(got).all()
    err = float(np.abs(got - want).max())
    assert err <= 1e-3 * float(np.abs(want).max())


def all_modules(cfg0):
    """(JAX tree, port tree) of one checkpoint with every module a
    checkpoint switches on."""
    flat = encoder_flat(cfg0, seed=5)
    for k, v in cross_flat(cfg0, seed=7).items():
        flat.setdefault(k, v)
    for k, v in mimi_flat(cfg0, seed=9, cross=True, rms=True).items():
        if ".alpha" in k or "cross" in k:
            flat[k] = v
    for k in [k for k in flat if k.startswith(
            "mimi.decoder_transformer") and (k.endswith("norm1.weight")
                                             or k.endswith("norm1.bias"))]:
        del flat[k]
    pj, cfg = jload(flat, cfg0)
    pt, _ = tload(flat, cfg0)
    pj, pt = with_gating(pj, pt, cfg, 64)
    # the constant time conditioning is computed at load, not loaded: the
    # two frameworks' float32 math differs in ulps; the caches compare
    # the loaded tree's bytes with the JAX value of this one leaf
    pt["_time_cond"] = torch.from_numpy(np.array(pj["_time_cond"]))
    lay = pt["mimi"]["decoder_transformer"]["layers"]
    assert {"gating", "cross_attention"} <= set(lay)
    assert set(lay["norm1"]) == {"alpha"} and "cross_attention" in \
        pt["layers"] and "encoder" in pt["mimi"]
    return pj, pt


@pytest.mark.parametrize("suffix", [".safetensors", ".gguf"])
@pytest.mark.parametrize("quant", [None, "int8", "int4"])
def test_params_cache_bytes_equal_jax(tmp_path, suffix, quant):
    pj, pt = all_modules(tiny_config(64))
    if quant:
        bits = 8 if quant == "int8" else 4
        pj = jq.quantize_params(pj, bits=bits, convs=True)
        pt = tq.quantize_params(pt, bits=bits, convs=True)
        assert ("qc" if bits == 8 else "qc4") in pt["mimi"]["encoder"][
            "model_11"]
    a, b = str(tmp_path / f"j{suffix}"), str(tmp_path / f"t{suffix}")
    jq.save_params_cache(pj, a)
    tq.save_params_cache(pt, b)
    assert open(a, "rb").read() == open(b, "rb").read()
    back = dict(tq._flatten(tq.load_params_cache(b)))
    for name, t in tq._flatten(pt):
        assert back[name].dtype == t.dtype and torch.equal(back[name], t), \
            name
