"""The port's quantized TTSEngine against the JAX TTSEngine with the same
`quantize` option (int8, q8, int4, q4, q4_0) on one random checkpoint at
tiny_config(64), where every backbone, mimi and flow linear quantizes,
under q4_0 with K-grouped scales (f32, temp 0, atol 1e-4 as
test_torch_e2e.py uses): offline `synthesize` and the `Stream` loop. The
checkpoint's weights are drawn at scale 0.05, not the default 0.02: at
0.02 the random SEANet biases dominate the pcm, and int8 weights move it
by less than 1e-7, so a match would not show that the quantized path
runs. The JAX engine runs its unfused XLA path off the TPU; the port runs
the plain versions of K4a/K4b, K5a, K5b and K6, which round where those
kernels round, identically in f32 up to summation order. Also the CLI
with --quantize and --device cpu."""
import numpy as np
import pytest
import torch

from pocket_tts_tpu.config import tiny_config
from pocket_tts_tpu.io.params import params_from_flat, random_flat
from pocket_tts_tpu.io.wav import load_wav
from pocket_tts_tpu.runtime.engine import TTSEngine as JEngine
from pocket_tts_tpu.text.tokenizer import MockTokenizer
from pocket_tts_tpu_torch.io.params import params_from_flat as \
    t_params_from_flat
from pocket_tts_tpu_torch.io.params import random_voice_prompt
from pocket_tts_tpu_torch.models import backbone
from pocket_tts_tpu_torch.ops import fused_flow, fused_layer
from pocket_tts_tpu_torch.ops.basic import slice_layer_params
from pocket_tts_tpu_torch.runtime.engine import TTSEngine

torch.set_num_threads(1)
ATOL = 1e-4
CFG0 = tiny_config(64)
FLAT = random_flat(CFG0, seed=13, scale=0.05)
PJ, CFG = params_from_flat(FLAT, CFG0)
VOICE = random_voice_prompt(CFG, 20)
TEXT = "Hello world. The quick brown fox jumps."


def jengine(quantize):
    return JEngine(params=PJ, cfg=CFG, seed=0, quantize=quantize,
                   tokenizer=MockTokenizer(CFG.lut.n_bins))


def tengine(quantize):
    pt, _ = t_params_from_flat(FLAT, CFG0)
    return TTSEngine(params=pt, cfg=CFG, seed=0, device="cpu",
                     quantize=quantize,
                     tokenizer=MockTokenizer(CFG.lut.n_bins))


QUANTIZE = ["int8", "q8", "int4", "q4", "q4_0"]
# the quantized weight key and the scale's type of each option
LAYOUT = {"int8": ("q", torch.float32), "q8": ("q", torch.float32),
          "int4": ("q4", torch.float32), "q4": ("q4", torch.float32),
          "q4_0": ("q4", torch.bfloat16)}


@pytest.mark.parametrize("quantize", QUANTIZE)
def test_engine_quantizes_and_routes_fused(quantize):
    p = tengine(quantize).params
    key, sdt = LAYOUT[quantize]
    assert key in p["layers"]["in_proj"] and "w" in p["out_eos"]
    assert p["layers"]["in_proj"]["scale"].dtype == sdt
    assert fused_layer.supported(slice_layer_params(p["layers"], 0))
    assert fused_layer.supported(slice_layer_params(
        p["mimi"]["decoder_transformer"]["layers"], 1))
    assert fused_flow.supported(p["flow_net"])


@pytest.mark.parametrize("quantize", QUANTIZE)
def test_synthesize_int8_temp0_matches_jax(quantize):
    want = jengine(quantize).synthesize(TEXT, VOICE, temp=0.0)
    eng = tengine(quantize)
    got = eng.synthesize(TEXT, VOICE, temp=0.0)
    assert got.shape == want.shape and got.size > 0
    assert got.size % eng.frame_size == 0
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    # quantizing moves the audio by more than the tolerance: the match is
    # one of two quantized runs
    plain = tengine(None).synthesize(TEXT, VOICE, temp=0.0)
    assert np.abs(plain - got).max() > ATOL


def _drain(stream, text):
    frames = []
    for pos in range(0, len(text), 15):
        stream.send(text[pos:pos + 15])
        if pos + 15 >= len(text):
            stream.flush()
        while (f := stream.receive()) is not None:
            frames.append(np.asarray(f))
    while (f := stream.receive()) is not None:
        frames.append(np.asarray(f))
    return np.concatenate(frames) if frames else np.zeros(0, np.float32)


@pytest.mark.parametrize("quantize", QUANTIZE)
def test_stream_loop_int8_temp0_matches_jax(quantize):
    want = _drain(jengine(quantize).open_stream(VOICE, temp=0.0), TEXT)
    got = _drain(tengine(quantize).open_stream(VOICE, temp=0.0), TEXT)
    assert got.shape == want.shape and got.size > 0
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("quantize", ["int8", "q4_0"])
def test_decode_step_takes_fused_route_only_at_t1(monkeypatch, quantize):
    """Prefill (T > 1) stays unfused, as in the JAX package; each decode
    step runs K5a and K5b once per backbone layer."""
    calls = []
    real = fused_layer.pre_attention
    monkeypatch.setattr(fused_layer, "pre_attention",
                        lambda p, x, eps=1e-5: calls.append(x.shape[0])
                        or real(p, x, eps))
    eng = tengine(quantize)
    vstate = eng.prime_voice(VOICE)
    assert calls == []
    state, _ = eng._prefill_sentence(vstate, "Hello world.")
    assert calls == []
    from pocket_tts_tpu_torch.models import flow_lm
    flow_lm.decode_step(eng.params, eng.cfg, state.flow, state.prev_latent,
                        torch.zeros(CFG.latent_dim))
    assert calls == [1] * CFG.backbone.num_layers
    assert isinstance(state.flow, backbone.BackboneState)


@pytest.mark.parametrize("quantize", QUANTIZE)
def test_cli_quantized_writes_wav(tmp_path, quantize, monkeypatch, capsys):
    from pocket_tts_tpu_torch import cli
    from pocket_tts_tpu_torch.io import params as tparams
    real = tparams.random_params
    monkeypatch.setattr(tparams, "random_params",
                        lambda cfg, **kw: real(CFG0, **kw))
    out = str(tmp_path / "out.wav")
    assert cli.main(["--random-weights", "--device", "cpu", "--quantize",
                     quantize, "-t", "0", "-o", out, "Hello world."]) == 0
    weights = {"q8": "int8", "q4": "int4"}.get(quantize, quantize)
    assert f"{weights} weights" in capsys.readouterr().out
    pcm, sr = load_wav(out)
    assert sr == 24000 and pcm.size > 0 and pcm.size % 1920 == 0
