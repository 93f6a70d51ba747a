"""The port's TTSEngine(quantize="int8") against the JAX TTSEngine with
quantize="int8" on one random checkpoint at tiny_config(64), where every
backbone, mimi and flow linear quantizes (f32, temp 0, atol 1e-4 as
test_torch_e2e.py uses): offline `synthesize` and the `Stream` loop. The
checkpoint's weights are drawn at scale 0.05, not the default 0.02: at
0.02 the random SEANet biases dominate the pcm, and int8 weights move it
by less than 1e-7, so a match would not show that the int8 path runs. The
JAX engine runs its unfused XLA path off the TPU; the port runs the plain
versions of K4a, K5a, K5b and K6, which round where those kernels round,
identically in f32. Also the CLI with --quantize int8 --device cpu."""
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


@pytest.mark.parametrize("quantize", ["int8", "q8"])
def test_engine_quantizes_and_routes_fused(quantize):
    p = tengine(quantize).params
    assert "q" in p["layers"]["in_proj"] and "w" in p["out_eos"]
    assert fused_layer.supported(slice_layer_params(p["layers"], 0))
    assert fused_layer.supported(slice_layer_params(
        p["mimi"]["decoder_transformer"]["layers"], 1))
    assert fused_flow.supported(p["flow_net"])


def test_synthesize_int8_temp0_matches_jax():
    want = jengine("int8").synthesize(TEXT, VOICE, temp=0.0)
    eng = tengine("int8")
    got = eng.synthesize(TEXT, VOICE, temp=0.0)
    assert got.shape == want.shape and got.size > 0
    assert got.size % eng.frame_size == 0
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    # int8 moves the audio by more than the tolerance: the match is one of
    # two int8 runs
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


def test_stream_loop_int8_temp0_matches_jax():
    want = _drain(jengine("int8").open_stream(VOICE, temp=0.0), TEXT)
    got = _drain(tengine("int8").open_stream(VOICE, temp=0.0), TEXT)
    assert got.shape == want.shape and got.size > 0
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_decode_step_takes_fused_route_only_at_t1(monkeypatch):
    """Prefill (T > 1) stays unfused, as in the JAX package; each decode
    step runs K5a and K5b once per backbone layer."""
    calls = []
    real = fused_layer.pre_attention
    monkeypatch.setattr(fused_layer, "pre_attention",
                        lambda p, x, eps=1e-5: calls.append(x.shape[0])
                        or real(p, x, eps))
    eng = tengine("int8")
    vstate = eng.prime_voice(VOICE)
    assert calls == []
    state, _ = eng._prefill_sentence(vstate, "Hello world.")
    assert calls == []
    from pocket_tts_tpu_torch.models import flow_lm
    flow_lm.decode_step(eng.params, eng.cfg, state.flow, state.prev_latent,
                        torch.zeros(CFG.latent_dim))
    assert calls == [1] * CFG.backbone.num_layers
    assert isinstance(state.flow, backbone.BackboneState)


@pytest.mark.parametrize("quantize", ["int8", "q8"])
def test_cli_quantized_writes_wav(tmp_path, quantize, monkeypatch, capsys):
    from pocket_tts_tpu_torch import cli
    from pocket_tts_tpu_torch.io import params as tparams
    real = tparams.random_params
    monkeypatch.setattr(tparams, "random_params",
                        lambda cfg, **kw: real(CFG0, **kw))
    out = str(tmp_path / "out.wav")
    assert cli.main(["--random-weights", "--device", "cpu", "--quantize",
                     quantize, "-t", "0", "-o", out, "Hello world."]) == 0
    assert "int8 weights" in capsys.readouterr().out
    pcm, sr = load_wav(out)
    assert sr == 24000 and pcm.size > 0 and pcm.size % 1920 == 0
