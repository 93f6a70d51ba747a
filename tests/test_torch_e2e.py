"""The port's TTSEngine against the JAX TTSEngine on one random checkpoint
(tiny_config, f32, atol 1e-4 as test_e2e_torch.py uses): voice priming,
offline `synthesize` and the `Stream` loop at temp 0, and a temp > 0 run
with the JAX package's noise injected into the port."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pocket_tts_tpu.config import tiny_config
from pocket_tts_tpu.io.params import params_from_flat, random_flat
from pocket_tts_tpu.io.wav import load_wav
from pocket_tts_tpu.runtime.engine import TTSEngine as JEngine
from pocket_tts_tpu.text.tokenizer import MockTokenizer
from pocket_tts_tpu_torch.io.params import from_jax_numpy, random_voice_prompt
from pocket_tts_tpu_torch.runtime.engine import TTSEngine

torch.set_num_threads(1)
ATOL = 1e-4
CFG0 = tiny_config()
PJ, CFG = params_from_flat(random_flat(CFG0, seed=11), CFG0)
PT = from_jax_numpy(jax.tree.map(np.asarray, PJ))
VOICE = random_voice_prompt(CFG, 20)
TEXT = "Hello world. The quick brown fox jumps over the lazy dog."


def jengine(seed=0):
    return JEngine(params=PJ, cfg=CFG, seed=seed,
                   tokenizer=MockTokenizer(CFG.lut.n_bins))


def tengine(seed=0, cls=TTSEngine, **kw):
    kw.setdefault("device", "cpu")
    return cls(params=PT, cfg=CFG, seed=seed,
               tokenizer=MockTokenizer(CFG.lut.n_bins), **kw)


class JaxNoiseEngine(TTSEngine):
    """Draws the JAX engine's exact noise: frame i of sentence c uses
    normal(fold_in(fold_in(PRNGKey(seed), c), i)) * sqrt(temp)."""

    _sentence = 0
    _frame = 0

    def _prefill_sentence(self, voice_state, text):
        self._sentence += 1
        self._frame = 0
        return super()._prefill_sentence(voice_state, text)

    def _draw_noise(self, temp):
        key = jax.random.fold_in(
            jax.random.fold_in(jax.random.PRNGKey(self.seed), self._sentence),
            self._frame)
        self._frame += 1
        n = jnp.sqrt(jnp.float32(temp)) * jax.random.normal(
            key, (self.cfg.latent_dim,), jnp.float32)
        return torch.from_numpy(np.array(n))


def test_prime_voice_state_matches():
    vj = jengine().prime_voice(VOICE)
    vt = tengine().prime_voice(VOICE)
    assert vt.end == int(vj.end) and vt.next_pos == int(vj.next_pos)
    np.testing.assert_array_equal(vt.pos.numpy(), np.asarray(vj.pos))
    for l in range(len(vj.k)):
        np.testing.assert_allclose(vt.k[l].numpy(), np.asarray(vj.k[l]),
                                   atol=ATOL, rtol=0)
        np.testing.assert_allclose(vt.v[l].numpy(), np.asarray(vj.v[l]),
                                   atol=ATOL, rtol=0)


def test_synthesize_temp0_matches_jax():
    want = jengine().synthesize(TEXT, VOICE, temp=0.0)
    eng = tengine()
    got = eng.synthesize(TEXT, VOICE, temp=0.0)
    assert got.shape == want.shape and got.size % eng.frame_size == 0
    assert got.size > 0
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_synthesize_with_injected_jax_noise():
    want = jengine(seed=3).synthesize(TEXT, VOICE, temp=0.7)
    got = tengine(seed=3, cls=JaxNoiseEngine).synthesize(TEXT, VOICE,
                                                         temp=0.7)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


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


def test_stream_loop_temp0_matches_jax():
    want = _drain(jengine().open_stream(VOICE, temp=0.0), TEXT)
    got = _drain(tengine().open_stream(VOICE, temp=0.0), TEXT)
    assert got.shape == want.shape and got.size > 0
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_same_seed_same_audio_and_wav(tmp_path):
    a = tengine(seed=5).synthesize("Hi there.", VOICE, temp=0.7)
    b = tengine(seed=5).synthesize("Hi there.", VOICE, temp=0.7)
    np.testing.assert_array_equal(a, b)
    path = str(tmp_path / "o.wav")
    pcm = tengine().synthesize_to_wav("Hi there.", VOICE, path, temp=0.0)
    back, sr = load_wav(path)
    assert sr == CFG.mimi.sample_rate and back.size == pcm.size


@pytest.mark.parametrize("option", [dict(quantize="int4",
                                         quantize_convs=True),
                                    dict(quantize_convs=True)])
def test_quantize_options_not_ported_raise(option):
    """Quantized convs are not ported yet (quantize_kv runs: see
    tests/test_torch_share_prefix.py)."""
    with pytest.raises(NotImplementedError):
        tengine(**option)


def test_no_card_raises_instead_of_running_on_cpu(monkeypatch):
    """The engine and the CLI default to the card; without one they raise
    (the CLI exits 1) rather than run on the CPU. The CPU takes an explicit
    device."""
    from pocket_tts_tpu_torch import cli
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TTSEngine(params=PT, cfg=CFG,
                  tokenizer=MockTokenizer(CFG.lut.n_bins))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tengine(device="cuda")
    assert cli.main(["--random-weights", "-o", "/dev/null", "Hi."]) == 1


@pytest.mark.parametrize("argv", [["--device", "cpu", "-s", "1", "-t",
                                   "0.7"]])
def test_cli_writes_wav(tmp_path, argv, monkeypatch):
    """The CLI's main path at tiny size (the full-size model is exercised
    on the card by chip_smoke.py)."""
    from pocket_tts_tpu_torch import cli
    from pocket_tts_tpu_torch.io import params as tparams
    real = tparams.random_params
    monkeypatch.setattr(tparams, "random_params",
                        lambda cfg, **kw: real(CFG0, **kw))
    out = str(tmp_path / "out.wav")
    assert cli.main(["--random-weights", *argv, "-o", out,
                     "Hello world."]) == 0
    pcm, sr = load_wav(out)
    assert sr == 24000 and pcm.size > 0 and pcm.size % 1920 == 0
