"""The port's servers on one random checkpoint at tiny_config (f32):
continuous batching against the port's solo engine (atol 2e-5, the JAX
package's test_continuous.py tolerance) in ring mode, across a ring wrap
and through eager compaction; the same requests through the JAX
package's ContinuousBatchingServer and MultiStreamServer at temp 0 (atol
1e-4, the port's end-to-end tolerance); seeded noise at temp 0.7
independent of admission order; the refusals of what is not ported; and
CLI --serve."""
import dataclasses
import json
import os

import numpy as np
import jax
import pytest
import torch

from pocket_tts_tpu.config import tiny_config
from pocket_tts_tpu.io.params import params_from_flat, random_flat
from pocket_tts_tpu.runtime.engine import TTSEngine as JEngine
from pocket_tts_tpu.runtime.server import (
    ContinuousBatchingServer as JCBS, MultiStreamServer as JMSS)
from pocket_tts_tpu_torch.io.params import from_jax_numpy, random_voice_prompt
from pocket_tts_tpu_torch.runtime.engine import TTSEngine
from pocket_tts_tpu_torch.runtime.server import (ContinuousBatchingServer,
                                                 MultiStreamServer)
from pocket_tts_tpu_torch.text.preprocess import prepare_text_prompt
from pocket_tts_tpu_torch.text.tokenizer import MockTokenizer

torch.set_num_threads(1)
SOLO_ATOL = 2e-5
JAX_ATOL = 1e-4
CFG0 = dataclasses.replace(
    tiny_config(),
    backbone=dataclasses.replace(tiny_config().backbone, kv_capacity=256))
PJ, CFG = params_from_flat(random_flat(CFG0, seed=71), CFG0)
PT = from_jax_numpy(jax.tree.map(np.asarray, PJ))
VOICES = {"va": random_voice_prompt(CFG, 12, seed=1),
          "vb": random_voice_prompt(CFG, 16, seed=2)}
TEXT_A = "The first stream keeps the batch busy for quite a while longer."
TEXT_B = "Joining mid decode."
TEXT_C = "A third one, short."


def engine(seed=0, **kw):
    return TTSEngine(params=PT, cfg=CFG, seed=seed, device="cpu",
                     tokenizer=MockTokenizer(CFG.lut.n_bins), **kw)


def server(eng, lanes=2, chunk_frames=4, **kw):
    srv = ContinuousBatchingServer(eng, lanes=lanes,
                                   chunk_frames=chunk_frames,
                                   text_bucket=32, **kw)
    srv.register_voices(VOICES)
    return srv


def solo(eng, text, voice):
    prepared, guess = prepare_text_prompt(text)
    return eng.synthesize_sentence(eng.prime_voice(VOICES[voice]), prepared,
                                   0.0, guess + 2)


def test_mid_decode_admission_matches_solo():
    eng = engine()
    srv = server(eng)
    ra = srv.submit(TEXT_A, "va", temp=0.0)
    srv.step()
    srv.step()                          # A is mid-decode
    assert ra.ttfa_s is not None and srv._live.count(None) == 1
    rb = srv.submit(TEXT_B, "vb", temp=0.0)
    assert srv.step() > 0               # B admitted here, audio at once
    assert rb.ttfa_s is not None and rb.admit_step == 2
    srv.run_pending()
    for r, text, voice in ((ra, TEXT_A, "va"), (rb, TEXT_B, "vb")):
        want = solo(eng, text, voice)
        assert r.pcm.shape == want.shape
        np.testing.assert_allclose(r.pcm, want, atol=SOLO_ATOL, rtol=0)
    st = srv.stats()
    assert st["requests"] == 2 and st["p50_ttfa_s"] is not None


def test_ring_wrap_matches_solo():
    """B is admitted late enough that the shared cursor wraps inside the
    ring while B decodes: its rows land in recycled slots."""
    eng = engine()
    srv = server(eng)
    ring = srv.capacity - srv.prefix_slots
    ra = srv.submit(TEXT_A, "va", temp=0.0)
    for _ in range(40):
        srv.step()
    rb = srv.submit(TEXT_B, "vb", temp=0.0)
    wrapped = False
    while srv._queue or any(srv._live):
        before = srv.batch.flow.end
        srv.step()
        wrapped |= srv.batch is not None and srv.batch.flow.end < before
    assert wrapped, f"no wrap in a ring of {ring} slots"
    for r, text, voice in ((ra, TEXT_A, "va"), (rb, TEXT_B, "vb")):
        np.testing.assert_allclose(r.pcm, solo(eng, text, voice),
                                   atol=SOLO_ATOL, rtol=0)


def test_eager_compaction_matches_solo():
    eng = engine()
    srv = server(eng, ring=False, compact_margin=16)
    ra = srv.submit(TEXT_A, "va", temp=0.0)
    srv.step()
    rb = srv.submit(TEXT_B, "vb", temp=0.0)
    srv.run_pending()
    assert srv.compactions >= 1
    for r, text, voice in ((ra, TEXT_A, "va"), (rb, TEXT_B, "vb")):
        np.testing.assert_allclose(r.pcm, solo(eng, text, voice),
                                   atol=SOLO_ATOL, rtol=0)


def test_oversized_request_rejected_siblings_kept():
    eng = engine()
    srv = server(eng, lanes=3)
    r1 = srv.submit(TEXT_B, "va", temp=0.0)
    srv.submit(" ".join(["word"] * 60) + ".", "va", temp=0.0)
    r3 = srv.submit(TEXT_C, "vb", temp=0.0)
    with pytest.raises(ValueError, match="text_bucket"):
        srv.run_pending()
    srv.run_pending()
    assert [r.pcm is not None for r in (r1, r3)] == [True, True]
    np.testing.assert_allclose(r1.pcm, solo(eng, TEXT_B, "va"),
                               atol=SOLO_ATOL, rtol=0)
    np.testing.assert_allclose(r3.pcm, solo(eng, TEXT_C, "vb"),
                               atol=SOLO_ATOL, rtol=0)


def _jax_engine():
    return JEngine(params=PJ, cfg=CFG, seed=0,
                   tokenizer=MockTokenizer(CFG.lut.n_bins))


@pytest.mark.parametrize("ring", [True, False])
def test_continuous_server_matches_jax(ring):
    jsrv = JCBS(_jax_engine(), lanes=2, chunk_frames=4, text_bucket=32,
                ring=ring)
    jsrv.register_voices({k: np.asarray(v) for k, v in VOICES.items()})
    tsrv = server(engine(), ring=ring)
    reqs = []
    for srv in (jsrv, tsrv):
        a = srv.submit(TEXT_A, "va", temp=0.0)
        srv.step()
        b = srv.submit(TEXT_B, "vb", temp=0.0)
        c = srv.submit(TEXT_C, "va", temp=0.0)
        srv.run_pending()
        reqs.append((a, b, c))
    for rj, rt in zip(*reqs):
        assert rt.pcm.shape == rj.pcm.shape
        np.testing.assert_allclose(rt.pcm, rj.pcm, atol=JAX_ATOL, rtol=0)
        assert rt.admit_step == rj.admit_step


def test_multistream_server_matches_jax():
    jsrv = JMSS(_jax_engine(), max_batch=3, chunk_frames=10)
    tsrv = MultiStreamServer(engine(), max_batch=3, chunk_frames=10)
    reqs = []
    for srv in (jsrv, tsrv):
        srv.register_voices({k: np.asarray(v) for k, v in VOICES.items()})
        rs = [srv.submit(t, v, temp=0.0) for t, v in
              ((TEXT_A, "va"), (TEXT_B, "vb"), (TEXT_C, "vb"),
               (TEXT_B, "va"))]
        srv.run_pending()
        reqs.append(rs)
    for rj, rt in zip(*reqs):
        assert rt.pcm.shape == rj.pcm.shape
        np.testing.assert_allclose(rt.pcm, rj.pcm, atol=JAX_ATOL, rtol=0)
    assert tsrv.stats()["requests"] == 4


def test_seeded_noise_independent_of_admission_order():
    """temp 0.7: a request's audio depends on its seed, not on its lane or
    on when it was admitted."""
    eng = engine()
    out = []
    for order in ((0, 1, 2), (2, 1, 0)):
        srv = server(eng, lanes=2)
        reqs = {}
        for i, k in enumerate(order):
            reqs[k] = srv.submit((TEXT_A, TEXT_B, TEXT_C)[k],
                                 ("va", "vb", "va")[k], temp=0.7,
                                 seed=100 + k)
            if i == 0:
                srv.step()
        srv.run_pending()
        out.append(reqs)
    for k in range(3):
        np.testing.assert_allclose(out[0][k].pcm, out[1][k].pcm, atol=1e-5,
                                   rtol=0)
    assert not np.allclose(out[0][1].pcm, solo(eng, TEXT_B, "vb"))


def test_unseeded_requests_draw_engine_seeds():
    eng = engine(seed=3)
    srv = server(eng)
    r1 = srv.submit(TEXT_B, "va", temp=0.5)
    r2 = srv.submit(TEXT_B, "va", temp=0.5)
    srv.run_pending()
    assert r1.seed != r2.seed
    assert not np.allclose(r1.pcm, r2.pcm)
    assert engine(seed=3).request_seed() == r1.seed


@pytest.mark.parametrize("what", ["share_prefix", "quantize", "mesh"])
def test_unported_serving_options_raise(what):
    """What serving refuses: shared-prefix tables outside the prefix+ring
    mode (as the JAX server does) and quantized weights on a device mesh
    (a float mesh serves: tests/test_torch_sharding.py). Quantized convs,
    once refused, serve: with int8 weights and quantized convs both servers
    give the solo engine's audio (tests/test_torch_conv_quant.py serves a
    decoder whose convs quantize, in the serving mode)."""
    if what == "quantize":
        eng = engine(quantize="int8", quantize_convs=True)
        want = solo(eng, TEXT_B, "vb")
        for srv in (server(eng),
                    MultiStreamServer(eng, max_batch=2, chunk_frames=10)):
            srv.register_voices(VOICES)
            r = srv.submit(TEXT_B, "vb", temp=0.0)
            srv.run_pending()
            assert r.pcm.shape == want.shape
            np.testing.assert_allclose(r.pcm, want, atol=SOLO_ATOL, rtol=0)
        return
    if what == "share_prefix":
        with pytest.raises(ValueError, match="ring"):
            ContinuousBatchingServer(engine(), share_prefix=True,
                                     ring=False)
        return
    for cls in (ContinuousBatchingServer, MultiStreamServer):
        with pytest.raises(NotImplementedError, match="quantized"):
            cls(engine(quantize="int8"), mesh=object())


def test_cli_serve_writes_one_wav_per_request(tmp_path, monkeypatch,
                                              capsys):
    from pocket_tts_tpu_torch import cli, config
    from pocket_tts_tpu_torch.io.wav import load_wav
    monkeypatch.setattr(config, "DEFAULT_CONFIG", CFG)
    reqs = tmp_path / "reqs.txt"
    reqs.write_text("Hello world.\n\n"
                    + json.dumps({"text": "Second one here. And more.",
                                  "id": "two", "temp": 0}) + "\n")
    out = tmp_path / "out"
    assert cli.main(["--random-weights", "--device", "cpu", "-t", "0",
                     "--lanes", "2", "--serve", str(reqs), "--serve-out",
                     str(out)]) == 0
    assert sorted(os.listdir(out)) == ["req_0000.wav", "two.wav"]
    for name in os.listdir(out):
        pcm, sr = load_wav(str(out / name))
        assert sr == 24000 and pcm.size > 0 and pcm.size % 1920 == 0
    stats = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert stats["requests"] == 2 and stats["chunks"] >= 2


def test_cli_without_card_needs_device_cpu(capsys, tmp_path, monkeypatch):
    """Without a card the CLI needs --device cpu; with it --serve runs
    --quantize int8 --quantize-convs (once refused), one wav per
    request."""
    from pocket_tts_tpu_torch import cli, config
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert cli.main(["--random-weights", "--serve", "-"]) == 1
    assert "--device cpu" in capsys.readouterr().err
    monkeypatch.setattr(config, "DEFAULT_CONFIG", CFG)
    reqs = tmp_path / "reqs.txt"
    reqs.write_text("Hello world.\n")
    out = tmp_path / "out"
    assert cli.main(["--random-weights", "--device", "cpu", "-t", "0",
                     "--lanes", "2", "--serve", str(reqs), "--serve-out",
                     str(out), "--quantize", "int8",
                     "--quantize-convs"]) == 0
    assert os.listdir(out) == ["req_0000.wav"]
