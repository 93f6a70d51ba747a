"""The port's A/B runner (python -m pocket_tts_tpu_torch.ab) against the
JAX package's (python -m pocket_tts_tpu.ab) on the fixture model
directory of tests/test_model_dir.py (tiny_config, random weights, the
ASCII SentencePiece model, voice `cosette`): the same probe keys; voice
and prefill KV sums, each frame's pcm sum and EOS flag as the JAX
runner's; the three quantization-error reports key for key within 1e-6;
the WAV; and a directory failing the manifest check exits 2. The port's
manifest helpers (io/fetch.py) against the JAX package's."""
import json
import os

import numpy as np
import pytest
import torch

from pocket_tts_tpu import ab as jab
from pocket_tts_tpu.io import fetch as jfetch
from pocket_tts_tpu_torch import ab as tab
from pocket_tts_tpu_torch.io import fetch as tfetch
from pocket_tts_tpu_torch.io.wav import load_wav
from test_model_dir import make_model_dir

torch.set_num_threads(1)
ARGS = ["--text", "Hi there.", "--frames", "4"]


@pytest.fixture(scope="module")
def probes(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ab")
    root, cfg0 = make_model_dir(tmp)
    out = {}
    assert jab.main(["--model-dir", root, "-o", str(tmp / "j"),
                     "--skip-verify", *ARGS]) == 0
    assert tab.main(["--model-dir", root, "-o", str(tmp / "t"),
                     "--no-verify", "-d", "cpu", *ARGS]) == 0
    for key in ("j", "t"):
        with open(tmp / key / "ab_probes.json") as f:
            out[key] = json.load(f)
    return out, tmp, root, cfg0


def test_probes_match_the_jax_runner(probes):
    (p, tmp, _, cfg0) = probes
    j, t = p["j"], p["t"]
    assert sorted(t) == sorted(j)
    assert t["voice_end"] == j["voice_end"]
    assert t["prefill_end"] == j["prefill_end"] > t["voice_end"]
    assert len(t["voice_kv_sum"]) == cfg0.backbone.num_layers
    for key in ("voice_kv_sum", "prefill_kv_sum"):
        np.testing.assert_allclose(t[key], j[key], rtol=1e-5, atol=1e-5)
    assert len(t["frame"]) == len(j["frame"]) == 4
    for ft, fj in zip(t["frame"], j["frame"]):
        assert sorted(ft) == sorted(fj)
        assert ft["eos"] == fj["eos"]
        np.testing.assert_allclose(ft["pcm_sum"], fj["pcm_sum"], rtol=1e-5)
        # the latent's few values cancel in the sum: absolute tolerance
        np.testing.assert_allclose(ft["latent_sum"], fj["latent_sum"],
                                   atol=1e-3)


@pytest.mark.parametrize("key", ["quant_rel_error_int4",
                                 "quant_rel_error_int8",
                                 "quant_rel_error_q4_0"])
def test_quantization_reports_match_the_jax_runner(probes, key):
    (p, _, _, _) = probes
    j, t = p["j"][key], p["t"][key]
    assert j and sorted(t) == sorted(j)
    for name, v in j.items():
        assert abs(t[name] - v) <= 1e-6, name
    assert all(0 <= e < 0.2 for e in t.values())


def test_wav_written(probes):
    (_, tmp, _, cfg0) = probes
    pcm, sr = load_wav(str(tmp / "t" / "ab_out.wav"))
    want, _ = load_wav(str(tmp / "j" / "ab_out.wav"))
    assert sr == cfg0.mimi.sample_rate and pcm.size == want.size > 0
    # 16-bit samples: at most one step apart (f32 summation order)
    np.testing.assert_allclose(pcm.astype(np.float32),
                               want.astype(np.float32), atol=1)


def test_verify_failure_exits_2(probes, capsys):
    (_, tmp, root, _) = probes
    assert tab.main(["--model-dir", root, "-o", str(tmp / "x"),
                     "-d", "cpu"]) == 2
    assert "failed verification" in capsys.readouterr().err


def test_manifest_helpers_match_jax(probes, tmp_path):
    (_, _, root, _) = probes
    assert tfetch.load_manifest() == jfetch.load_manifest()
    assert tfetch.verify_model_dir(root) == jfetch.verify_model_dir(root)
    f = tmp_path / "x.bin"
    f.write_bytes(os.urandom(3000))
    assert tfetch.sha256_file(str(f)) == jfetch.sha256_file(str(f))
    # a file matching its pin verifies "ok"
    entry = {"path": "m/x.bin", "sha256": jfetch.sha256_file(str(f))}
    assert tfetch.verify_model_dir(str(tmp_path), {
        "model": "m", "files": [entry]}) == {"x.bin": "ok"}
