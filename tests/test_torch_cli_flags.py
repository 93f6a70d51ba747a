"""The port's CLI (pocket_tts_tpu_torch/cli.py) takes every option of the
JAX package's CLI but --fetch-models, and each behaves
as there: --bench (fixed text, seed 0, temp 0), --json (the JAX CLI's keys,
solo and batched), -i, --interactive, --batch, -o .flac with --out-rate,
--profile, --play, --reference-exact, --compile-cache, --threads, -l and
-d. Driven in process on the CPU at a tiny DEFAULT_CONFIG, as
tests/test_torch_cli_model_root.py drives it (the JAX package's CLI tests
are slow-marked; the full-width model runs on the card, chip_smoke.py
phase 9)."""
import dataclasses
import io
import json
import os

import numpy as np
import pytest
import torch

from pocket_tts_tpu.cli import build_parser as jax_parser
from pocket_tts_tpu_torch import cli, config
from pocket_tts_tpu_torch.io.audio_in import load_audio, resample
from pocket_tts_tpu_torch.io.wav import load_wav
from pocket_tts_tpu_torch.ops import cuda_lib

torch.set_num_threads(1)
CFG = config.tiny_config()
CFG = dataclasses.replace(CFG, backbone=dataclasses.replace(
    CFG.backbone, kv_capacity=256))
BENCH = "The quick brown fox jumped over the sleeping dog."
SOLO_KEYS = {"metric", "value", "unit", "frames", "total_s", "rtf",
             "ttfa_ms"}       # pocket_tts_tpu/cli.py:433-438
BATCH_KEYS = {"metric", "value", "unit", "batch"}   # cli.py:350-352


@pytest.fixture(autouse=True)
def tiny(monkeypatch):
    monkeypatch.setattr(config, "DEFAULT_CONFIG", CFG)
    monkeypatch.setitem(cuda_lib._state, "build_dir", cuda_lib.BUILD_DIR)


def run(capsys, *argv):
    assert cli.main(["-d", "cpu", "--random-weights", *argv]) == 0
    return capsys.readouterr().out.strip().splitlines()


def _options(parser):
    return {s for a in parser._actions for s in a.option_strings}


def test_parser_has_every_jax_option_but_two():
    port, jax_ = _options(cli.build_parser()), _options(jax_parser())
    assert jax_ - port == {"--fetch-models"}
    assert port - jax_ == set()
    for argv in (["--bench"], ["-l"], ["--threads", "3", "x"]):
        jargs = vars(jax_parser().parse_args(argv))
        targs = vars(cli.build_parser().parse_args(argv))
        for key in targs.keys() - {"device"}:
            assert targs[key] == jargs[key], key


def test_quantize_convs_still_raises(capsys, tmp_path):
    """--quantize-convs, once refused, runs: with --quantize int8 the
    decoder's large convs quantize too (none does at this tiny width, so
    the audio is --quantize int8's), and the run says so."""
    a, b = str(tmp_path / "a.wav"), str(tmp_path / "b.wav")
    out = run(capsys, "-t", "0", "--quantize", "int8", "--quantize-convs",
              "-o", a, "Hello there.")
    assert any("int8 weights, quantized convs" in line for line in out)
    run(capsys, "-t", "0", "--quantize", "int8", "-o", b, "Hello there.")
    pa, pb = load_wav(a)[0], load_wav(b)[0]
    assert pa.size > 0 and np.array_equal(pa, pb)


def test_bench_json_gives_the_jax_keys(capsys, tmp_path):
    """--bench --json: one JSON line with the JAX CLI's keys; the bench
    defaults are the text, seed 0 and temperature 0 (the same audio as
    the explicit flags)."""
    a, b = str(tmp_path / "a.wav"), str(tmp_path / "b.wav")
    out = run(capsys, "--bench", "--json", "-o", a)
    rep = json.loads(out[-1])
    assert set(rep) == SOLO_KEYS and rep["metric"] == "frames_per_second"
    assert rep["unit"] == "frames/s" and rep["frames"] > 0
    assert rep["value"] > 0 and rep["ttfa_ms"] > 0
    assert rep["rtf"] == pytest.approx(rep["value"] / 12.5, abs=2e-3)
    assert f"frame count: {rep['frames']:4d} frames" in out
    assert "seed: 0" in out
    run(capsys, "-s", "0", "-t", "0", "-o", b, BENCH)
    assert np.array_equal(load_wav(a)[0], load_wav(b)[0])
    assert load_wav(a)[0].size == rep["frames"] * CFG.mimi.frame_size


def test_input_file_and_interactive(capsys, tmp_path, monkeypatch):
    """-i reads the text from a file; --interactive streams stdin lines
    and flushes at EOF: a WAV of whole frames."""
    txt = tmp_path / "in.txt"
    txt.write_text("Hello there.")
    a, b, c = (str(tmp_path / n) for n in ("a.wav", "b.wav", "c.wav"))
    run(capsys, "-t", "0", "-i", str(txt), "-o", a)
    run(capsys, "-t", "0", "-o", b, "Hello there.")
    assert np.array_equal(load_wav(a)[0], load_wav(b)[0])
    monkeypatch.setattr("sys.stdin", io.StringIO("Hello there.\nA second "
                                                  "line, here.\n"))
    out = run(capsys, "-t", "0", "--interactive", "--json", "-o", c)
    pcm, sr = load_wav(c)
    frames = json.loads(out[-1])["frames"]
    assert sr == 24000 and frames > 0
    assert pcm.size == frames * CFG.mimi.frame_size


def test_batch_json_flac_out_rate(capsys, tmp_path):
    """--batch 2 --json -o x.flac --out-rate 16000: the JAX CLI's batched
    JSON line, and the first stream's audio resampled to 16 kHz."""
    path = str(tmp_path / "x.flac")
    out = run(capsys, "-t", "0", "--batch", "2", "--json", "-o", path,
              "--out-rate", "16000", "Hello there, batch.")
    rep = json.loads(out[-1])
    assert set(rep) == BATCH_KEYS and rep["batch"] == 2
    assert rep["metric"] == "batched_frames_per_second" and rep["value"] > 0
    pcm, sr = load_audio(path)
    assert sr == 16000 and pcm.size > 0
    assert pcm.size % (CFG.mimi.frame_size * 2 // 3) == 0


def test_solo_flac_out_rate_is_the_resampled_stream(capsys, tmp_path):
    wav, flac = str(tmp_path / "a.wav"), str(tmp_path / "a.flac")
    run(capsys, "-t", "0", "-o", wav, "Hello there.")
    run(capsys, "-t", "0", "-o", flac, "--out-rate", "16000",
        "Hello there.")
    pcm24, sr24 = load_audio(wav)
    pcm16, sr16 = load_audio(flac)
    assert (sr24, sr16) == (24000, 16000)
    want = resample(pcm24, 24000, 16000)
    assert pcm16.shape == want.shape
    np.testing.assert_allclose(pcm16, want, atol=4e-4)


def test_list_devices(capsys, monkeypatch):
    assert cli.main(["-l"]) == 0
    assert "no CUDA device" in capsys.readouterr().out

    class Prop:
        name = "NVIDIA H100 80GB HBM3"
        total_memory = 85 * 2 ** 30

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda i: Prop())
    assert cli.main(["--list-devices"]) == 0
    assert capsys.readouterr().out == \
        "cuda:0: NVIDIA H100 80GB HBM3, 85.0 GiB\n"


def test_profile_writes_a_trace(capsys, tmp_path):
    d = tmp_path / "prof"
    out = run(capsys, "-t", "0", "--profile", str(d), "Hi.")
    path = d / "trace.json"
    assert f"wrote trace: {path}" in out
    assert json.loads(path.read_text())["traceEvents"]


def test_play_through_a_sink(capsys, tmp_path, monkeypatch):
    """--play pushes every frame through AudioPlayer (a file sink here:
    this machine has no player binary): the int16 stream of the WAV."""
    from pocket_tts_tpu_torch.runtime import player
    sink = io.BytesIO()

    class Player(player.AudioPlayer):
        def __init__(self, rate, **kw):
            super().__init__(rate, sink=sink, **kw)

    monkeypatch.setattr(player, "AudioPlayer", Player)
    wav = str(tmp_path / "a.wav")
    run(capsys, "-t", "0", "--play", "-o", wav, "Hello there.")
    played = np.frombuffer(sink.getvalue(), np.int16)
    np.testing.assert_array_equal(played, load_wav(wav)[0])


def test_reference_exact(capsys, tmp_path, monkeypatch):
    """--reference-exact runs reference_exact_config(DEFAULT_CONFIG) (the
    JAX CLI's :268-269) and composes with --quantize: other audio than
    the default config's (the float frames the encoder is given), whole
    frames."""
    from pocket_tts_tpu_torch.io import audio
    written = []

    class Encoder(audio.StreamingEncoder):
        def write(self, pcm):
            written[-1].append(np.array(pcm))
            super().write(pcm)

    monkeypatch.setattr(audio, "StreamingEncoder", Encoder)
    a = str(tmp_path / "a.wav")
    pcm = {}
    for key, extra in (("exact", ["--reference-exact"]), ("default", [])):
        written.append([])
        out = run(capsys, "-t", "0", *extra, "-o", a, "Hello there.")
        assert any("reference-exact" in line for line in out) == bool(extra)
        pcm[key] = np.concatenate(written[-1])
    assert pcm["exact"].shape == pcm["default"].shape
    assert not np.array_equal(pcm["exact"], pcm["default"])
    run(capsys, "-t", "0", "--reference-exact", "--quantize", "int8",
        "-o", a, "Hi.")
    assert load_wav(a)[0].size % CFG.mimi.frame_size == 0


def test_compile_cache_and_threads(capsys, tmp_path):
    d = str(tmp_path / "kernels")
    run(capsys, "-t", "0", "--threads", "2", "--compile-cache", d, "Hi.")
    assert os.path.isdir(d) and cuda_lib.build_dir() == d
