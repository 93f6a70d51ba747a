"""The port's io/audio_in.py (its own copy of the JAX package's) against
`pocket_tts_tpu/io/audio_in.py`: `resample` and `StreamingResampler` give
the same arrays (one-shot and fed in uneven chunks, up and down, with the
flush tail), and `load_audio` decodes WAV of every width (16/24/32-bit
int, float32/64, stereo, WAVE_FORMAT_EXTENSIBLE) and FLAC (verbatim,
constant and fixed subframes, as the JAX tests build them) to the same
arrays and rates, resampled on load too."""
import struct

import numpy as np
import pytest

from pocket_tts_tpu.io import audio_in as jin
from pocket_tts_tpu.io.audio import save_flac
from pocket_tts_tpu_torch.io import audio_in as tin

from test_audio_in import (_flac_frame, _flac_stream, _write_constant,
                           _write_fixed)

RATES = [(24000, 16000), (16000, 24000), (24000, 44100), (44100, 24000),
         (24000, 8000), (24000, 24000)]


def _x(n, seed=0):
    return (np.random.RandomState(seed).randn(n) * 0.3).astype(np.float32)


@pytest.mark.parametrize("si,so", RATES)
def test_resample_equals_jax(si, so):
    x = _x(7001, si % 13)
    got, want = tin.resample(x, si, so), jin.resample(x, si, so)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("si,so", RATES)
def test_streaming_resampler_equals_jax(si, so):
    x = _x(9000, 1)
    cuts = [0, 1, 17, 1920, 3840, 3841, 6000, 9000]
    rj, rt = jin.StreamingResampler(si, so), tin.StreamingResampler(si, so)
    for a, b in zip(cuts, cuts[1:]):
        np.testing.assert_array_equal(rt.process(x[a:b]),
                                      rj.process(x[a:b]))
    np.testing.assert_array_equal(rt.flush(), rj.flush())


def _wav(path, fmt, channels, bits, payload, extensible=None):
    byte_rate = 24000 * channels * bits // 8
    if extensible is None:
        fmt_chunk = struct.pack("<HHIIHH", fmt, channels, 24000, byte_rate,
                                channels * bits // 8, bits)
    else:
        guid = struct.pack("<H", extensible) + b"\x00\x00\x00\x00\x10\x00" \
            + b"\x80\x00\x00\xaa\x00\x38\x9b\x71"
        fmt_chunk = struct.pack("<HHIIHHHHI", 0xFFFE, channels, 24000,
                                byte_rate, channels * bits // 8, bits, 22,
                                bits, 0) + guid
    body = (b"WAVE" + b"fmt " + struct.pack("<I", len(fmt_chunk)) + fmt_chunk
            + b"LIST" + struct.pack("<I", 4) + b"INFO"
            + b"data" + struct.pack("<I", len(payload)) + payload)
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", len(body)) + body)
    return path


def _int24(vals):
    return b"".join(int(v & 0xFFFFFF).to_bytes(3, "little") for v in vals)


rng = np.random.RandomState(2)
WAVS = {
    "int16": (1, 1, 16, (rng.randn(999) * 8000).astype(np.int16).tobytes()),
    "int16_stereo": (1, 2, 16, (rng.randn(1000) * 8000).astype(np.int16)
                     .tobytes()),
    "int24": (1, 1, 24, _int24(rng.randint(-2 ** 23, 2 ** 23, 500))),
    "int32": (1, 1, 32, rng.randint(-2 ** 31, 2 ** 31 - 1, 500, np.int64)
              .astype(np.int32).tobytes()),
    "float32": (3, 1, 32, _x(600, 3).tobytes()),
    "float64_stereo": (3, 2, 64, (rng.randn(600) * 0.2).tobytes()),
}


@pytest.mark.parametrize("name", sorted(WAVS))
@pytest.mark.parametrize("rate", [None, 16000])
def test_load_wav_equals_jax(name, rate, tmp_path):
    path = _wav(str(tmp_path / "x.wav"), *WAVS[name])
    (got, sr_t), (want, sr_j) = tin.load_audio(path, rate), jin.load_audio(
        path, rate)
    assert sr_t == sr_j
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("sub", [1, 3])
def test_load_wav_extensible_equals_jax(sub, tmp_path):
    bits = 32
    payload = (_x(300, 4).tobytes() if sub == 3 else
               rng.randint(-2 ** 31, 2 ** 31 - 1, 300, np.int64)
               .astype(np.int32).tobytes())
    path = _wav(str(tmp_path / "x.wav"), 0, 1, bits, payload, extensible=sub)
    (got, _), (want, _) = tin.load_audio(path), jin.load_audio(path)
    np.testing.assert_array_equal(got, want)


def test_load_flac_equals_jax(tmp_path):
    """The encoder's verbatim file, and hand-built constant and fixed
    (order 1 and 2) subframes, mono and stereo (left/side)."""
    p1 = str(tmp_path / "v.flac")
    save_flac(p1, _x(10000, 5), 24000)
    s = np.round(np.sin(np.arange(64) / 5.0) * 3000).astype(np.int64)
    frames = [_flac_frame(0, 64, 0, [_write_constant(-1234)]),
              _flac_frame(1, 64, 0, [_write_fixed(s, 1)]),
              _flac_frame(2, 64, 0, [_write_fixed(s, 2)])]
    p2 = str(tmp_path / "f.flac")
    with open(p2, "wb") as f:
        f.write(_flac_stream(frames))
    p3 = str(tmp_path / "s.flac")
    with open(p3, "wb") as f:
        f.write(_flac_stream([_flac_frame(0, 64, 1, [
            _write_fixed(s, 1), _write_constant(77)])], channels=2))
    for p in (p1, p2, p3):
        for rate in (None, 16000):
            (got, sr_t), (want, sr_j) = (tin.load_audio(p, rate),
                                         jin.load_audio(p, rate))
            assert sr_t == sr_j
            np.testing.assert_array_equal(got, want)


def test_other_containers_need_ffmpeg(tmp_path, monkeypatch):
    import shutil
    monkeypatch.setattr(shutil, "which", lambda name: None)
    p = str(tmp_path / "x.mp3")
    with pytest.raises(RuntimeError) as ej:
        jin.load_audio(p)
    with pytest.raises(RuntimeError) as et:
        tin.load_audio(p)
    assert str(et.value) == str(ej.value)
