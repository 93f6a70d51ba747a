"""The port's io/audio.py (its own copy of the JAX package's) against
`pocket_tts_tpu/io/audio.py`: FLAC files byte for byte (block edges, more
than 128 frames for the multi-byte frame numbers, int16 input),
`StreamingEncoder` for .wav and .flac in frames, `save_audio`'s dispatch,
and the same errors for a missing ffmpeg and an unknown extension."""
import numpy as np
import pytest

from pocket_tts_tpu.io import audio as jaudio
from pocket_tts_tpu_torch.io import audio as taudio


def _pcm(n, seed=0):
    return np.clip(np.random.RandomState(seed).randn(n) * 0.4, -1.2,
                   1.2).astype(np.float32)


@pytest.mark.parametrize("n", [0, 1, 4095, 4096, 4097, 12000,
                               129 * 4096 + 5])
def test_save_flac_bytes_equal_jax(n, tmp_path):
    pcm = _pcm(n, n % 97)
    jp, tp = str(tmp_path / "j.flac"), str(tmp_path / "t.flac")
    jaudio.save_flac(jp, pcm, 24000)
    taudio.save_flac(tp, pcm, 24000)
    with open(jp, "rb") as a, open(tp, "rb") as b:
        assert a.read() == b.read()


def test_save_flac_int16_and_rate(tmp_path):
    pcm = (np.arange(-5000, 5000, 3) * 3).astype(np.int16)
    for mod, name in ((jaudio, "j"), (taudio, "t")):
        mod.save_flac(str(tmp_path / f"{name}.flac"), pcm, 16000)
    assert ((tmp_path / "j.flac").read_bytes()
            == (tmp_path / "t.flac").read_bytes())


def test_helpers_equal_jax():
    for n in (0, 5, 127, 128, 2047, 2048, 65535, 65536, 2 ** 21, 2 ** 26):
        assert taudio._utf8_code(n) == jaudio._utf8_code(n)
    blob = bytes(range(256)) * 3
    assert taudio._crc8(blob) == jaudio._crc8(blob)
    assert taudio._crc16(blob) == jaudio._crc16(blob)


@pytest.mark.parametrize("ext", [".wav", ".flac"])
def test_streaming_encoder_bytes_equal_jax(ext, tmp_path):
    frames = [_pcm(1920, i) for i in range(7)]
    for mod, name in ((jaudio, "j"), (taudio, "t")):
        with mod.StreamingEncoder(str(tmp_path / f"{name}{ext}"),
                                  24000) as enc:
            for f in frames:
                enc.write(f)
    assert ((tmp_path / f"j{ext}").read_bytes()
            == (tmp_path / f"t{ext}").read_bytes())


@pytest.mark.parametrize("ext", [".wav", ".flac"])
def test_save_audio_bytes_equal_jax(ext, tmp_path):
    pcm = _pcm(5000, 3)
    jaudio.save_audio(str(tmp_path / f"j{ext}"), pcm, 24000)
    taudio.save_audio(str(tmp_path / f"t{ext}"), pcm, 24000)
    assert ((tmp_path / f"j{ext}").read_bytes()
            == (tmp_path / f"t{ext}").read_bytes())


def _error(fn):
    try:
        fn()
    except Exception as e:  # the two packages' errors compared below
        return type(e), str(e)
    return None


def test_same_errors_without_ffmpeg(tmp_path, monkeypatch):
    """No ffmpeg on PATH: .mp3 raises the JAX package's RuntimeError, an
    unknown extension its ValueError, one-shot and streaming."""
    import shutil
    monkeypatch.setattr(shutil, "which", lambda name: None)
    pcm = _pcm(100)
    for path in ("x.mp3", "x.ogg", "x.xyz"):
        p = str(tmp_path / path)
        want = _error(lambda: jaudio.save_audio(p, pcm, 24000))
        assert want is not None
        assert _error(lambda: taudio.save_audio(p, pcm, 24000)) == want
        want = _error(lambda: jaudio.StreamingEncoder(p, 24000))
        assert want is not None
        assert _error(lambda: taudio.StreamingEncoder(p, 24000)) == want
    assert not taudio.ffmpeg_available()
