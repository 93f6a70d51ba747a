"""Raw RIFF 16-bit mono WAV read/write. ref: src/wav.h:19-86.

The port's own copy of `pocket_tts_tpu/io/wav.py`."""
from __future__ import annotations

import struct

import numpy as np


def save_wav(path: str, samples, sample_rate: int = 24000):
    """samples: float array in [-1, 1] or int16 array."""
    samples = np.asarray(samples)
    if samples.dtype != np.int16:
        samples = np.clip(samples, -1.0, 1.0)
        samples = (samples * 32767.0).astype(np.int16)
    data = samples.tobytes()
    with open(path, "wb") as f:
        f.write(b"RIFF")
        f.write(struct.pack("<I", 36 + len(data)))
        f.write(b"WAVEfmt ")
        f.write(struct.pack("<IHHIIHH", 16, 1, 1, sample_rate,
                            sample_rate * 2, 2, 16))
        f.write(b"data")
        f.write(struct.pack("<I", len(data)))
        f.write(data)


class StreamingWavWriter:
    """Incremental WAV writer for long-form synthesis: frames append as they
    are generated; RIFF/data sizes are patched on close. (The reference
    buffers all PCM in memory before save_wav — src/pocket_tts.cpp:215-235;
    chunked writing is the long-form streaming analog, BASELINE config 3.)
    """

    def __init__(self, path: str, sample_rate: int = 24000):
        self._f = open(path, "wb")
        self._sample_rate = sample_rate
        self._n = 0
        self._write_header(0)

    def _write_header(self, data_size: int):
        self._f.write(b"RIFF")
        self._f.write(struct.pack("<I", 36 + data_size))
        self._f.write(b"WAVEfmt ")
        self._f.write(struct.pack("<IHHIIHH", 16, 1, 1, self._sample_rate,
                                  self._sample_rate * 2, 2, 16))
        self._f.write(b"data")
        self._f.write(struct.pack("<I", data_size))

    def write(self, samples):
        samples = np.asarray(samples)
        if samples.dtype != np.int16:
            samples = (np.clip(samples, -1.0, 1.0) * 32767.0).astype(np.int16)
        self._f.write(samples.tobytes())
        self._n += samples.size

    def close(self):
        data_size = self._n * 2
        self._f.seek(0)
        self._write_header(data_size)
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def load_wav(path: str):
    """Returns (samples int16 np array, sample_rate)."""
    with open(path, "rb") as f:
        riff, _, wave = struct.unpack("<4sI4s", f.read(12))
        if riff != b"RIFF" or wave != b"WAVE":
            raise ValueError("not a RIFF/WAVE file")
        sample_rate = None
        while True:
            hdr = f.read(8)
            if len(hdr) < 8:
                raise ValueError("no data chunk found")
            tag, size = struct.unpack("<4sI", hdr)
            if tag == b"fmt ":
                fmt = f.read(size)
                (audio_format, channels, sample_rate, _, _,
                 bits) = struct.unpack("<HHIIHH", fmt[:16])
                if audio_format != 1 or channels != 1 or bits != 16:
                    raise ValueError("only PCM mono 16-bit supported")
            elif tag == b"data":
                data = f.read(size)
                return np.frombuffer(data, np.int16), sample_rate
            else:
                f.seek(size, 1)
