"""Compressed audio output: FLAC (self-contained) + mp3/ogg (ffmpeg pipe).

The port's own copy of `pocket_tts_tpu/io/audio.py` (that module imports
no JAX, but the port imports nothing of the JAX package). The `-o`
surface of the reference's FFmpeg encoder helpers
(demos/ffmpeg_helpers.h:50-658, demos/pocket-tts.cpp:377-448):

- .wav      -> io/wav.py (native)
- .flac     -> a self-contained FLAC encoder below (verbatim subframes —
               lossless, spec-conformant, readable by every player; no
               compression modeling, so ~= wav size)
- .mp3/.ogg -> stream PCM into an `ffmpeg` binary when one exists on
               PATH; otherwise a loud, actionable error.

The FLAC bit format implemented from the public spec: fLaC magic,
STREAMINFO block, fixed-blocksize frames with UTF-8-coded frame numbers,
CRC-8 header / CRC-16 frame checksums, VERBATIM subframes. The bytes
equal the JAX package's (tests/test_torch_audio.py).
"""
from __future__ import annotations

import os
import shutil
import struct
import subprocess
from typing import Optional

import numpy as np

_FLAC_BLOCK = 4096


class _BitWriter:
    def __init__(self):
        self.buf = bytearray()
        self._acc = 0
        self._nbits = 0

    def write(self, value: int, bits: int):
        self._acc = (self._acc << bits) | (value & ((1 << bits) - 1))
        self._nbits += bits
        while self._nbits >= 8:
            self._nbits -= 8
            self.buf.append((self._acc >> self._nbits) & 0xFF)
        self._acc &= (1 << self._nbits) - 1

    def align(self):
        if self._nbits:
            self.write(0, 8 - self._nbits)

    def bytes(self) -> bytes:
        assert self._nbits == 0
        return bytes(self.buf)


def _crc8(data: bytes) -> int:
    crc = 0
    for b in data:
        crc ^= b
        for _ in range(8):
            crc = ((crc << 1) ^ 0x07) & 0xFF if crc & 0x80 else (crc << 1) & 0xFF
    return crc


def _crc16(data: bytes) -> int:
    crc = 0
    for b in data:
        crc ^= b << 8
        for _ in range(8):
            crc = ((crc << 1) ^ 0x8005) & 0xFFFF if crc & 0x8000 \
                else (crc << 1) & 0xFFFF
    return crc


def _utf8_code(n: int) -> bytes:
    """FLAC's UTF-8-style variable-length integer (frame numbers)."""
    if n < 0x80:
        return bytes([n])
    out = []
    nbytes = 2
    while n >= (1 << (nbytes * 5 + 1)) and nbytes < 6:
        nbytes += 1
    lead = (0xFF << (8 - nbytes)) & 0xFF
    shift = 6 * (nbytes - 1)
    out.append(lead | (n >> shift))
    for i in range(nbytes - 1):
        shift -= 6
        out.append(0x80 | ((n >> shift) & 0x3F))
    return bytes(out)


def _pcm16(pcm: np.ndarray) -> np.ndarray:
    if pcm.dtype == np.int16:
        return pcm
    return np.clip(np.asarray(pcm, np.float32) * 32767.0,
                   -32768, 32767).astype(np.int16)


def save_flac(path: str, pcm: np.ndarray, sample_rate: int):
    """Write mono 16-bit FLAC (verbatim subframes)."""
    samples = _pcm16(np.asarray(pcm).reshape(-1))
    n = samples.size
    out = bytearray(b"fLaC")
    # STREAMINFO (last metadata block, type 0, 34 bytes)
    si = _BitWriter()
    si.write(_FLAC_BLOCK, 16)               # min blocksize
    si.write(_FLAC_BLOCK, 16)               # max blocksize
    si.write(0, 24)                          # min framesize unknown
    si.write(0, 24)                          # max framesize unknown
    si.write(sample_rate, 20)
    si.write(0, 3)                           # channels - 1 (mono)
    si.write(15, 5)                          # bits per sample - 1
    si.write(n, 36)
    body = si.bytes() + b"\x00" * 16         # md5 unknown (all zero)
    out += bytes([0x80])                      # last-block flag | type 0
    out += len(body).to_bytes(3, "big")
    out += body

    for fno, start in enumerate(range(0, n, _FLAC_BLOCK)):
        block = samples[start:start + _FLAC_BLOCK]
        bs = block.size
        hdr = _BitWriter()
        hdr.write(0b11111111111110, 14)      # sync
        hdr.write(0, 1)                       # reserved
        hdr.write(0, 1)                       # fixed blocksize stream
        hdr.write(0b1100 if bs == 4096 else 0b0111, 4)   # blocksize code
        hdr.write(0b0000, 4)                  # sample rate: from STREAMINFO
        hdr.write(0b0000, 4)                  # mono
        hdr.write(0b100, 3)                   # 16 bits/sample
        hdr.write(0, 1)                       # reserved
        head = hdr.bytes() + _utf8_code(fno)
        if bs != 4096:
            head += struct.pack(">H", bs - 1)
        head += bytes([_crc8(head)])

        sub = _BitWriter()
        sub.write(0, 1)                       # zero pad
        sub.write(0b000001, 6)                # VERBATIM
        sub.write(0, 1)                       # no wasted bits
        for s in block.astype(np.int32):
            sub.write(int(s) & 0xFFFF, 16)
        sub.align()
        frame = head + sub.bytes()
        frame += struct.pack(">H", _crc16(frame))
        out += frame

    with open(path, "wb") as f:
        f.write(bytes(out))


# ---------------------------------------------------------------------------
# ffmpeg pipe (gated)
# ---------------------------------------------------------------------------

def ffmpeg_available() -> bool:
    return shutil.which("ffmpeg") is not None


def _ffmpeg_cmd(path: str, sample_rate: int):
    return ["ffmpeg", "-y", "-loglevel", "error",
            "-f", "s16le", "-ar", str(sample_rate), "-ac", "1", "-i", "-",
            path]


def save_via_ffmpeg(path: str, pcm: np.ndarray, sample_rate: int):
    if not ffmpeg_available():
        raise RuntimeError(
            f"writing {os.path.splitext(path)[1]} requires an `ffmpeg` "
            "binary on PATH (none found). Use .wav or .flac, or install "
            "ffmpeg (the reference links FFmpeg for the same feature, "
            "demos/ffmpeg_helpers.h).")
    proc = subprocess.run(_ffmpeg_cmd(path, sample_rate),
                          input=_pcm16(np.asarray(pcm).reshape(-1)).tobytes(),
                          capture_output=True)
    if proc.returncode != 0:
        raise RuntimeError(f"ffmpeg failed: {proc.stderr.decode()[-500:]}")


class StreamingEncoder:
    """Frame-at-a-time writer for any supported extension.

    wav appends natively; flac buffers frames and encodes on close (the
    encoder is block-based anyway); mp3/ogg keep an ffmpeg process's stdin
    open for true streaming encode.
    """

    def __init__(self, path: str, sample_rate: int):
        self.path = path
        self.sample_rate = sample_rate
        ext = os.path.splitext(path)[1].lower()
        self.ext = ext
        self._buf = []
        self._proc: Optional[subprocess.Popen] = None
        if ext == ".wav":
            from .wav import StreamingWavWriter
            self._wav = StreamingWavWriter(path, sample_rate)
        elif ext == ".flac":
            pass
        elif ext in (".mp3", ".ogg", ".opus", ".m4a"):
            if not ffmpeg_available():
                raise RuntimeError(
                    f"streaming {ext} requires an `ffmpeg` binary on PATH; "
                    "use .wav or .flac instead.")
            self._proc = subprocess.Popen(
                _ffmpeg_cmd(path, sample_rate), stdin=subprocess.PIPE,
                stderr=subprocess.DEVNULL)
        else:
            raise ValueError(f"unsupported audio extension: {ext}")

    def write(self, pcm: np.ndarray):
        if self.ext == ".wav":
            self._wav.write(pcm)
        elif self._proc is not None:
            self._proc.stdin.write(_pcm16(np.asarray(pcm).reshape(-1))
                                   .tobytes())
        else:
            self._buf.append(np.asarray(pcm).reshape(-1))

    def close(self):
        if self.ext == ".wav":
            self._wav.close()
        elif self._proc is not None:
            self._proc.stdin.close()
            if self._proc.wait() != 0:
                raise RuntimeError("ffmpeg exited with an error")
        else:
            pcm = (np.concatenate(self._buf) if self._buf
                   else np.zeros(0, np.float32))
            save_flac(self.path, pcm, self.sample_rate)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def save_audio(path: str, pcm: np.ndarray, sample_rate: int):
    """Extension-dispatched one-shot save (the reference's `-o` surface)."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".wav":
        from .wav import save_wav
        save_wav(path, pcm, sample_rate)
    elif ext == ".flac":
        save_flac(path, pcm, sample_rate)
    elif ext in (".mp3", ".ogg", ".opus", ".m4a"):
        save_via_ffmpeg(path, pcm, sample_rate)
    else:
        raise ValueError(f"unsupported audio extension: {ext}")
