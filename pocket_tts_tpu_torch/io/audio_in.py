"""Audio input: decode + resample (the reference's Decoder/Resampler).

The port's own copy of `pocket_tts_tpu/io/audio_in.py`. The reference's
demos/ffmpeg_helpers.h:50-251 has a `Decoder` that pulls PCM frames out of
any libav container and a `Resampler` (libswresample) that converts
rate/format/layout. Without the FFmpeg libraries the pipeline is rebuilt
here:

- decode: WAV (PCM 16/24/32-bit int + float32, any channel count) and
  FLAC (verbatim/constant/fixed subframes — a superset of what
  io/audio.py's encoder emits) are parsed directly; other containers
  pipe through an `ffmpeg` *binary* when one is on PATH (decode and
  resample in one pipe, exactly the Decoder->Resampler composition).
- resample: a rational polyphase windowed-sinc resampler
  (`resample` one-shot, `StreamingResampler` frame-at-a-time with the
  same carry/flush semantics as the reference's swr wrapper: process()
  returns whatever is ready, flush() drains the filter tail).

Everything returns float32 mono in [-1, 1]. The arrays equal the JAX
package's (tests/test_torch_audio.py).
"""
from __future__ import annotations

import os
import struct
import subprocess
from typing import Optional

import numpy as np

from .audio import ffmpeg_available

# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------


def _to_mono_f32(x: np.ndarray) -> np.ndarray:
    """(n, ch) or (n,) any-dtype PCM -> mono float32 in [-1, 1]."""
    if x.ndim == 2 and x.shape[1] > 1:
        x = np.asarray(x, np.float32).mean(axis=1)
    x = np.asarray(x, np.float32).reshape(-1)
    return x


def _read_wav_any(path: str):
    """WAV reader for the decode surface: PCM int16/24/32, float32/64,
    any channel count (downmixed). io/wav.py's load_wav stays the strict
    mono-16-bit writer-side round-trip."""
    with open(path, "rb") as f:
        riff, _, wave = struct.unpack("<4sI4s", f.read(12))
        if riff != b"RIFF" or wave != b"WAVE":
            raise ValueError("not a RIFF/WAVE file")
        fmt = None
        while True:
            hdr = f.read(8)
            if len(hdr) < 8:
                raise ValueError("no data chunk found")
            tag, size = struct.unpack("<4sI", hdr)
            if tag == b"fmt ":
                raw_fmt = f.read(size + (size & 1))[:size]
                fmt = struct.unpack("<HHIIHH", raw_fmt[:16])
            elif tag == b"data":
                data = f.read(size)
                break
            else:
                f.seek(size + (size & 1), 1)
    if fmt is None:
        raise ValueError("no fmt chunk found")
    audio_format, channels, sample_rate, _, _, bits = fmt
    if audio_format == 0xFFFE:
        # WAVE_FORMAT_EXTENSIBLE: the real format tag is the first two
        # bytes of the SubFormat GUID at fmt offset 24 (guessing from the
        # bit depth would decode extensible 32-bit integer PCM as float)
        if len(raw_fmt) < 26:
            raise ValueError("malformed WAVE_FORMAT_EXTENSIBLE fmt chunk")
        audio_format = struct.unpack("<H", raw_fmt[24:26])[0]
    if audio_format == 3:  # IEEE float
        dt = np.float32 if bits == 32 else np.float64
        x = np.frombuffer(data, dt).astype(np.float32)
    elif audio_format == 1 and bits == 16:
        x = np.frombuffer(data, np.int16).astype(np.float32) / 32768.0
    elif audio_format == 1 and bits == 32:
        x = np.frombuffer(data, np.int32).astype(np.float32) / 2147483648.0
    elif audio_format == 1 and bits == 24:
        raw = np.frombuffer(data, np.uint8).reshape(-1, 3)
        x = (raw[:, 0].astype(np.int32)
             | (raw[:, 1].astype(np.int32) << 8)
             | (raw[:, 2].astype(np.int32) << 16))
        x = (x - ((x & 0x800000) << 1)).astype(np.float32) / 8388608.0
    else:
        raise ValueError(f"unsupported WAV format {audio_format}/{bits}bit")
    if channels > 1:
        x = x[: (x.size // channels) * channels].reshape(-1, channels)
    return _to_mono_f32(x), sample_rate


class _BitReader:
    def __init__(self, data: bytes, pos: int = 0):
        self.data = data
        self.pos = pos          # byte position
        self._acc = 0
        self._nbits = 0

    def read(self, bits: int) -> int:
        while self._nbits < bits:
            self._acc = (self._acc << 8) | self.data[self.pos]
            self.pos += 1
            self._nbits += 8
        self._nbits -= bits
        val = (self._acc >> self._nbits) & ((1 << bits) - 1)
        self._acc &= (1 << self._nbits) - 1
        return val

    def read_signed(self, bits: int) -> int:
        v = self.read(bits)
        return v - (1 << bits) if v & (1 << (bits - 1)) else v

    def align(self):
        self._nbits = 0
        self._acc = 0

    def read_unary(self) -> int:
        n = 0
        while self.read(1) == 0:
            n += 1
        return n

    def read_rice(self, k: int) -> int:
        q = self.read_unary()
        r = self.read(k) if k else 0
        v = (q << k) | r
        return (v >> 1) ^ -(v & 1)        # zigzag


_FIXED_COEFFS = {0: [], 1: [1], 2: [2, -1], 3: [3, -3, 1], 4: [4, -6, 4, -1]}


def _read_flac(path: str):
    """Minimal FLAC decoder: mono/stereo, 16-bit, verbatim / constant /
    fixed subframes with Rice-coded residuals. Covers everything
    io/audio.py's encoder writes plus the fixed-prediction frames most
    simple encoders emit; LPC subframes raise (use ffmpeg for those)."""
    with open(path, "rb") as f:
        blob = f.read()
    if blob[:4] != b"fLaC":
        raise ValueError("not a FLAC file")
    pos, last = 4, False
    sample_rate = bits = channels = None
    while not last:
        last = bool(blob[pos] & 0x80)
        btype = blob[pos] & 0x7F
        size = int.from_bytes(blob[pos + 1:pos + 4], "big")
        if btype == 0:
            si = _BitReader(blob, pos + 4)
            si.read(16), si.read(16), si.read(24), si.read(24)
            sample_rate = si.read(20)
            channels = si.read(3) + 1
            bits = si.read(5) + 1
        pos += 4 + size
    if bits != 16:
        raise ValueError(f"only 16-bit FLAC supported, got {bits}")

    _BS = {1: 192, 6: None, 7: None, 8: 256, 9: 512, 10: 1024, 11: 2048,
           12: 4096, 13: 8192, 14: 16384, 15: 32768}
    out = []
    while pos < len(blob):
        br = _BitReader(blob, pos)
        if br.read(14) != 0b11111111111110:
            raise ValueError("lost FLAC frame sync")
        br.read(1)                      # reserved
        br.read(1)                      # blocking strategy
        bs_code = br.read(4)
        sr_code = br.read(4)
        ch_code = br.read(4)
        br.read(3)                      # sample size: from STREAMINFO
        br.read(1)                      # reserved
        lead = br.read(8)               # UTF-8 coded frame number
        n_more = 0
        while lead & (0x80 >> n_more) and n_more < 7:
            n_more += 1
        for _ in range(max(0, n_more - 1)):
            br.read(8)
        if bs_code == 6:
            blocksize = br.read(8) + 1
        elif bs_code == 7:
            blocksize = br.read(16) + 1
        elif bs_code in (2, 3, 4, 5):
            blocksize = 576 << (bs_code - 2)
        else:
            blocksize = _BS[bs_code]
        if sr_code == 12:
            br.read(8)
        elif sr_code in (13, 14):
            br.read(16)
        br.read(8)                      # header CRC-8
        n_ch = 2 if ch_code >= 8 else ch_code + 1

        chans = []
        for ci in range(n_ch):
            # side channels of L/S, R/S, M/S carry one extra bit
            sb_bits = 16 + (1 if (ch_code == 8 and ci == 1)
                            or (ch_code == 9 and ci == 0)
                            or (ch_code == 10 and ci == 1) else 0)
            br.read(1)                  # zero pad
            sf_type = br.read(6)
            wasted = 0
            if br.read(1):
                wasted = 1 + br.read_unary()
            eff = sb_bits - wasted
            if sf_type == 0:            # CONSTANT
                v = br.read_signed(eff)
                samples = np.full(blocksize, v, np.int64)
            elif sf_type == 1:          # VERBATIM
                samples = np.array([br.read_signed(eff)
                                    for _ in range(blocksize)], np.int64)
            elif 8 <= sf_type <= 12:    # FIXED order 0-4
                order = sf_type - 8
                warm = [br.read_signed(eff) for _ in range(order)]
                res = _read_residual(br, blocksize, order)
                samples = np.empty(blocksize, np.int64)
                samples[:order] = warm
                coef = _FIXED_COEFFS[order]
                for i in range(order, blocksize):
                    pred = sum(c * samples[i - 1 - j]
                               for j, c in enumerate(coef))
                    samples[i] = res[i - order] + pred
            else:
                raise ValueError(
                    "LPC FLAC subframes not supported natively; "
                    "decode with ffmpeg")
            chans.append(samples << wasted)
        br.align()
        br.read(16)                     # frame CRC-16
        pos = br.pos

        if ch_code == 8:                # left/side
            left, side = chans
            chans = [left, left - side]
        elif ch_code == 9:              # right/side
            side, right = chans
            chans = [side + right, right]
        elif ch_code == 10:             # mid/side
            mid, side = chans
            left = mid + ((side + (side & 1)) >> 1)
            chans = [left, left - side]
        frame = np.stack(chans, axis=1).astype(np.float32) / 32768.0
        out.append(frame)
    pcm = np.concatenate(out, axis=0) if out else np.zeros((0, 1), np.float32)
    return _to_mono_f32(pcm), sample_rate


def _read_residual(br: _BitReader, blocksize: int, order: int):
    method = br.read(2)
    if method > 1:
        raise ValueError("invalid FLAC residual method")
    kbits = 4 if method == 0 else 5
    escape = (1 << kbits) - 1
    porder = br.read(4)
    nparts = 1 << porder
    res = []
    for p in range(nparts):
        n = blocksize >> porder
        if p == 0:
            n -= order
        k = br.read(kbits)
        if k == escape:
            raw = br.read(5)
            res += [br.read_signed(raw) if raw else 0 for _ in range(n)]
        else:
            res += [br.read_rice(k) for _ in range(n)]
    return np.array(res, np.int64)


def _decode_via_ffmpeg(path: str, sample_rate: Optional[int]):
    if not ffmpeg_available():
        raise RuntimeError(
            f"decoding {os.path.splitext(path)[1]} requires an `ffmpeg` "
            "binary on PATH (none found). Use .wav or .flac (decoded "
            "natively), or install ffmpeg — the reference links FFmpeg "
            "for the same feature (demos/ffmpeg_helpers.h:50).")
    cmd = ["ffmpeg", "-loglevel", "error", "-i", path,
           "-f", "f32le", "-ac", "1"]
    if sample_rate:
        cmd += ["-ar", str(sample_rate)]
    proc = subprocess.run(cmd + ["-"], capture_output=True)
    if proc.returncode != 0:
        raise RuntimeError(f"ffmpeg failed: {proc.stderr.decode()[-500:]}")
    pcm = np.frombuffer(proc.stdout, np.float32)
    if sample_rate:
        return pcm, sample_rate
    # no target rate: the caller needs the source rate, which only
    # ffprobe reports. A missing/failed ffprobe must be an error here —
    # returning rate 0 poisons any downstream resample (gcd(sr, 0)).
    try:
        prob = subprocess.run(
            ["ffprobe", "-v", "error", "-select_streams", "a:0",
             "-show_entries", "stream=sample_rate", "-of", "csv=p=0",
             path],
            capture_output=True)
        sr = int(prob.stdout.strip() or 0)
    except (FileNotFoundError, ValueError):
        sr = 0
    if sr <= 0:
        raise RuntimeError(
            f"could not determine the sample rate of {path} (ffprobe "
            "missing or no audio stream); pass sample_rate= explicitly")
    return pcm, sr


def load_audio(path: str, sample_rate: Optional[int] = None):
    """Decode any supported audio file -> (float32 mono pcm, rate).

    When `sample_rate` is given the pcm is resampled to it (the
    Decoder->Resampler composition of demos/ffmpeg_helpers.h)."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".wav":
        pcm, sr = _read_wav_any(path)
    elif ext == ".flac":
        pcm, sr = _read_flac(path)
    else:
        return _decode_via_ffmpeg(path, sample_rate)
    if sample_rate and sample_rate != sr:
        pcm, sr = resample(pcm, sr, sample_rate), sample_rate
    return pcm, sr


# ---------------------------------------------------------------------------
# resample
# ---------------------------------------------------------------------------

def _design_polyphase(sr_in: int, sr_out: int, taps_per_phase: int = 24,
                      beta: float = 8.6):
    """Kaiser-windowed-sinc polyphase filter bank for rational L/M
    resampling. Returns (H, L, M) with H of shape (L, taps_per_phase):
    phase p's FIR with tap k multiplying input x[i - k] (newest first).
    Each phase row is normalized to unit sum, so constants resample to
    exactly themselves (no DC ripple from the finite window)."""
    g = np.gcd(sr_in, sr_out)
    L, M = sr_out // g, sr_in // g
    # cutoff at the tighter of the two Nyquists, rolled off so the
    # transition band's aliasing stays below the Kaiser sidelobes
    c = 0.917 / max(L, M)
    # length scales with max(L, M): a downsampler's stopband must cover
    # the OUTPUT Nyquist, which needs taps_per_phase taps per input (not
    # per upsampled) sample when M > L
    k = -(-taps_per_phase * max(L, M) // L)  # ceil -> whole phases
    n = L * k
    t = np.arange(n) - (n - 1) / 2.0
    h = c * np.sinc(c * t) * np.kaiser(n, beta)
    H = h.reshape(k, L).T                     # H[p, k] = h[k*L + p]
    H = H / H.sum(axis=1, keepdims=True)
    return H, L, M


class StreamingResampler:
    """Frame-at-a-time rational resampler (the reference Resampler's
    process/flush semantics, demos/ffmpeg_helpers.h:135-251): feed PCM
    chunks of any size, receive whatever output is ready; flush() drains
    the group-delay tail (zero-padded, like swr's delayed samples).

    Output n sits at input time n*M/L (delay-compensated): its window
    covers inputs [i_n + D - K + 1, i_n + D] with i_n = (n*M)//L and
    D = (K-1)//2, so process() can emit n only once input i_n + D has
    arrived — the last ~D*L/M outputs come from flush()."""

    def __init__(self, sr_in: int, sr_out: int, taps_per_phase: int = 24):
        self.sr_in, self.sr_out = sr_in, sr_out
        if sr_in == sr_out:
            self._H = None
            return
        self._H, self.L, self.M = _design_polyphase(sr_in, sr_out,
                                                    taps_per_phase)
        self.K = self._H.shape[1]
        self.D = (self.K - 1) // 2
        self._carry = np.zeros(self.K - 1, np.float32)
        self._off = -(self.K - 1)         # abs input index of _carry[0]
        self._n_in = 0                    # abs input samples consumed
        self._n_out = 0                   # abs output samples emitted

    def process(self, chunk: np.ndarray) -> np.ndarray:
        chunk = np.asarray(chunk, np.float32).reshape(-1)
        if self._H is None:
            return chunk
        buf = np.concatenate([self._carry, chunk])
        self._n_in += chunk.size
        # emit n while i_n + D <= n_in - 1  <=>  n*M < (n_in - D) * L
        avail = self._n_in - self.D
        n_hi = max(self._n_out,
                   (avail * self.L + self.M - 1) // self.M if avail > 0
                   else 0)
        y = self._compute(buf, self._off, self._n_out, n_hi)
        self._n_out = n_hi
        # keep from the oldest input the NEXT output's window needs
        keep_from = ((self._n_out * self.M) // self.L
                     + self.D - self.K + 1)
        self._carry = buf[keep_from - self._off:]
        self._off = keep_from
        return y

    def flush(self) -> np.ndarray:
        """Drain: zero-pad until every output with real input under its
        window is emitted — ceil(n_in * L / M) outputs in total."""
        if self._H is None:
            return np.zeros(0, np.float32)
        total = (self._n_in * self.L + self.M - 1) // self.M
        buf = np.concatenate([self._carry,
                              np.zeros(self.D + 2, np.float32)])
        y = self._compute(buf, self._off, self._n_out, total)
        self._n_out = total
        return y

    def _compute(self, buf, off, n_lo, n_hi):
        if n_hi <= n_lo:
            return np.zeros(0, np.float32)
        n = np.arange(n_lo, n_hi)
        t = n * self.M
        p = t % self.L
        # window rows, oldest-first: buf[start : start + K] with
        # start = i_n + D - K + 1 (buf-local)
        start = t // self.L + self.D - self.K + 1 - off
        win = np.lib.stride_tricks.sliding_window_view(buf, self.K)
        assert start.min() >= 0 and start.max() < win.shape[0], \
            (start.min(), start.max(), win.shape)
        # H taps are newest-first -> flip to match the oldest-first rows
        return np.einsum("nk,nk->n", win[start],
                         self._H[p, ::-1]).astype(np.float32)


def resample(pcm: np.ndarray, sr_in: int, sr_out: int,
             taps_per_phase: int = 24) -> np.ndarray:
    """One-shot rational polyphase resample, float32 in/out. Output
    length is ceil(len * sr_out / sr_in) after gcd reduction."""
    if sr_in == sr_out:
        return np.asarray(pcm, np.float32).reshape(-1)
    r = StreamingResampler(sr_in, sr_out, taps_per_phase)
    return np.concatenate([r.process(pcm), r.flush()])
