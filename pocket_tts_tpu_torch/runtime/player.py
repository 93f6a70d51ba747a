"""Realtime playback sink: a PCM FIFO + writer thread.

The port's own copy of `pocket_tts_tpu/runtime/player.py`: the analog of
the reference's SDL playback helper (a mutex/cond FIFO of audio frames
drained by the audio callback, 3-frame ring — demos/sdl_helper.h,
demos/pocket-tts.cpp:444). Generation pushes frames into a bounded
PcmFifo (native.py: the native library's ring, built on first use); a
writer thread drains it into an audio player subprocess (aplay / pw-play
/ ffplay, whichever exists) or any writable binary file object. The bounded FIFO gives the same backpressure
semantics as the SDL ring: `play` blocks while the buffer is full.
"""
from __future__ import annotations

import shutil
import subprocess
import threading
import time
from typing import Optional

import numpy as np

from ..native import PcmFifo


def _player_cmd(sample_rate: int):
    if shutil.which("aplay"):
        return ["aplay", "-q", "-f", "S16_LE", "-r", str(sample_rate),
                "-c", "1", "-t", "raw", "-"]
    if shutil.which("pw-play"):
        return ["pw-play", "--format", "s16", "--rate", str(sample_rate),
                "--channels", "1", "-"]
    if shutil.which("ffplay"):
        return ["ffplay", "-autoexit", "-nodisp", "-loglevel", "error",
                "-f", "s16le", "-ar", str(sample_rate), "-ac", "1", "-"]
    return None


def playback_available() -> bool:
    return _player_cmd(24000) is not None


class AudioPlayer:
    """Push-based playback with a bounded frame FIFO.

    sink: a writable binary file object; None = spawn an audio player
    subprocess (RuntimeError if no player binary exists on PATH).
    """

    def __init__(self, sample_rate: int, sink=None,
                 capacity_frames: int = 3, frame_size: int = 1920):
        self.sample_rate = sample_rate
        self.frame_size = frame_size
        self.fifo = PcmFifo(capacity_frames * frame_size)
        self._proc: Optional[subprocess.Popen] = None
        if sink is None:
            cmd = _player_cmd(sample_rate)
            if cmd is None:
                raise RuntimeError(
                    "no audio player found on PATH (tried aplay, pw-play, "
                    "ffplay); pass a sink file object or write a file "
                    "with -o instead.")
            self._proc = subprocess.Popen(cmd, stdin=subprocess.PIPE,
                                          stderr=subprocess.DEVNULL)
            self._sink = self._proc.stdin
        else:
            self._sink = sink
        self._closing = False
        self._thread = threading.Thread(target=self._drain, daemon=True)
        self._thread.start()

    def _drain(self):
        while True:
            chunk = self.fifo.pop(self.frame_size)
            if chunk.size == 0:
                if self._closing:
                    return
                time.sleep(0.002)
                continue
            pcm16 = np.clip(chunk * 32767.0, -32768, 32767).astype(np.int16)
            try:
                self._sink.write(pcm16.tobytes())
            except (BrokenPipeError, ValueError):
                return

    def play(self, pcm: np.ndarray):
        """Queue one frame; blocks while the ring is full (backpressure,
        like the reference's 3-frame SDL ring)."""
        data = np.ascontiguousarray(pcm, np.float32).reshape(-1)
        off = 0
        while off < data.size:
            pushed = self.fifo.push(data[off:])
            off += pushed
            if pushed == 0:
                time.sleep(0.002)

    def close(self, drain: bool = True):
        if drain:
            while len(self.fifo) > 0:
                time.sleep(0.002)
        self._closing = True
        self._thread.join(timeout=5)
        if self._proc is not None:
            self._proc.stdin.close()
            self._proc.wait()
        else:
            try:
                self._sink.flush()
            except (AttributeError, ValueError):
                pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
