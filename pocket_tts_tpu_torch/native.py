"""PcmFifo: the thread-safe PCM ring of the playback sink.

The port's own copy of the pure-Python path of
`pocket_tts_tpu/native.py`'s `PcmFifo` (the path that runs there when the
native library is not built). Binding the C library
(csrc/pocket_tts_native.cpp) is not ported.
"""
from __future__ import annotations

import collections
import threading

import numpy as np


class PcmFifo:
    """Thread-safe bounded FIFO of float32 PCM samples."""

    def __init__(self, capacity: int):
        self._buf = collections.deque()
        self._cap = capacity
        self._lock = threading.Lock()

    def push(self, data: np.ndarray) -> int:
        """Append as many samples as fit; returns how many were taken."""
        data = np.ascontiguousarray(data, np.float32)
        with self._lock:
            todo = min(self._cap - len(self._buf), data.size)
            self._buf.extend(data[:todo].tolist())
            return todo

    def pop(self, n: int) -> np.ndarray:
        """Remove and return up to n samples (fewer when fewer are held)."""
        with self._lock:
            todo = min(n, len(self._buf))
            return np.asarray([self._buf.popleft() for _ in range(todo)],
                              np.float32)

    def __len__(self):
        with self._lock:
            return len(self._buf)
