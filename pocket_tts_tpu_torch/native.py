"""The native runtime library: build at first use, and ctypes bindings.

The port's own copy of the C++ source lives in `csrc/native/
pocket_tts_native.cpp` (the JAX package's `csrc/pocket_tts_native.cpp`,
with a splitter that walks UTF-8 code points). `library()` compiles it
with the host compiler at first use (never at import), with the flags of
the JAX package's `csrc/Makefile`,

    g++ -O2 -fPIC -std=c++17 -Wall -fvisibility=hidden -shared \
        -o _build/libptt_native_<hash>.so pocket_tts_native.cpp -lpthread

after writing `unicode_tables.h` beside the object: the code points this
Python's `str.isspace`, `str.isalnum` and `str.upper` treat specially, so
the native splitter equals `text.preprocess.StrProcessor` on any text.
The name's hash covers the source, the flags and the Python's Unicode
version. The build holds a file lock in the build directory and renames
its output into place, so concurrent processes (test workers) build it
once. A failed build raises RuntimeError with the compiler's output;
nothing here falls back to Python.

Bindings, as `pocket_tts_tpu/native.py` binds them:
  load_safetensors_native(path)  mmap reader; BF16 tensors read as raw
                                 16-bit words, widened to float32 exactly
                                 (as io/safetensors_io.load_safetensors)
  NativeStrProcessor             the streaming sentence splitter
  make_str_processor()           the splitter the engine's Stream uses
  wav_write_native(path, pcm, sr)
  PcmFifo                        the thread-safe PCM ring (runtime/player)
`PcmFifoPlain` is the FIFO's pure-Python version, and `text.preprocess.
StrProcessor` the splitter's: the tests hold the library against them.
"""
from __future__ import annotations

import collections
import ctypes
import fcntl
import hashlib
import os
import subprocess
import sys
import threading
import unicodedata
from typing import Dict

import numpy as np

_PKG = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_PKG, "csrc", "native", "pocket_tts_native.cpp")
BUILD_DIR = os.path.join(_PKG, "_build")
CXXFLAGS = ["-O2", "-fPIC", "-std=c++17", "-Wall", "-fvisibility=hidden"]

_state = {"lib": None, "path": None}


def _unicode_tables() -> str:
    """C tables of this Python's Unicode rules for the splitter: kSpace
    and kAlnum as sorted inclusive code-point ranges, kUpper the code
    points whose str.upper() differs, with the UTF-8 of the result."""
    spaces, alnum, upper = [], [], []
    for cp in range(0x110000):
        if 0xD800 <= cp <= 0xDFFF:
            continue
        ch = chr(cp)
        for flag, ranges in ((ch.isspace(), spaces), (ch.isalnum(), alnum)):
            if flag:
                if ranges and ranges[-1][1] == cp - 1:
                    ranges[-1][1] = cp
                else:
                    ranges.append([cp, cp])
        up = ch.upper()
        if up != ch:
            upper.append((cp, "".join(f"\\{b:03o}" for b in
                                      up.encode("utf-8"))))

    def ranges_c(name, ranges):
        body = ",".join(f"{{{a}u,{b}u}}" for a, b in ranges)
        return f"static const uint32_t {name}[{len(ranges)}][2] = {{{body}}};"

    rows = ",\n".join(f'{{{cp}u, "{s}"}}' for cp, s in upper)
    return ("// generated by pocket_tts_tpu_torch/native.py from Python "
            f"{sys.version.split()[0]}, Unicode {unicodedata.unidata_version}"
            "\n#pragma once\n#include <cstdint>\n"
            + ranges_c("kSpace", spaces) + "\n"
            + ranges_c("kAlnum", alnum) + "\n"
            "struct UpperEntry { uint32_t cp; const char* utf8; };\n"
            f"static const UpperEntry kUpper[{len(upper)}] = {{\n{rows}}};\n")


def _digest() -> str:
    h = hashlib.sha256(" ".join(CXXFLAGS).encode())
    h.update(unicodedata.unidata_version.encode())
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    return h.hexdigest()[:16]


def build(build_dir: str = None) -> str:
    """Build the library into build_dir (default: the package's `_build/`)
    unless it is there already; returns its path. Raises RuntimeError
    with the compiler's output when the build fails."""
    build_dir = os.path.abspath(build_dir or BUILD_DIR)
    os.makedirs(build_dir, exist_ok=True)
    path = os.path.join(build_dir, f"libptt_native_{_digest()}.so")
    if os.path.exists(path):
        return path
    with open(os.path.join(build_dir, "native.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if os.path.exists(path):
                return path
            tmp_dir = f"{path}.{os.getpid()}.d"
            os.makedirs(tmp_dir, exist_ok=True)
            with open(os.path.join(tmp_dir, "unicode_tables.h"), "w") as f:
                f.write(_unicode_tables())
            tmp = os.path.join(tmp_dir, "lib.so")
            cmd = ["g++", *CXXFLAGS, "-I", tmp_dir, "-shared", "-o", tmp,
                   SOURCE, "-lpthread"]
            try:
                res = subprocess.run(cmd, capture_output=True, text=True)
            except OSError as e:
                raise RuntimeError(f"native library: cannot run the host "
                                   f"compiler ({' '.join(cmd)}): {e}")
            if res.returncode != 0:
                raise RuntimeError("native library: the build failed:\n"
                                   + " ".join(cmd) + "\n" + res.stdout
                                   + res.stderr)
            os.replace(tmp, path)
            for name in os.listdir(tmp_dir):
                os.remove(os.path.join(tmp_dir, name))
            os.rmdir(tmp_dir)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    return path


def library() -> ctypes.CDLL:
    """The loaded library, built first when its source changed."""
    if _state["lib"] is not None:
        return _state["lib"]
    path = build()
    lib = ctypes.CDLL(path)
    c = ctypes
    P, I64 = c.c_void_p, c.c_int64
    fp = c.POINTER(c.c_float)
    sigs = {
        "st_open": (P, [c.c_char_p]), "st_close": (None, [P]),
        "st_num_tensors": (I64, [P]), "st_name": (c.c_char_p, [P, I64]),
        "st_dtype": (c.c_char_p, [P, I64]), "st_ndim": (I64, [P, I64]),
        "st_shape": (None, [P, I64, c.POINTER(I64)]),
        "st_data": (P, [P, I64, c.POINTER(I64)]),
        "sp_new": (P, []), "sp_free": (None, [P]), "sp_reset": (None, [P]),
        "sp_ingest": (None, [P, c.c_char_p, I64]), "sp_flush": (None, [P]),
        "sp_count": (I64, [P]), "sp_front_size": (I64, [P]),
        "sp_pop": (I64, [P, c.c_char_p, I64]),
        "wav_write": (c.c_int, [c.c_char_p, fp, I64, c.c_int]),
        "fifo_new": (P, [I64]), "fifo_free": (None, [P]),
        "fifo_push": (I64, [P, fp, I64]), "fifo_pop": (I64, [P, fp, I64]),
        "fifo_size": (I64, [P]),
    }
    for name, (res, args) in sigs.items():
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = res, args
    _state.update(lib=lib, path=path)
    return lib


_ST_DTYPES = {"F32": np.float32, "F16": np.float16, "F64": np.float64,
              "I64": np.int64, "I32": np.int32, "I16": np.int16,
              "I8": np.int8, "U8": np.uint8, "BOOL": np.bool_}


def load_safetensors_native(path: str) -> Dict[str, np.ndarray]:
    """name -> np.ndarray through the native mmap reader (copies; the
    file is closed on return). BF16 tensors come as float32 holding the
    same values, as `io.safetensors_io.load_safetensors` gives them."""
    from .io.safetensors_io import bf16_words_to_f32
    lib = library()
    h = lib.st_open(path.encode())
    if not h:
        raise IOError(f"failed to open safetensors file: {path}")
    try:
        out = {}
        for i in range(lib.st_num_tensors(h)):
            name = lib.st_name(h, i).decode()
            dt = lib.st_dtype(h, i).decode()
            ndim = lib.st_ndim(h, i)
            shape = (ctypes.c_int64 * max(ndim, 1))()
            lib.st_shape(h, i, shape)
            nbytes = ctypes.c_int64()
            ptr = lib.st_data(h, i, ctypes.byref(nbytes))
            if ptr is None and nbytes.value:
                raise IOError(f"bad tensor data: {name}")
            buf = ctypes.string_at(ptr, nbytes.value) if nbytes.value else b""
            dims = [shape[d] for d in range(ndim)]
            if dt == "BF16":
                arr = bf16_words_to_f32(np.frombuffer(buf, np.uint16))
            else:
                arr = np.frombuffer(buf, np.dtype(_ST_DTYPES[dt])).copy()
            out[name] = arr.reshape(dims)
        return out
    finally:
        lib.st_close(h)


class NativeStrProcessor:
    """text.preprocess.StrProcessor on the native splitter: the same
    ingest / flush / reset and the `sentences` deque the engine's Stream
    pops from (each access drains the native queue into it)."""

    def __init__(self):
        self._lib = library()
        self._h = self._lib.sp_new()
        self._out = collections.deque()

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.sp_free(self._h)
            self._h = None

    def reset(self):
        self._out.clear()
        self._lib.sp_reset(self._h)

    def ingest(self, chunk: str):
        data = chunk.encode("utf-8")
        self._lib.sp_ingest(self._h, data, len(data))

    def flush(self):
        self._lib.sp_flush(self._h)

    @property
    def sentences(self):
        """Deque of complete sentences."""
        while True:
            n = self._lib.sp_front_size(self._h)
            if n < 0:
                return self._out
            buf = ctypes.create_string_buffer(n + 1)
            if self._lib.sp_pop(self._h, buf, n + 1) != n:
                raise RuntimeError("native splitter: sp_pop failed")
            self._out.append(buf.raw[:n].decode("utf-8"))


def make_str_processor():
    """The streaming sentence splitter: the native one (built on first
    use; a failed build raises)."""
    return NativeStrProcessor()


def wav_write_native(path: str, samples: np.ndarray, sample_rate: int):
    """16-bit mono WAV, the bytes io/wav.save_wav writes for float32 pcm."""
    samples = np.ascontiguousarray(samples, np.float32)
    rc = library().wav_write(
        path.encode(), samples.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        samples.size, sample_rate)
    if rc != 0:
        raise IOError(f"wav_write failed: {path}")


class PcmFifo:
    """Thread-safe bounded FIFO of float32 PCM samples (native)."""

    def __init__(self, capacity: int):
        self._lib = library()
        self._h = self._lib.fifo_new(capacity)

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.fifo_free(self._h)
            self._h = None

    def push(self, data: np.ndarray) -> int:
        """Append as many samples as fit; returns how many were taken."""
        data = np.ascontiguousarray(data, np.float32)
        return int(self._lib.fifo_push(
            self._h, data.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            data.size))

    def pop(self, n: int) -> np.ndarray:
        """Remove and return up to n samples (fewer when fewer are held)."""
        out = np.empty(max(n, 0), np.float32)
        got = self._lib.fifo_pop(
            self._h, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            out.size)
        return out[:got]

    def __len__(self):
        return int(self._lib.fifo_size(self._h))


class PcmFifoPlain:
    """PcmFifo's pure-Python version (the JAX package's path without the
    library)."""

    def __init__(self, capacity: int):
        self._buf = collections.deque()
        self._cap = capacity
        self._lock = threading.Lock()

    def push(self, data: np.ndarray) -> int:
        data = np.ascontiguousarray(data, np.float32)
        with self._lock:
            todo = min(self._cap - len(self._buf), data.size)
            self._buf.extend(data[:todo].tolist())
            return todo

    def pop(self, n: int) -> np.ndarray:
        with self._lock:
            todo = min(n, len(self._buf))
            return np.asarray([self._buf.popleft() for _ in range(todo)],
                              np.float32)

    def __len__(self):
        with self._lock:
            return len(self._buf)
