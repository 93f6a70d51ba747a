"""Build and load the port's CUDA kernels.

All sources under `pocket_tts_tpu_torch/csrc/` compile with nvcc into ONE
shared library with a plain C interface, loaded with ctypes:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o _build/libptt_kernels_<hash>.so csrc/*.cu

The build runs on first use (never at import) into the package's `_build/`
directory, which git ignores. The file name carries a hash of the sources
and flags, so an edited source is rebuilt. Every C entry returns
`cudaGetLastError()` after its launch; `check` raises when it is not 0.
"""
from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import time

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v"]

P = ctypes.c_void_p
I = ctypes.c_int
# C signature of every entry point: name -> argtypes (restype is int)
SIGNATURES = {
    # q, k, v, pos, out, H, D, S, row stride (H*D), end, dtype, stream
    "ptt_decode_attn": [P, P, P, P, P, I, I, I, I, I, I, P],
    # q, k_new, v_new, k_cache, v_cache, out, T, H, D, cap, offset, start,
    # context, dtype, stream
    "ptt_ring_attn": [P, P, P, P, P, P, I, I, I, I, I, I, I, I, P],
    # x, carry, w, bias, res, out, ws, T, Cin, Cout, K, P(carry rows),
    # splits, in_elu, out_elu, res_elu, dtype, stream
    "ptt_conv_gemm": [P, P, P, P, P, P, P, I, I, I, I, I, I, I, I, I, I, P],
    # u, carry, bias, out, T, s, Cout, dtype, stream
    "ptt_convtr_overlap": [P, P, P, P, I, I, I, I, P],
    # x, carry, T, C, P(carry rows), elu, dtype, stream
    "ptt_carry_tail": [P, P, I, I, I, I, I, P],
}

_state = {"lib": None, "build_seconds": None, "path": None, "log": ""}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (CUDA_HOME/bin/nvcc)")


def sources():
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(glob.glob(os.path.join(CSRC, "*.cu*"))):
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if its sources changed."""
    if _state["lib"] is not None:
        return _state["lib"]
    path = os.path.join(BUILD_DIR, f"libptt_kernels_{_digest()}.so")
    t0 = time.perf_counter()
    if not os.path.exists(path):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{path}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, "-I", CSRC, "-o", tmp, *sources()]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError("nvcc failed:\n" + " ".join(cmd) + "\n"
                               + res.stdout + res.stderr)
        os.replace(tmp, path)
        _state["log"] = res.stdout + res.stderr
    lib = ctypes.CDLL(path)
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    _state.update(lib=lib, path=path,
                  build_seconds=time.perf_counter() - t0)
    return lib


def build_seconds():
    """Seconds the last `library()` call spent building and loading."""
    return _state["build_seconds"]


def build_log() -> str:
    """nvcc's output of the last build (with -Xptxas=-v: each kernel's
    registers, shared memory and spills); empty when nothing was built."""
    return _state["log"]


def check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {rc}")


def dtype_code(t) -> int:
    """0 for float32, 1 for bfloat16; the kernels take nothing else."""
    if t.dtype == torch.float32:
        return 0
    if t.dtype == torch.bfloat16:
        return 1
    raise TypeError(f"CUDA kernels take float32 or bfloat16, not {t.dtype}")


def stream_ptr(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream
