"""Build and load the port's CUDA kernels.

Every source under `pocket_tts_tpu_torch/csrc/` compiles with nvcc to an
object file, all at once in parallel processes, and the objects link into
ONE shared library with a plain C interface, loaded with ctypes:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
         -Xcompiler -fPIC -Xptxas=-v -c csrc/<name>.cu -o <name>.o  (each)
    nvcc -gencode arch=compute_90a,code=sm_90a -shared -o \
         _build/libptt_kernels_<hash>.so *.o

The build runs on first use (never at import) into the package's `_build/`
directory, which git ignores, or into the directory `set_build_dir` chose
before the first launch (utils/profiling.enable_compile_cache, CLI
`--compile-cache`). The file name carries a hash of the sources
and flags, so an edited source is rebuilt. Every C entry returns
`cudaGetLastError()` (or the launch call's own error) after its launch;
`check` raises when it is not 0.
"""
from __future__ import annotations

import ctypes
import functools
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
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = [*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
              "-Xptxas=-v"]

P = ctypes.c_void_p
I = ctypes.c_int
F = ctypes.c_float
# C signature of every entry point: name -> argtypes (restype is int)
SIGNATURES = {
    # q, k, v, pos, k_scale, v_scale (int8 caches, else null), out, stats
    # (or null), B, H, D, S, row stride (H*D), end, splits, dtype, stream
    "ptt_decode_attn": [P, P, P, P, P, P, P, P, I, I, I, I, I, I, I, I, P],
    # q, k_new, v_new, cur_pos, k_cache, v_cache, pos, k_scale, v_scale,
    # ks_new, vs_new (int8 caches, else null), out, stats (or null), the
    # write slot on the device (or null), B, H, D, S, read_end, write_slot,
    # splits, dtype, stream
    "ptt_insert_attn": [P, P, P, P, P, P, P, P, P, P, P, P, P, P, I, I, I, I,
                        I, I, I, I, P],
    # q, k_new, v_new, k_cache, v_cache, out, starts (or null), ks_new,
    # vs_new, k_scale, v_scale (int8 rings, else null), the offset on the
    # device (or null), B, T, H, D, cap, offset, start, context, splits,
    # dtype, stream
    "ptt_ring_attn": [P, P, P, P, P, P, P, P, P, P, P, P, I, I, I, I, I, I,
                      I, I, I, I, P],
    # pointer array (8), dims array (15), dtype, stream: one conv-GEMM of
    # K3's frame (csrc/seanet_frame.cu)
    "ptt_seanet_gemm": [P, P, I, P],
    # u, carry, bias, y, ye, B, rows of u a lane, s, C, dtype, stream: a
    # transposed conv's overlap-add
    "ptt_seanet_overlap": [P, P, P, P, P, I, I, I, I, I, P],
    # h, carry, w, bias, out, B, T, C, K, P(carry rows), blocks a lane,
    # dtype, stream: K3's final one-channel conv
    "ptt_seanet_last": [P, P, P, P, P, I, I, I, I, I, I, I, P],
    # x (bf16), q (int8), scale, y, T, K, N, the plan array (10:
    # quant_matmul.WGMMA_PLAN_KEYS), marks (or null), stream: K4a on the
    # warpgroup products (csrc/wgmma_matmul.cu)
    "ptt_wgmma_int8": [P, P, P, P, I, I, I, P, P, P],
    # bt, splits, shared memory -> clusters of `splits` blocks the card
    # holds at once (quant_matmul.wgmma_fits)
    "ptt_wgmma_max_clusters": [I, I, I],
    # a, norm scale, norm bias, w, scale, bias, res, ls, out, T, K, N, kind,
    # group, prologue, epilogue, approx, eps, dtype, stream
    "ptt_fused_rows": [P, P, P, P, P, P, P, P, P, I, I, I, I, I, I, I, I, F,
                       I, P],
    # ptt_fused_rows' operands without the dtype (bf16 only), then the
    # plan: rows a block, reduction slices, k-tiles a slice; stream
    "ptt_rows_mma": [P, P, P, P, P, P, P, P, P, I, I, I, I, I, I, I, I, F,
                     I, I, I, P],
    # ptt_fused_rows' operands without the dtype (bf16 only), then the
    # plan array (7: fused_layer.SKINNY_PLAN_KEYS), stream
    "ptt_rows_skinny": [P, P, P, P, P, P, P, P, P, I, I, I, I, I, I, I, I,
                        F, P, P],
    # shared memory (bytes), kernel (0: K5b, 1: K5c, 2: K8), dtype ->
    # blocks the card holds at once
    "ptt_coop_max_blocks": [I, I, I],
    # pointer array (18), (kind, group) array (6), plan array (9:
    # fused_layer.PLAN_KEYS), T, dm, H, eps, approx, marks (or null), dtype,
    # stream
    "ptt_fused_post": [P, P, P, I, I, I, F, I, P, I, P],
    # K5b's pointer array (18; [17] = x_next out) and (kind, group) array
    # (6), layer l+1's pointer array (7: norm1 scale, norm1 bias, in_proj
    # w, scale, bias, x_next scratch, qkv out) and (kind, group) array (2),
    # plan array (9), dm, H, N, eps, approx, marks (or null), dtype, stream
    "ptt_bilayer": [P, P, P, P, P, I, I, I, F, I, P, I, P],
    # pointer array (30), weight kinds (4), plan array (11:
    # fused_step.MEGA_PLAN_KEYS), dm, H (hidden), D, S, read_end,
    # write_slot, eps, approx, marks (or null), dtype, stream
    "ptt_megalayer": [P, P, P, I, I, I, I, I, I, F, I, P, I, P],
    # pointer array (10), W2's (kind, group), plan array (6: mode, grid,
    # ks, fin_e, shared memory, o_act), dm, H, dtype, stream: the two
    # cross-block sums of the MLP's down projection side by side
    # (csrc/coop_bench.cu; timed by chip_smoke.py --kernel-times)
    "ptt_finish_bench": [P, P, P, I, I, I, P],
    # barriers, grid blocks, kind (0 grid.sync, 1 with clusters of 2, 2
    # hand-written), the hand-written barrier's 2 zeroed words, stream: a
    # cooperative launch of barriers (csrc/coop_bench.cu)
    "ptt_barrier_bench": [I, I, I, P, P],
    # cluster size, chain and modulation dynamic shared memory, tensor
    # cores (0/1), solo (0/1), dtype -> clusters the card holds at once
    "ptt_flow_max_clusters": [I, I, I, I, I, I],
    # pointer array (30), dims, (kind, group) and plan array (25), dtype,
    # stream
    "ptt_fused_flow": [P, P, I, P],
}

_state = {"lib": None, "build_seconds": None, "path": None, "log": "",
          "build_dir": BUILD_DIR}


def set_build_dir(path: str) -> None:
    """Build (and look for) the library in `path` instead of BUILD_DIR.
    Raises when the library is loaded already from another directory: the
    directory must be chosen before the first launch."""
    path = os.path.abspath(path)
    if _state["lib"] is not None and path != _state["build_dir"]:
        raise RuntimeError(
            f"the kernel library is loaded already from "
            f"{_state['build_dir']}; choose the build directory before the "
            "first launch")
    _state["build_dir"] = path


def build_dir() -> str:
    """The directory the library is built into."""
    return _state["build_dir"]


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


def _run(cmd):
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError("nvcc failed:\n" + " ".join(cmd) + "\n"
                           + res.stdout + res.stderr)
    return res.stdout + res.stderr


def _build(path: str) -> str:
    """Compile every source in parallel, link them into `path`; returns
    nvcc's output (the ptxas reports)."""
    nvcc = _nvcc()
    tmp_dir = f"{path}.{os.getpid()}.d"
    os.makedirs(tmp_dir, exist_ok=True)
    jobs = []
    for src in sources():
        obj = os.path.join(tmp_dir, os.path.basename(src) + ".o")
        cmd = [nvcc, *NVCC_FLAGS, "-I", CSRC, "-c", src, "-o", obj]
        jobs.append((cmd, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    log, failed = [], []
    for cmd, _, proc in jobs:
        out, _ = proc.communicate()
        log.append(out)
        if proc.returncode != 0:
            failed.append(" ".join(cmd) + "\n" + out)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    tmp = f"{path}.{os.getpid()}.tmp"
    log.append(_run([nvcc, *ARCH, "-shared", "-o", tmp,
                     *(obj for _, obj, _ in jobs)]))
    os.replace(tmp, path)
    shutil.rmtree(tmp_dir, ignore_errors=True)
    return "".join(log)


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if its sources changed."""
    if _state["lib"] is not None:
        return _state["lib"]
    path = os.path.join(_state["build_dir"],
                        f"libptt_kernels_{_digest()}.so")
    t0 = time.perf_counter()
    if not os.path.exists(path):
        _state["log"] = _build(path)
    lib = ctypes.CDLL(path)
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = I
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


# ---------------------------------------------------------------------------
# the hand-written kernels' Python entries, and the frame's CUDA graphs
# ---------------------------------------------------------------------------

_entry_hook = None


def entry(fn):
    """Mark `fn` as a hand-written kernel's Python entry. While a lane frame
    is captured into CUDA graphs (models/frame_graph.py sets the hook), a
    call goes to the capture, which ends the graph segment before it,
    launches the kernel eagerly and calls the entry again, through its
    module attribute, at this point of every replay; otherwise the call
    runs as it is. Every entry takes `out=`: the result of an earlier call
    with the same operands' shapes, written again in place and returned."""
    @functools.wraps(fn)
    def call(*args, **kwargs):
        hook = _entry_hook
        if hook is None:
            return fn(*args, **kwargs)
        return hook(fn, args, kwargs)
    return call


def set_entry_hook(hook):
    """Install the capture's hook (None: none); returns the one before."""
    global _entry_hook
    prev, _entry_hook = _entry_hook, hook
    return prev


def into(out, res):
    """The plain versions' `out=`: res (a tensor or a tuple of tensors)
    copied into out, which is returned; res itself when out is None."""
    if out is None:
        return res
    if isinstance(out, tuple):
        for o, r in zip(out, res):
            o.copy_(r)
    else:
        out.copy_(res)
    return out


def cursor_value(x):
    """A cursor's value for the glue and the plain versions: the device
    tensor of a `models.frame_graph.Cursor`, or x itself (a host int)."""
    return getattr(x, "dev", x)


def cursor_ptr(x):
    """The device address of a cursor's int32, or None for a host int (the
    kernels then take the int)."""
    dev = getattr(x, "dev", None)
    return None if dev is None else dev.data_ptr()
