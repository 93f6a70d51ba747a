"""K5a, K5b and K5c: a transformer layer's quantized linears fused around
attention.

Replaces the TPU kernels `pocket_tts_tpu/ops/fused_layer.py:_pre_call`
(K5a: norm1 + in_proj), `_post_call` (K5b: out_proj + residual + norm2
+ MLP + residual) and `_bilayer_call` (K5c: K5b of layer l and K5a of
layer l + 1 in one launch, solo int4 decode), for int8 and for int4
weights with per-channel or K-grouped (q4_0) scales (io/quant.py). The
CUDA kernels are in `csrc/fused_layer.cu` (its header says what bounds
them on the H100 and what the design does about it). The plain versions
here round where the kernels round, which is not where the unfused chain
of `linear` calls rounds:

  K5a  qkv = round(round(LN(x)) @ W_in + b_in)
  K5b  x1  = x + ls1 * (attn @ W_o + b_o)             kept in float32
       ln  = round(LN(x1))
       h   = round(gelu(ln @ W_1 + b_1))             computed in float32
       out = round(x1 + ls2 * (h @ W_2 + b_2))
  K5c  x_next = x1 + ls2 * (h @ W_2 + b_2)             kept in float32
       out    = round(x_next)
       qkv    = round(round(LN1_{l+1}(x_next)) @ W_in_{l+1} + b_in_{l+1})

where "v @ W" is the float32 product with the weight's scales
(quant_matmul.deq_dot: per-channel scales on the product, grouped scales
on the weight). Absent biases read as zeros, absent layer scales as ones.
The backbone calls them at T = 1 with eps 1e-5, the mimi decoder
transformer at T = 16 with eps = cfg.norm_eps (0) and its two layer
scales; with lanes (continuous batching) x is (B, T, dm) and the B * T rows
go through one call, as the JAX package's vmap rules collapse the lanes
into rows (`fused_layer.py:928-980`).

Many rows. The wrappers take any row count; on the card every row goes
through the hand-written kernels (the JAX package composes the same math
in XLA above 256 rows). K5a is ONE launch per call: its grid has a row-block
axis (row blocks of at most 16384 activations: 16 rows at dm 1024, 32 at
dm 512), and the row blocks of a weight tile hit L2. K5b is one
cooperative launch up to one such row block (the solo shapes); above it
(the lanes of a batch) its shared memory and cross-block partials would
grow with the rows, so it runs as THREE ordinary launches of K5a's
row-block kernel with x1 and h in HBM between them: out_proj + residual,
LN + linear1 + GELU, linear2 + residual. Launches per call
(`post_launches`): 1 at the solo shapes, 3 at 32 backbone rows (32 lanes)
and at 64 / 256 / 512 mimi rows (4 / 16 / 32 lanes x 16).

The route of a row-block product (`rows_route`): a bf16 call of at least
MMA_ROWS rows runs `rows_mma_kernel` (csrc/fused_layer.cu, on the tensor
cores through csrc/qmma.cuh: `mma.sync` bf16 with float32 accumulators,
the reduction split over a thread-block cluster by `rows_plan`); a float32
call, and a bf16 call of fewer rows, runs `rows_kernel` (SIMT, tile_dot).
That is K5a over every call of MMA_ROWS rows or more (the mimi decoder's
T = 16 frame solo, every lane call) and each of K5b's three launches over
many rows. The route depends on dtype and row count only. The tensor-core
kernel takes int8 and int4 weights (per-channel or in groups of a
multiple of 32 rows) whose stored rows (K, or K / 2 for int4) are a
multiple of 32, K (under a LayerNorm) a multiple of 128 up to 1024, and
N a multiple of 16; a call on that route with other widths raises.

K5c takes LN1 of layer l + 1 from the unrounded float32 x_next, as the
TPU kernel does (`fused_layer.py:628-635`), so it equals K5b followed by
K5a in float32 and differs from them by bf16 rounding. It takes T = 1 and
int4 weights in either scale layout (`bilayer_supported`, the JAX
package's gate); the next layer's weights are its own layer view of the
stacked arrays, as K5a reads them.

`pre_attention`, `post_attention` and `bilayer_post_pre` run the plain
version for tensors on the CPU and the kernel for tensors on the card;
there is no other switch. Launches with a lane axis (x of rank 3) count in
`.launches_lanes`; without one, with int8 weights in `.launches`, with int4
weights (either scale layout) in `.launches_int4`; K5c's launches count in
`bilayer_post_pre.launches_bilayer`. Launches of `rows_mma_kernel` count
once more in `_rows_call.launches_mma`.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import cuda_lib
from .basic import gelu, layer_norm
from .quant_matmul import (INT4, INT4_GROUPED, bits, deq_dot,
                           kernel_operands)

_LINEARS = ("in_proj", "out_proj", "linear1", "linear2")


def supported(p) -> bool:
    """The JAX package's `fused_layer.supported`: the four linears are all
    int8 or all int4 (either scale layout); plain weights take the unfused
    route, as do layers with cross-attention or RMSNorm ("alpha") norms."""
    if "cross_attention" in p:
        return False
    if "alpha" in p.get("norm1", {}) or "alpha" in p.get("norm2", {}):
        return False
    kinds = {bits(p[k]) for k in _LINEARS}
    return len(kinds) == 1 and kinds <= {4, 8}


def _deq(x, lin):
    """float32 x @ W + b: the kernels' dot with its epilogue."""
    y = deq_dot(x, lin)
    b = lin.get("b")
    return y if b is None else y + b.float()


def pre_attention_plain(p, x, eps: float = 1e-5):
    """x (T, dm) -> (T, 3 dm) in x's dtype."""
    ln = layer_norm(p["norm1"], x, eps=eps)      # float32, rounded to x's
    return _deq(ln, p["in_proj"]).to(x.dtype)


def _post_f32(p, x, attn, eps: float, approx: bool):
    """K5b's output before its final rounding: float32 x1 + ls2 * up."""
    ls1 = p.get("layer_scale_1", {}).get("scale")
    ls2 = p.get("layer_scale_2", {}).get("scale")
    proj = _deq(attn, p["out_proj"])
    x1 = x.float() + (proj if ls1 is None else ls1.float() * proj)
    ln = layer_norm(p["norm2"], x1, eps=eps).to(x.dtype)
    h = gelu(_deq(ln, p["linear1"]), approx).to(x.dtype)
    up = _deq(h, p["linear2"])
    return x1 + (up if ls2 is None else ls2.float() * up)


def post_attention_plain(p, x, attn, eps: float = 1e-5,
                         approx: bool = False):
    """x, attn (T, dm) -> (T, dm) in x's dtype."""
    return _post_f32(p, x, attn, eps, approx).to(x.dtype)


def bilayer_supported(p, p_next) -> bool:
    """The JAX package's `fused_layer.bilayer_supported`: every linear of
    layer l and layer l + 1's in_proj are int4 (either scale layout)."""
    return ({bits(p[k]) for k in _LINEARS} == {4}
            and bits(p_next["in_proj"]) == 4)


def bilayer_post_pre_plain(p, p_next, x, attn, eps: float = 1e-5,
                           approx: bool = False):
    """x, attn (1, dm) -> (x_next (1, dm), qkv_next (1, 3 dm)) in x's
    dtype: post_attention(p) then pre_attention(p_next), with layer l +
    1's norm1 taken from the float32 x_next."""
    xn = _post_f32(p, x, attn, eps, approx)
    ln = layer_norm(p_next["norm1"], xn, eps=eps).to(x.dtype)
    return xn.to(x.dtype), _deq(ln, p_next["in_proj"]).to(x.dtype)


def _ptr(t):
    return 0 if t is None else t.data_ptr()


def _check(name, p, x, vecs):
    """Checks of a CUDA call: supported(p), x, and the optional working-
    type vectors with their lengths."""
    ok = (supported(p) and x.is_contiguous()
          and x.dtype in (torch.float32, torch.bfloat16))
    for v, n in vecs:
        ok = ok and (v is None or (v.shape == (n,) and v.dtype == x.dtype
                                   and v.is_contiguous()
                                   and v.device == x.device))
    if not ok:
        raise ValueError(f"{name}: bad operands x{tuple(x.shape)} {x.dtype}"
                         f" or layer layouts {[bits(p[k]) for k in _LINEARS]}")


# activations one K5a row block or one cooperative K5b launch holds
# (csrc/fused_layer.cu FL_ROW_FLOATS)
ROW_FLOATS = 16384
# rows_kernel's prologues and epilogues (csrc/fused_layer.cu)
ROWS_LOAD, ROWS_LN, ROWS_LN_F32 = range(3)
EPI_ROUND, EPI_RESID_F32, EPI_GELU, EPI_RESID = range(4)


# rows_mma_kernel (csrc/fused_layer.cu): bf16 calls of at least MMA_ROWS
# rows take it (R_min: chip_smoke.py `time_rows_plans` times both kernels
# at 1, 16 and 32 rows; PERF.md section 6). Its tile: 64 output columns
# and k-tiles of 32 stored weight rows; its plan (`rows_plan`) fills up to
# MMA_WAVE blocks, splitting the reduction over at most MMA_MAX_SPLITS
# blocks of a cluster (the sweep found clusters of 7 and 8 slower than 6:
# fewer of them fit on the card at once), each at least MMA_MIN_KTILES
# k-tiles, and holds a block's A columns within MMA_A_BYTES of shared
# memory.
MMA_ROWS = 16
MMA_BN, MMA_BKS, MMA_MAX_SPLITS = 64, 32, 6
MMA_BMS = (16, 32, 64)
MMA_WAVE = 132
MMA_MIN_KTILES = 1
MMA_A_BYTES = 144 * 1024
MMA_STAGES = 8
MMA_LN_ROWS, MMA_LN_BUFS = 8, 2
SMEM_MAX = 232448     # shared memory a block can use on the H100


def rows_route(dtype, rows: int) -> str:
    """"mma" (rows_mma_kernel, the tensor cores) for bf16 calls of at
    least MMA_ROWS rows, else "simt" (rows_kernel)."""
    return "mma" if dtype == torch.bfloat16 and rows >= MMA_ROWS else "simt"


def rows_mma_smem(bm: int, kt_per: int, packed: bool, k: int = 0,
                  ln_size: int = 0) -> int:
    """Shared memory of a rows_mma_kernel block (csrc/fused_layer.cu
    `rows_mma_smem`): the A columns of its slice in bf16, the k-tile ring
    (rows padded to 80 bytes), the float32 output tile and, for the LayerNorm
    prologues, MMA_LN_BUFS chunks of MMA_LN_ROWS whole rows of k values of
    ln_size bytes."""
    lda = kt_per * MMA_BKS * (2 if packed else 1) + 8
    return (2 * bm * lda + MMA_STAGES * MMA_BKS * (MMA_BN + 16)
            + 4 * bm * (MMA_BN + 4)
            + MMA_LN_BUFS * MMA_LN_ROWS * k * ln_size)


def rows_plan(rows: int, k: int, n: int, packed: bool, ln_size: int = 0):
    """(bm, splits, k-tiles a slice) of one rows_mma_kernel call over
    `rows` rows of a (k, n) linear: bm the fewest of 16, 32, 64 rows that
    hold the call (64 above 32 rows); the reduction's k-tiles (32 stored
    rows: k for int8, k / 2 for packed int4) split over as many blocks as
    keep the grid within MMA_WAVE (one block an SM: a second wave, or a
    second block on some SMs, doubles the call), each slice at least
    MMA_MIN_KTILES k-tiles and its A columns (32 a k-tile for int8, 64
    for int4) within MMA_A_BYTES and what the block's shared memory
    leaves (ln_size: the bytes of a value of a LayerNorm prologue's rows,
    0 without one); no slice empty."""
    stored = k // 2 if packed else k
    kt = stored // MMA_BKS
    bm = next(b for b in MMA_BMS if rows <= b or b == MMA_BMS[-1])
    tiles = -(-rows // bm) * -(-n // MMA_BN)
    room = min(MMA_A_BYTES,
               SMEM_MAX - rows_mma_smem(bm, 0, packed, k, ln_size))
    cap = room // (bm * MMA_BKS * (2 if packed else 1) * 2)
    splits = max(1, min(MMA_MAX_SPLITS, kt // MMA_MIN_KTILES,
                        MMA_WAVE // tiles))
    splits = max(splits, -(-kt // max(cap, 1)))
    per = -(-kt // splits)
    splits = -(-kt // per)
    if splits > MMA_MAX_SPLITS or cap < 1:
        raise ValueError(f"rows_plan: K={k} too deep for one cluster")
    return bm, splits, per


def _mma_check(name, k, n, kind, group, ln):
    """The widths rows_mma_kernel takes (raises ValueError otherwise)."""
    stored = k // 2 if kind in (INT4, INT4_GROUPED) else k
    if (k % 32 or stored % MMA_BKS or n % 16
            or (ln and (k > 1024 or k % 128))
            or (kind == INT4_GROUPED and group % 32)):
        raise ValueError(f"{name}: the tensor-core route takes K a multiple "
                         f"of 32 with stored rows (K, or K / 2 for int4) a "
                         f"multiple of {MMA_BKS}, K a multiple of 128 and at "
                         f"most 1024 under a LayerNorm, N a multiple of 16 "
                         f"and q4_0 groups of 32k rows, not K={k} N={n} "
                         f"group={group}")


def _rows_call(lib, dtype, a, norm, lin, layout, res, ls, out, rows, k, n,
               pro, epi, approx, eps, stream):
    """One row-block product, out (rows, n) = epilogue(prologue(a) @ lin),
    on its route (`rows_route`): rows_mma_kernel with `rows_plan`, or
    rows_kernel."""
    (w, s, b), (kind, group) = lin, layout
    args = (a.data_ptr(), _ptr(norm[0]), _ptr(norm[1]), w.data_ptr(),
            _ptr(s), _ptr(b), _ptr(res), _ptr(ls), out.data_ptr(), rows, k,
            n, kind, group, pro, epi, int(approx), float(eps))
    if rows_route(dtype, rows) == "mma":
        _mma_check("rows_mma", k, n, kind, group, pro != ROWS_LOAD)
        plan = rows_plan(rows, k, n, kind in (INT4, INT4_GROUPED),
                         {ROWS_LN: 2, ROWS_LN_F32: 4}.get(pro, 0))
        cuda_lib.check(lib.ptt_rows_mma(*args, *plan, stream),
                       f"ptt_rows_mma (rows {rows}, K {k}, N {n}, kind {kind},"
                       f" group {group}, prologue {pro}, epilogue {epi}, "
                       f"plan {plan})")
        _rows_call.launches_mma += 1
    else:
        cuda_lib.check(lib.ptt_fused_rows(*args, int(dtype == torch.bfloat16),
                                          stream), "ptt_fused_rows")


def post_launches(rows: int, dm: int) -> int:
    """K5b launches per call of `rows` rows of width dm: one cooperative
    launch up to a row block, three row-block launches above."""
    return 1 if rows <= max(1, ROW_FLOATS // dm) else 3


def _count(fn, p, x):
    if x.dim() == 3:
        fn.launches_lanes += 1
    elif bits(p["in_proj"]) == 4:
        fn.launches_int4 += 1
    else:
        fn.launches += 1


@functools.lru_cache(maxsize=None)
def _post_grid(t: int, dm: int, hid: int, code: int,
               bilayer: bool = False) -> int:
    """K5b's (K5c's) cooperative grid: one block per 32-unit hidden tile
    (32 W2 rows of int8, 16 packed rows of int4), at most as many as the
    card holds at once (0 when the query fails)."""
    return min(-(-hid // 32), cuda_lib.library().ptt_fused_post_max_blocks(
        t, dm, int(bilayer), code))


def _post_operands(name, p, x, attn):
    """K5b's checked operands: [ls1, ls2, norm2 scale, norm2 bias, then
    (w, scale, bias) of out_proj, linear1, linear2] and their (kind,
    group) pairs."""
    dm = x.shape[-1]
    n2 = p["norm2"]
    ls1 = p.get("layer_scale_1", {}).get("scale")
    ls2 = p.get("layer_scale_2", {}).get("scale")
    _check(name, p, x.reshape(-1, dm),
           [(ls1, dm), (ls2, dm), (n2.get("scale"), dm),
            (n2.get("bias"), dm)])
    hid = p["linear1"]["scale"].shape[-1]
    vecs, ints = [ls1, ls2, n2.get("scale"), n2.get("bias")], []
    for lin, k, n in (("out_proj", dm, dm), ("linear1", dm, hid),
                      ("linear2", hid, dm)):
        tensors, layout = kernel_operands(p[lin], k, n, x)
        vecs += tensors
        ints += layout
    if not (attn.shape == x.shape and attn.dtype == x.dtype
            and attn.is_contiguous() and attn.device == x.device):
        raise ValueError(f"{name}: bad attn{tuple(attn.shape)} for "
                         f"x{tuple(x.shape)}")
    return vecs, ints


def pre_attention(p, x, eps: float = 1e-5):
    """Same contract as pre_attention_plain (x (..., dm)); launches K5a
    once for CUDA tensors (x float32 or bfloat16, supported(p))."""
    if x.device.type == "cpu":
        return pre_attention_plain(p, x, eps)
    if x.device.type != "cuda":
        raise ValueError(f"pre_attention: unsupported device {x.device}")
    dm = x.shape[-1]
    x2 = x.reshape(-1, dm)
    t = x2.shape[0]
    norm = p["norm1"]
    _check("pre_attention", p, x2,
           [(norm.get("scale"), dm), (norm.get("bias"), dm)])
    n = p["in_proj"]["scale"].shape[-1]
    lin, layout = kernel_operands(p["in_proj"], dm, n, x)
    out = torch.empty(t, n, dtype=x.dtype, device=x.device)
    _rows_call(cuda_lib.library(), x.dtype, x2,
               (norm.get("scale"), norm.get("bias")), lin, layout, None, None,
               out, t, dm, n, ROWS_LN, EPI_ROUND, False, eps,
               cuda_lib.stream_ptr(x.device))
    _count(pre_attention, p, x)
    return out.reshape(*x.shape[:-1], n)


def post_attention(p, x, attn, eps: float = 1e-5, approx: bool = False):
    """Same contract as post_attention_plain (x, attn (..., dm)); launches
    K5b for CUDA tensors (cooperative launches, `post_launches` per call;
    x, attn float32 or bfloat16, supported(p))."""
    if x.device.type == "cpu":
        return post_attention_plain(p, x, attn, eps, approx)
    if x.device.type != "cuda":
        raise ValueError(f"post_attention: unsupported device {x.device}")
    dm = x.shape[-1]
    x2, a2 = x.reshape(-1, dm), attn.reshape(-1, dm)
    rows = x2.shape[0]
    vecs, ints = _post_operands("post_attention", p, x, attn)
    hid = p["linear1"]["scale"].shape[-1]
    code = cuda_lib.dtype_code(x)
    lib, stream = cuda_lib.library(), cuda_lib.stream_ptr(x.device)
    x1 = torch.empty(rows, dm, dtype=torch.float32, device=x.device)
    out = torch.empty_like(x2)
    if post_launches(rows, dm) == 1:
        grid = _post_grid(rows, dm, hid, code)
        part = torch.empty(grid, rows, dm, dtype=torch.float32,
                           device=x.device)
        ptrs = [x2, a2] + vecs + [x1, part, out]
        rc = lib.ptt_fused_post(
            (ctypes.c_void_p * len(ptrs))(*[_ptr(v) for v in ptrs]),
            (ctypes.c_int * len(ints))(*ints), rows, dm, hid, float(eps),
            int(approx), grid, code, stream)
        cuda_lib.check(rc, "ptt_fused_post")
        _count(post_attention, p, x)
        return out.reshape(x.shape)
    ls1, ls2, ns, nb, *lins = vecs
    h = torch.empty(rows, hid, dtype=x.dtype, device=x.device)
    # (A, norm, linear, residual, layer scale, out, K, N, prologue, epilogue)
    steps = ((a2, (None, None), 0, x2, ls1, x1, dm, dm, ROWS_LOAD,
              EPI_RESID_F32),
             (x1, (ns, nb), 1, None, None, h, dm, hid, ROWS_LN_F32, EPI_GELU),
             (h, (None, None), 2, x1, ls2, out, hid, dm, ROWS_LOAD,
              EPI_RESID))
    for a, norm, i, res, ls, dst, k, n, pro, epi in steps:
        _rows_call(lib, x.dtype, a, norm, lins[3 * i:3 * i + 3],
                   ints[2 * i:2 * i + 2], res, ls, dst, rows, k, n, pro, epi,
                   approx, eps, stream)
        _count(post_attention, p, x)
    return out.reshape(x.shape)


def bilayer_post_pre(p, p_next, x, attn, eps: float = 1e-5,
                     approx: bool = False):
    """Same contract as bilayer_post_pre_plain; launches K5c once for CUDA
    tensors (x, attn (1, dm) float32 or bfloat16, bilayer_supported and
    supported(p); one cooperative launch)."""
    if x.device.type == "cpu":
        return bilayer_post_pre_plain(p, p_next, x, attn, eps, approx)
    if x.device.type != "cuda":
        raise ValueError(f"bilayer_post_pre: unsupported device {x.device}")
    dm = x.shape[-1]
    if not (x.shape == (1, dm) and bilayer_supported(p, p_next)):
        raise ValueError(f"bilayer_post_pre: takes one row and int4 layers, "
                         f"not x{tuple(x.shape)} with layouts "
                         f"{[bits(p[k]) for k in _LINEARS]} + "
                         f"{bits(p_next['in_proj'])}")
    vecs, ints = _post_operands("bilayer_post_pre", p, x, attn)
    hid = p["linear1"]["scale"].shape[-1]
    n = p_next["in_proj"]["scale"].shape[-1]
    norm = p_next["norm1"]
    _check("bilayer_post_pre", p, x,
           [(norm.get("scale"), dm), (norm.get("bias"), dm)])
    (w, s, b), qints = kernel_operands(p_next["in_proj"], dm, n, x)
    code = cuda_lib.dtype_code(x)
    grid = _post_grid(1, dm, hid, code, True)
    x1 = torch.empty(1, dm, dtype=torch.float32, device=x.device)
    xn32 = torch.empty(dm, dtype=torch.float32, device=x.device)
    part = torch.empty(grid, 1, dm, dtype=torch.float32, device=x.device)
    out = torch.empty_like(x)
    qkv = torch.empty(1, n, dtype=x.dtype, device=x.device)
    ptrs = [x, attn] + vecs + [x1, part, out]
    nptrs = [norm.get("scale"), norm.get("bias"), w, s, b, xn32, qkv]
    rc = cuda_lib.library().ptt_bilayer(
        (ctypes.c_void_p * len(ptrs))(*[_ptr(v) for v in ptrs]),
        (ctypes.c_int * len(ints))(*ints),
        (ctypes.c_void_p * len(nptrs))(*[_ptr(v) for v in nptrs]),
        (ctypes.c_int * 2)(*qints), dm, hid, n, float(eps), int(approx),
        grid, code, cuda_lib.stream_ptr(x.device))
    cuda_lib.check(rc, "ptt_bilayer")
    bilayer_post_pre.launches_bilayer += 1
    return out, qkv


bilayer_post_pre.launches_bilayer = 0
# rows_mma_kernel launches (K5a and K5b calls on the tensor-core route),
# counted besides the wrappers' own counts
_rows_call.launches_mma = 0
pre_attention.launches = pre_attention.launches_int4 = 0
post_attention.launches = post_attention.launches_int4 = 0
pre_attention.launches_lanes = post_attention.launches_lanes = 0
