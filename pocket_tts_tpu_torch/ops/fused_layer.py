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

The route of a row-block product (`rows_route`), K5a's and each of K5b's
three launches over many rows (and K4b's, and K4a's below its
WGMMA_ROWS, ops/quant_matmul.py): a bf16
call of at least MMA_ROWS rows runs `rows_mma_kernel` (csrc/fused_layer.cu,
on the tensor cores through csrc/qmma.cuh: `mma.sync` bf16 with float32
accumulators, the reduction split over a thread-block cluster by
`rows_plan`); a bf16 call of fewer rows runs `skinny_kernel` (the
backbone's T = 1: a block per 32-column tile and slice of the stored rows,
its whole weight slab asked of the TMA at entry, the slices of a tile
summed over a cluster; `skinny_plan`); a float32 call runs `rows_kernel`
(SIMT, tile_dot). The route depends on dtype and row count only. The
tensor-core kernel takes int8 and int4 weights (per-channel or in groups
of a multiple of 32 rows) whose stored rows (K, or K / 2 for int4) are a
multiple of 16, K (under a LayerNorm) a multiple of 128 up to 1024, and N
a multiple of 16; the skinny kernel the widths `skinny_plan` states. A
call on either route with other widths raises; it never takes another
kernel.

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
`bilayer_post_pre.launches_bilayer`. K5a's and K5b's launches of
`rows_mma_kernel` count once more in `_rows_call.launches_mma`, of
`skinny_kernel` in `_rows_call.launches_skinny` (K4b's and K4a's launches
count in `quant_matmul.int4_matmul.launches` / `int8_matmul.launches`
only).
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
# rows take it (R_min: chip_smoke.py `time_rows_plans` times the three
# row-block kernels at 1, 8, 15, 16 and 32 rows; PERF.md section 6). Its
# tile: 64 output columns and k-tiles of 32 stored weight rows; its plan
# (`rows_plan`) fills up to
# MMA_WAVE blocks, splitting the reduction over at most MMA_MAX_SPLITS
# blocks of a cluster (the sweep found clusters of 7 and 8 slower than 6:
# fewer of them fit on the card at once), each at least MMA_MIN_KTILES
# k-tiles, and holds a block's A columns within MMA_A_BYTES of shared
# memory.
MMA_ROWS = 16
MMA_BN, MMA_BKS, MMA_MAX_SPLITS = 64, 32, 6
MMA_BMS = (16, 32, 64)
MMA_WAVE = 132
MMA_BIG_CLUSTER = 3
MMA_MIN_KTILES = 1
MMA_A_BYTES = 144 * 1024
MMA_STAGES = 8
MMA_LN_ROWS, MMA_LN_BUFS = 8, 2
SMEM_MAX = 232448     # shared memory a block can use on the H100


def rows_route(dtype, rows: int) -> str:
    """"mma" (rows_mma_kernel, the tensor cores) for bf16 calls of at
    least MMA_ROWS rows, "skinny" (skinny_kernel) for bf16 calls of fewer,
    "simt" (rows_kernel) for float32."""
    if dtype != torch.bfloat16:
        return "simt"
    return "mma" if rows >= MMA_ROWS else "skinny"


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
    rows: k for int8, k / 2 for packed int4; a last one of 16 where the
    stored rows are an odd multiple of 16) split over as many blocks as
    keep the grid within MMA_WAVE (one block an SM: a second wave, or a
    second block on some SMs, doubles the call), each slice at least
    MMA_MIN_KTILES k-tiles and its A columns (32 a k-tile for int8, 64
    for int4) within MMA_A_BYTES and what the block's shared memory
    leaves (ln_size: the bytes of a value of a LayerNorm prologue's rows,
    0 without one); no slice empty. A bm of 64 whose blocks hold more
    than half an SM's shared memory (one block an SM) in clusters of more
    than MMA_BIG_CLUSTER takes bm 32 instead: such clusters do not fill
    the card in one wave (chip_smoke.py `time_rows_plans`, K4b's linear2
    at 128 rows: (64, 4) 33.8 us, (32, 2) 23.8 us; PERF.md section 6)."""
    stored = k // 2 if packed else k
    kt = -(-stored // MMA_BKS)      # the last k-tile may hold 16 rows
    bm = next(b for b in MMA_BMS if rows <= b or b == MMA_BMS[-1])
    plan = _rows_plan(rows, k, n, packed, ln_size, bm, kt)
    if (bm == 64 and plan[1] > MMA_BIG_CLUSTER and rows_mma_smem(
            64, plan[2], packed, k, ln_size) > SMEM_MAX // 2):
        plan = _rows_plan(rows, k, n, packed, ln_size, 32, kt)
    return plan


def _rows_plan(rows, k, n, packed, ln_size, bm, kt):
    """rows_plan at tile height bm over kt k-tiles."""
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
    if (k % 16 or stored % 16 or n % 16
            or (ln and (k > 1024 or k % 128))
            or (kind == INT4_GROUPED and group % 32)):
        raise ValueError(f"{name}: the tensor-core route takes stored rows "
                         f"(K, or K / 2 for int4) a multiple of 16, K a "
                         f"multiple of 128 and at most 1024 under a "
                         f"LayerNorm, N a multiple of 16 and q4_0 groups of "
                         f"32k rows, not K={k} N={n} group={group}")


# skinny_kernel (csrc/fused_layer.cu): bf16 calls below MMA_ROWS rows. A
# block takes one unit of a column tile of COOP_TILE stored columns and a
# slice of its stored rows; the ks slices of a tile are the blocks of one
# cluster (SKINNY_KS: at most 8, the portable size). `skinny_plan` takes
# the fewest slices that keep a block's weight slab within SKINNY_SLAB
# bytes: chip_smoke.py `time_rows_plans` found one slice (96 blocks of
# 32 KB of int8, no cluster) faster than 2, 4 or 8 for the backbone's
# in_proj at T = 1 (PERF.md section 6). A slice is the whole of the stored
# rows or a multiple of 32 of them (and of q4_0's group); above TMA_ROWS
# rows (the TMA's largest box) a multiple of TMA_ROWS.
SKINNY_KS = (1, 2, 4, 8)
SKINNY_SLAB = 32 * 1024
TMA_ROWS = 256
SKINNY_PLAN_KEYS = ("ks", "smem", "o_w", "o_x", "o_lnv", "o_red", "o_out")


def skinny_slices(stored: int, kind, group: int = 0):
    """The slice counts of SKINNY_KS a weight of `stored` rows takes."""
    out = []
    for ks in SKINNY_KS:
        srows = stored // ks
        if (stored % ks or (ks > 1 and srows % 32)
                or (kind == INT4_GROUPED and srows % group)
                or (srows > TMA_ROWS and srows % TMA_ROWS)):
            continue
        out.append(ks)
    return out


@functools.lru_cache(maxsize=None)
def skinny_plan(rows: int, k: int, n: int, kind, group: int = 0,
                ln: bool = False, ks: int = 0) -> dict:
    """One skinny_kernel call over `rows` rows of a (k, n) linear (ln: a
    LayerNorm prologue, whose rows the block holds whole): ks (the
    fewest of `skinny_slices` whose slab of stored rows x COOP_TILE bytes
    is within SKINNY_SLAB, else the most; ks > 0 takes that count, for the
    sweep), grid, srows and the block's shared
    memory: the unit's weights (col_unit_bytes), the rows as float32
    (whole rows under a LayerNorm, else the slice's columns: srows, and
    for int4 the high half's srows more), the LayerNorm's scale and bias
    (2 k floats), the cross-warp sums (COOP_RED_FLOATS), the unit's
    partial (rows x COOP_TILE floats); offsets SKINNY_PLAN_KEYS. Raises
    ValueError on widths the kernel does not take: N a multiple of
    COOP_TILE, a slice count in `skinny_slices`, under a LayerNorm K a
    multiple of 4 up to 4096, all within the block's shared memory."""
    stored = k // 2 if _packed(kind) else k
    valid = skinny_slices(stored, kind, group)
    ntiles = n // COOP_TILE
    if ks == 0 and valid:
        ks = next((q for q in valid
                   if stored // q * COOP_TILE <= SKINNY_SLAB), valid[-1])
    if (n % COOP_TILE or ntiles < 1 or ks not in valid
            or (ln and (k % 4 or k > 4096))):
        raise ValueError(f"skinny_plan: the skinny route takes N a multiple "
                         f"of {COOP_TILE}, slices of the stored rows in "
                         f"{SKINNY_KS} (whole, or multiples of 32 rows and "
                         f"of q4_0's group; above {TMA_ROWS} rows multiples "
                         f"of {TMA_ROWS}) and K a multiple of 4 up to 4096 "
                         f"under a LayerNorm, not rows={rows} K={k} N={n} "
                         f"group={group} ks={ks or valid}")
    srows = stored // ks
    o_x = align128(col_unit_bytes(kind, k, ks, group))
    o_lnv = align128(o_x + 4 * rows * (k if ln else
                                       srows * (2 if _packed(kind) else 1)))
    o_red = align128(o_lnv + (8 * k if ln else 0))
    o_out = align128(o_red + 4 * COOP_RED_FLOATS)
    smem = o_out + 4 * rows * COOP_TILE + SMEM_SLACK
    if smem > SMEM_MAX:
        raise ValueError(f"skinny_plan: rows={rows} K={k} N={n} need {smem} "
                         f"bytes of shared memory (at most {SMEM_MAX})")
    return dict(ks=ks, grid=ntiles * ks, srows=srows, smem=smem, o_w=0,
                o_x=o_x, o_lnv=o_lnv, o_red=o_red, o_out=o_out)


def rows_launch(lib, dtype, a, norm, lin, layout, res, ls, out, rows, k, n,
                pro, epi, approx, eps, stream) -> str:
    """One row-block product, out (rows, n) = epilogue(prologue(a) @ lin),
    launched once on its route (`rows_route`): rows_mma_kernel with
    `rows_plan`, skinny_kernel with `skinny_plan`, or rows_kernel. Returns
    the route; counts nothing."""
    (w, s, b), (kind, group) = lin, layout
    args = (a.data_ptr(), _ptr(norm[0]), _ptr(norm[1]), w.data_ptr(),
            _ptr(s), _ptr(b), _ptr(res), _ptr(ls), out.data_ptr(), rows, k,
            n, kind, group, pro, epi, int(approx), float(eps))
    route = rows_route(dtype, rows)
    what = (f"(rows {rows}, K {k}, N {n}, kind {kind}, group {group}, "
            f"prologue {pro}, epilogue {epi}")
    if route == "mma":
        _mma_check("rows_mma", k, n, kind, group, pro != ROWS_LOAD)
        plan = rows_plan(rows, k, n, _packed(kind),
                         {ROWS_LN: 2, ROWS_LN_F32: 4}.get(pro, 0))
        cuda_lib.check(lib.ptt_rows_mma(*args, *plan, stream),
                       f"ptt_rows_mma {what}, plan {plan})")
    elif route == "skinny":
        plan = skinny_plan(rows, k, n, kind, group, pro != ROWS_LOAD)
        _aligned16("rows_skinny", [w, s if kind == INT4_GROUPED else None])
        if pro != ROWS_LOAD and a.data_ptr() % (16 if pro == ROWS_LN_F32
                                                else 8):
            raise ValueError("rows_skinny: the LayerNorm prologue reads "
                             "rows 8-byte (bf16) or 16-byte (float32) "
                             "aligned")
        cuda_lib.check(lib.ptt_rows_skinny(
            *args, _plan_ints(plan, SKINNY_PLAN_KEYS), stream),
            f"ptt_rows_skinny {what}, plan {plan})")
    else:
        cuda_lib.check(lib.ptt_fused_rows(*args, int(dtype == torch.bfloat16),
                                          stream), "ptt_fused_rows")
    return route


def _rows_call(lib, dtype, a, norm, lin, layout, res, ls, out, rows, k, n,
               pro, epi, approx, eps, stream):
    """K5a's or one of K5b's row-block products (`rows_launch`), counted
    by route in `launches_mma` / `launches_skinny`."""
    route = rows_launch(lib, dtype, a, norm, lin, layout, res, ls, out, rows,
                        k, n, pro, epi, approx, eps, stream)
    if route == "mma":
        _rows_call.launches_mma += 1
    elif route == "skinny":
        _rows_call.launches_skinny += 1


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


# ------------------------------------------------ the cooperative plan ---
# K5b, K5c and K8 (csrc/layer_post.cuh) are one cooperative launch each. A
# block owns fixed pieces of every weight matrix, known before the launch:
#   column-tile phases (out_proj; K8's and K5c's in_proj): tiles of
#     COOP_TILE columns (32 bytes a stored row), each cut into `ks` slices
#     of its stored rows; unit u = (tile u // ks, slice u % ks) goes to
#     block u % grid, its raw sum to the slice's float32 partial
#   MLP tiles: COOP_TILE hidden units, tile t to block t % grid (int8: W1
#     columns 32t.. and W2 rows 32t..; int4: W1 columns 16t.. and H/2 +
#     16t.., W2 packed rows 16t..), the tile's partial of `up` per block
# and copies all of it into shared memory at kernel entry (thread 0 asks the
# TMA for 2-D boxes and 1-D runs, one mbarrier a phase; q4_0's scale rows
# by cp.async, a commit group a phase). `post_plan` /
# `fused_step.mega_plan` are the one source of the layout: the grid, the
# slices, the cross-block sum's vector width, each region's offset in
# shared memory (PLAN_KEYS / fused_step.MEGA_PLAN_KEYS, the order the
# kernels take them in) and the total; the kernels only check that each
# region holds what they put there, 128-byte aligned, within the total.
COOP_TILE = 32
COOP_MAX_GRID = 132          # one block an SM of the H100
COOP_KSPLITS = (1, 2, 4, 8)
COOP_RED_FLOATS = 8 * 8 * 32  # a column-tile product's cross-warp sums
COOP_MARKS = 24              # globaltimer marks a block (`marks=`)
SMEM_SLACK = 128             # to align the dynamic shared memory to 128
POST_MARKS = ("entry", "issued", "staged", "W_o landed", "out_proj",
              "sync 1", "x1", "ln", "W1 landed", "h", "W2 landed", "mlp",
              "sync 2", "finish")
BILAYER_MARKS = POST_MARKS + ("sync 3", "next ln", "next landed",
                              "next in_proj")


PLAN_KEYS = ("grid", "ks_o", "fin_e", "smem", "o_wo", "o_w1", "o_w2",
             "o_nx", "o_act")


def _packed(kind) -> bool:
    return kind in (INT4, INT4_GROUPED)


def col_split(ntiles: int, stored: int, grid: int, group: int = 0) -> int:
    """k-slices of a column-tile phase of `ntiles` tiles over `stored`
    stored rows on `grid` blocks: of COOP_KSPLITS whose slices are whole
    multiples of 32 stored rows (and of q4_0's group), the fewest that
    make the busiest block's rows fewest."""
    step = max(32, group)
    best = None
    for ks in COOP_KSPLITS:
        if stored % (ks * step):
            continue
        cost = -(-ntiles * ks // grid) * (stored // ks)
        if best is None or cost < best[0]:
            best = (cost, ks)
    if best is None:
        raise ValueError(f"col_split: {stored} stored rows are not a "
                         f"multiple of {step}")
    return best[1]


def col_units(ntiles: int, ks: int, grid: int, b: int):
    """Block b's units of a column-tile phase: [(tile, slice)]."""
    return [(u // ks, u % ks) for u in range(b, ntiles * ks, grid)]


def col_unit_bytes(kind, k: int, ks: int, group: int) -> int:
    """Shared memory of one column unit of a (k, N) linear: its slice's
    stored rows of 32 bytes, then (q4_0) the slice's scale rows of the low
    and the high half, 32 bfloat16 each."""
    srows = (k // 2 if _packed(kind) else k) // ks
    return srows * 32 + (2 * (srows // group) * 64
                         if kind == INT4_GROUPED else 0)


def mlp_tile_bytes(kind, dm: int, group: int):
    """(W1 bytes, W2 bytes) of one MLP tile in shared memory: W1's 32
    columns over the stored rows (then q4_0's dm / group scale rows of 32
    bfloat16); W2's 32 int8 rows or 16 packed rows of dm bytes (then q4_0's
    two scale rows of dm bfloat16)."""
    p, g = _packed(kind), kind == INT4_GROUPED
    return ((dm // 2 if p else dm) * 32 + (dm // group * 64 if g else 0),
            (16 if p else 32) * dm + (4 * dm if g else 0))


def finish_vec(t: int, dm: int, grid: int) -> int:
    """float4 vectors a warp's lanes cover in the cross-block sum of the
    MLP partials (1, 2, 4 or 8; the other lane bits walk the grid's
    partials): as many as leave every warp of the grid a chunk."""
    ne4, e = t * dm // 4, 1
    while e < 8 and ne4 // (2 * e) >= grid * 8:
        e *= 2
    return e


def align128(n: int) -> int:
    """n bytes rounded up to 128: where the next region of shared memory
    may start (the TMA writes to 128-byte aligned addresses)."""
    return -(-n // 128) * 128


def tail_layout(dm: int, hid: int, kind, group: int, grid: int, ks_o: int,
                o_wo: int) -> dict:
    """Offsets (bytes) of the layer tail's weights in a block's shared
    memory from o_wo on: its out_proj units, MLP W1 tiles, MLP W2 tiles;
    `end` past them."""
    nb_o = -(-(dm // COOP_TILE) * ks_o // grid)
    nb_h = -(-(hid // COOP_TILE) // grid)
    w1b, w2b = mlp_tile_bytes(kind, dm, group)
    o_w1 = align128(o_wo + nb_o * col_unit_bytes(kind, dm, ks_o, group))
    o_w2 = align128(o_w1 + nb_h * w1b)
    return dict(o_wo=o_wo, o_w1=o_w1, o_w2=o_w2,
                end=align128(o_w2 + nb_h * w2b))


def act_bytes(t: int, dm: int) -> int:
    """A block's activations: T x dm floats (attention rows, then the
    LayerNorm), T x 32 (an h tile), T x 32 (a column unit's sums), the
    cross-warp sums, a LayerNorm's scale and bias (2 x dm floats); above
    one row also the tensor cores' bf16 copies of the rows and of the h
    tile in row blocks of 16, padded by 8."""
    mp = -(-t // 16) * 16
    return (4 * (t * dm + 2 * t * COOP_TILE + COOP_RED_FLOATS + 2 * dm)
            + (2 * mp * (dm + 8 + COOP_TILE + 8) if t > 1 else 0))


@functools.lru_cache(maxsize=None)
def post_plan(t: int, dm: int, hid: int, kind, group: int = 0,
              n_next: int = 0) -> dict:
    """K5b's (n_next = 0) or K5c's (n_next: layer l + 1's in_proj width)
    plan for T rows: grid (one block an MLP tile, at most COOP_MAX_GRID),
    out_proj slices ks_o, the finish's vector width fin_e, shared-memory
    offsets and the total `smem` in bytes. Cached: a call's plan is read,
    never changed."""
    if dm % COOP_TILE or hid % COOP_TILE or n_next % COOP_TILE:
        raise ValueError(f"post_plan: d_model {dm}, hidden {hid} and "
                         f"{n_next} must be multiples of {COOP_TILE}")
    grid = min(COOP_MAX_GRID, hid // COOP_TILE)
    stored = dm // 2 if _packed(kind) else dm
    # above one row (the tensor cores' products) whole tiles: x1 is then
    # one partial, which every block reads T x dm of
    ks_o = col_split(dm // COOP_TILE, stored, grid, group) if t == 1 else 1
    lay = tail_layout(dm, hid, kind, group, grid, ks_o, 0)
    o_nx = lay["end"]
    nb_n = -(-(n_next // COOP_TILE) // grid)
    o_act = align128(o_nx + nb_n * col_unit_bytes(kind, dm, 1, group))
    return dict(grid=grid, ks_o=ks_o, fin_e=finish_vec(t, dm, grid),
                o_wo=0, o_w1=lay["o_w1"], o_w2=lay["o_w2"], o_nx=o_nx,
                o_act=o_act, smem=o_act + act_bytes(t, dm) + SMEM_SLACK)


@functools.lru_cache(maxsize=None)
def _max_blocks(smem: int, which: int, code: int) -> int:
    """Blocks of K5b (which 0), K5c (1) or K8 (2) the card holds at once
    at `smem` bytes of shared memory (0 when the query fails). Cached per
    process, which drives one card (parallel/launch.py: one a rank)."""
    return cuda_lib.library().ptt_coop_max_blocks(smem, which, code)


def _plan_ints(plan: dict, keys):
    """The plan's values in the order the kernel's entry point reads them."""
    return (ctypes.c_int * len(keys))(*[plan[k] for k in keys])


def coop_check(name: str, plan: dict, which: int, code: int) -> None:
    """Raise unless the plan's grid fits on the card at once."""
    if plan["smem"] > SMEM_MAX or plan["grid"] > _max_blocks(
            plan["smem"], which, code):
        raise ValueError(f"{name}: plan {plan} does not fit on the card")


def _marks(name, marks, grid, device):
    """The marks tensor's pointer (0 for none) after checking it: int64
    (rows, COOP_MARKS) on the device, rows >= grid (COOP_MAX_GRID rows
    always do); block b writes %globaltimer (ns) at each of its kernel's
    mark points into row b, and rows past the grid stay as they were."""
    if marks is None:
        return 0
    if not (marks.dtype == torch.int64 and marks.dim() == 2
            and marks.shape[0] >= grid and marks.shape[1] == COOP_MARKS
            and marks.is_contiguous() and marks.device == device):
        raise ValueError(f"{name}: marks must be int64 (>= {grid}, "
                         f"{COOP_MARKS}) on {device}")
    return marks.data_ptr()


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


def _layout(ints):
    """The one (kind, group) of the fused linears' (kind, group) pairs;
    raises when they differ."""
    pairs = set(zip(ints[::2], ints[1::2]))
    if len(pairs) != 1:
        raise ValueError(f"the cooperative kernels take one weight layout "
                         f"for all linears, not {sorted(pairs)}")
    return pairs.pop()


def _aligned16(name, tensors):
    """The cooperative kernels copy weights 16 bytes at a time."""
    if any(t is not None and t.data_ptr() % 16 for t in tensors):
        raise ValueError(f"{name}: weights must be 16-byte aligned")


def post_attention(p, x, attn, eps: float = 1e-5, approx: bool = False,
                   marks=None):
    """Same contract as post_attention_plain (x, attn (..., dm)); launches
    K5b for CUDA tensors (cooperative launches, `post_launches` per call;
    x, attn float32 or bfloat16, supported(p)). marks: an int64
    (COOP_MAX_GRID, COOP_MARKS) tensor for the cooperative launch's
    POST_MARKS (`_marks`), or None."""
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
    out = torch.empty_like(x2)
    if post_launches(rows, dm) == 1:
        plan = post_plan(rows, dm, hid, *_layout(ints))
        coop_check("post_attention", plan, 0, code)
        _aligned16("post_attention", vecs[4:])
        f32 = dict(dtype=torch.float32, device=x.device)
        p1 = torch.empty(plan["ks_o"], rows, dm, **f32)
        part = torch.empty(plan["grid"], rows, dm, **f32)
        x1 = torch.empty(rows, dm, **f32)
        ptrs = [x2, a2] + vecs + [p1, part, out, x1]
        rc = lib.ptt_fused_post(
            (ctypes.c_void_p * len(ptrs))(*[_ptr(v) for v in ptrs]),
            (ctypes.c_int * len(ints))(*ints), _plan_ints(plan, PLAN_KEYS),
            rows, dm, hid, float(eps), int(approx),
            _marks("post_attention", marks, plan["grid"], x.device), code,
            stream)
        cuda_lib.check(rc, f"ptt_fused_post (plan {plan})")
        _count(post_attention, p, x)
        return out.reshape(x.shape)
    if marks is not None:
        raise ValueError("post_attention: marks are for the cooperative "
                         "launch")
    ls1, ls2, ns, nb, *lins = vecs
    x1 = torch.empty(rows, dm, dtype=torch.float32, device=x.device)
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
                     approx: bool = False, marks=None):
    """Same contract as bilayer_post_pre_plain; launches K5c once for CUDA
    tensors (x, attn (1, dm) float32 or bfloat16, bilayer_supported and
    supported(p); one cooperative launch). marks: as post_attention's, for
    BILAYER_MARKS."""
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
    if qints != ints[:2]:
        raise ValueError(f"bilayer_post_pre: layer l + 1's in_proj layout "
                         f"{qints} differs from layer l's {ints[:2]}")
    code = cuda_lib.dtype_code(x)
    plan = post_plan(1, dm, hid, *_layout(ints), n_next=n)
    coop_check("bilayer_post_pre", plan, 1, code)
    _aligned16("bilayer_post_pre", vecs[4:] + [w, s])
    f32 = dict(dtype=torch.float32, device=x.device)
    p1 = torch.empty(plan["ks_o"], 1, dm, **f32)
    xn32 = torch.empty(dm, **f32)
    part = torch.empty(plan["grid"], 1, dm, **f32)
    x1 = torch.empty(1, dm, **f32)
    out = torch.empty_like(x)
    qkv = torch.empty(1, n, dtype=x.dtype, device=x.device)
    ptrs = [x, attn] + vecs + [p1, part, out, x1]
    nptrs = [norm.get("scale"), norm.get("bias"), w, s, b, xn32, qkv]
    rc = cuda_lib.library().ptt_bilayer(
        (ctypes.c_void_p * len(ptrs))(*[_ptr(v) for v in ptrs]),
        (ctypes.c_int * len(ints))(*ints),
        (ctypes.c_void_p * len(nptrs))(*[_ptr(v) for v in nptrs]),
        (ctypes.c_int * 2)(*qints), _plan_ints(plan, PLAN_KEYS), dm, hid, n,
        float(eps), int(approx),
        _marks("bilayer_post_pre", marks, plan["grid"], x.device), code,
        cuda_lib.stream_ptr(x.device))
    cuda_lib.check(rc, f"ptt_bilayer (plan {plan})")
    bilayer_post_pre.launches_bilayer += 1
    return out, qkv


bilayer_post_pre.launches_bilayer = 0
# rows_mma_kernel and skinny_kernel launches of K5a and K5b (their
# routes), counted besides the wrappers' own counts
_rows_call.launches_mma = _rows_call.launches_skinny = 0
pre_attention.launches = pre_attention.launches_int4 = 0
post_attention.launches = post_attention.launches_int4 = 0
pre_attention.launches_lanes = post_attention.launches_lanes = 0
