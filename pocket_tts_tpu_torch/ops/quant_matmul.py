"""K4a and K4b: x @ a quantized weight (int8, or packed int4).

K4a replaces the TPU kernel `pocket_tts_tpu/ops/quant_matmul.py:
int8_matmul_pallas`, K4b `int4_matmul_pallas` (`_int4_kernel`,
`_int4_grouped_kernel`). Both run the row-block product of the fused
layer (csrc/fused_layer.cu) with the plain load prologue and the rounding
epilogue, on its route (`fused_layer.rows_route`): `rows_mma_kernel` on
the tensor cores for bf16 calls of MMA_ROWS (16) rows or more,
`skinny_kernel` below (input_linear once a frame: T = 1, K = 32),
`rows_kernel` for float32 (fused_layer.cu's header says what bounds them
on the H100 and what the designs do about it). K4a's route (`int8_route`)
has a fourth kernel: bf16 calls of WGMMA_ROWS (64) rows or more (the
prefill's 64, 128 and 256-row buckets) run `wgmma_int8_kernel`
(csrc/wgmma_matmul.cu: a TMA ring under mbarriers kept full by a
producer warp, a widening warpgroup writing each int8 box as a bf16 tile
in shared memory, a consumer warpgroup on `wgmma.mma_async`;
`wgmma_plan`). The plain versions are the JAX package's
off-TPU math (`_core`), with grouped int4 scales applied in float32.

Layouts (io/quant.py), one layer of a stacked (L, ...) weight being `q[l]`,
a contiguous view:
  int8  q (K, N) int8, scale (N,) float32 per output channel
  int4  q4 (K/2, N) int8, packed halves: byte = 16*hi + (lo + 8), packed
        row r holds logical row r in the low nibble (biased) and logical
        row r + K/2 in the high nibble (signed); scale (N,) float32 per
        output channel, or K-grouped (K/group, N) bfloat16 (q4_0, group
        32), whose row g covers logical rows [g*group, (g+1)*group)

`int8_matmul` and `int4_matmul` run the plain version for tensors on the
CPU and the kernel of their route for tensors on the card; there is no
other switch. `kernel_operands` is the layout check the fused kernels
(K5a, K5b, K6) share.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from . import cuda_lib

# weight kinds of a linear as the fused CUDA kernels take them (csrc/qdot.cuh)
PLAIN, INT8, INT4, INT4_GROUPED = range(4)


def pack_int4(q: np.ndarray) -> np.ndarray:
    """q (..., K, N) integers in [-8, 7] -> packed (..., K/2, N) int8:
    byte = 16*hi + (lo + 8), lo = logical row r, hi = row r + K/2."""
    k = q.shape[-2]
    if k % 2:
        raise ValueError(f"int4 packing needs an even K, not {k}")
    q16 = q.astype(np.int16)
    lo, hi = q16[..., : k // 2, :] + 8, q16[..., k // 2:, :]
    return (16 * hi + lo).astype(np.int8)


def unpack_int4(q4, dtype=torch.float32):
    """packed (..., K/2, N) int8 -> (..., K, N) values in [-8, 7]."""
    b = q4.to(torch.int16)
    return torch.cat([(b & 0xF) - 8, b >> 4], dim=-2).to(dtype)


def grouped(lin) -> bool:
    """True when an int4 linear carries K-grouped (q4_0) scales."""
    return "q4" in lin and lin["scale"].dim() == lin["q4"].dim()


def deq_dot(x, lin):
    """float32 x @ W for a linear {"w"}, {"q", "scale"} or {"q4",
    "scale"} (one layer), without the bias: per-channel scales multiply
    the float32 product, grouped scales the (exact) float32 weight."""
    x32 = x.float()
    if "w" in lin:
        return x32 @ lin["w"].float()
    if "q" in lin:
        return (x32 @ lin["q"].float()) * lin["scale"]
    w = unpack_int4(lin["q4"])
    if grouped(lin):
        s = lin["scale"].float()
        return x32 @ (w * s.repeat_interleave(w.shape[-2] // s.shape[-2],
                                              dim=-2))
    return (x32 @ w) * lin["scale"]


def _bad(name, **tensors):
    return ValueError(
        f"{name}: bad operands " + ", ".join(
            f"{k}{tuple(t.shape)} {t.dtype} {t.device} "
            f"contiguous={t.is_contiguous()}" for k, t in tensors.items()))


def int8_matmul_plain(x, q, scale):
    """x (..., K) @ (q (K, N) widened to x's type) accumulated in float32,
    times scale, rounded to x's type. x and q widen to float32 exactly
    (bf16 values and |q| <= 127), so the float32 product is the f32-
    accumulated product of the working-type operands."""
    y = deq_dot(x.reshape(-1, x.shape[-1]), {"q": q, "scale": scale})
    return y.to(x.dtype).reshape(*x.shape[:-1], q.shape[-1])


# K4a's fourth kernel (csrc/wgmma_matmul.cu `wgmma_int8_kernel`): bf16
# calls of WGMMA_ROWS rows or more take it (chip_smoke.py
# `time_k4a_plans` times it beside rows_mma_kernel on the four prefill
# linears at 64, 128 and 256 rows; PERF.md section 6). A block takes
# WGMMA_BN output channels (two m64 tiles) by bt token rows (the wgmma's
# N: 64 or 128) over a slice of the k-blocks of WGMMA_BK; the slices of a
# tile are the blocks of one cluster (at most WGMMA_MAX_SPLITS, the
# portable size); a ring of WGMMA_STAGES k-blocks, each an x box, an int8
# weight box and the weight widened to bf16.
WGMMA_ROWS = 64
WGMMA_BK, WGMMA_BN = 64, 128
WGMMA_BTS = (128, 64)
WGMMA_MAX_SPLITS = 8
WGMMA_WAVE = 132         # one block an SM of the H100
# a block's fixed time (entry, the first boxes, the epilogue: ~4 us
# against ~0.75 a k-block at 128 rows, chip_smoke.py `k4a_marks`) in
# k-blocks
WGMMA_FIXED_KB = 4
WGMMA_STAGES = 4
WGMMA_CS_LD = WGMMA_BN + 4   # a row of the float32 tile (floats)
WGMMA_ALIGN = 1024        # the 128-byte swizzle's period
WGMMA_PLAN_KEYS = ("bt", "splits", "kb_per", "stages", "smem", "o_x",
                   "o_q", "o_w", "o_bar", "o_c")
# a block's %globaltimer marks (`marks=` of wgmma_launch): instants (ns),
# the ns each role waited on the ring's mbarriers, the ns of widening
WGMMA_MARKS = ("entry", "first landed", "products done", "exit",
               "consumers on full", "consumers on wide", "wideners on full",
               "producer on empty", "widening")


def int8_route(dtype, rows: int) -> str:
    """K4a's kernel for a call of `rows` rows: "wgmma" (wgmma_int8_kernel)
    for bf16 calls of at least WGMMA_ROWS rows, else the row-block
    family's (`fused_layer.rows_route`: "mma", "skinny", "simt")."""
    from .fused_layer import rows_route
    if dtype == torch.bfloat16 and rows >= WGMMA_ROWS:
        return "wgmma"
    return rows_route(dtype, rows)


def _wgmma_split(rows: int, k: int, n: int, bt: int, splits: int,
                 fits) -> tuple:
    """(cost, splits, k-blocks a slice) at token tile bt: `splits` when
    given, else of 1..WGMMA_MAX_SPLITS (within the k-blocks) the least
    cost, fewer splits on a tie; cost: the waves of clusters (one a
    tile; fits[bt][splits - 1] of them at once) x the busiest block's
    k-blocks and WGMMA_FIXED_KB."""
    kb = -(-k // WGMMA_BK)
    tiles = -(-rows // bt) * -(-n // WGMMA_BN)
    best = None
    for sp in ([splits] if splits
               else range(1, min(WGMMA_MAX_SPLITS, kb) + 1)):
        per = -(-kb // sp)
        sp = -(-kb // per)
        cap = fits[bt][sp - 1]
        cost = (-(-tiles // cap) * (per + WGMMA_FIXED_KB) if cap > 0
                else float("inf"))
        if best is None or cost < best[0]:
            best = (cost, sp, per)
    return best


def model_fits():
    """The clusters of 1..WGMMA_MAX_SPLITS blocks the card holds at once,
    for each bt, as a model: one block an SM, WGMMA_WAVE SMs
    (`wgmma_fits` asks the card)."""
    return {bt: tuple(WGMMA_WAVE // sp
                      for sp in range(1, WGMMA_MAX_SPLITS + 1))
            for bt in WGMMA_BTS}


def wgmma_fits(lib) -> dict:
    """{bt: (clusters of 1..WGMMA_MAX_SPLITS blocks the card holds at once
    at that bt's shared memory)}, asked of the card once
    (ptt_wgmma_max_clusters). Cached per process: a process drives one
    card (a mesh rank holds its card for life, parallel/launch.py)."""
    if "fits" not in _wgmma_state:
        _wgmma_state["fits"] = {
            bt: tuple(lib.ptt_wgmma_max_clusters(bt, sp, _wgmma_smem(bt))
                for sp in range(1, WGMMA_MAX_SPLITS + 1))
            for bt in WGMMA_BTS}
    return _wgmma_state["fits"]


_wgmma_state = {}


def _wgmma_offsets(bt: int) -> dict:
    """A block's shared-memory layout at tile height bt: WGMMA_STAGES of
    each ring (x: bt rows of 128 bytes; the int8 weight box: WGMMA_BK
    rows of WGMMA_BN bytes; the weight widened to bf16 and transposed:
    WGMMA_BN rows of 128 bytes), the full, wide and empty mbarriers (24
    bytes a stage), and the total with WGMMA_ALIGN to align the base; the
    float32 output tile (bt x WGMMA_CS_LD floats) lies over the rings,
    used once they are done."""
    s = WGMMA_STAGES
    o_q = s * bt * 128
    o_w = o_q + s * WGMMA_BK * WGMMA_BN
    o_bar = o_w + s * 2 * WGMMA_BK * WGMMA_BN
    return dict(o_x=0, o_q=o_q, o_w=o_w, o_bar=o_bar, o_c=0,
                smem=o_bar + 24 * s + WGMMA_ALIGN)


def _wgmma_smem(bt: int) -> int:
    return _wgmma_offsets(bt)["smem"]


def wgmma_plan(rows: int, k: int, n: int, bt: int = 0, splits: int = 0,
               fits=None) -> dict:
    """One wgmma_int8_kernel call over `rows` rows of a (k, n) int8
    linear: bt (of WGMMA_BTS; 128 only above 64 rows) and the split of the
    k-blocks over a cluster, the pair of least `_wgmma_split` cost (ties
    to the larger bt) given `fits` (`wgmma_fits`, the card's; None: the
    model `model_fits`); bt or splits > 0 take that value, for the sweep.
    The grid is (splits, n / WGMMA_BN, rows / bt), rounded up; the shared
    memory `_wgmma_offsets`; WGMMA_PLAN_KEYS the order the kernel takes
    them in. Raises ValueError on widths the kernel does not take
    (K a multiple of 8, N of 16: the TMA's 16-byte row strides)."""
    return _wgmma_plan(rows, k, n, bt, splits,
                       tuple(sorted((fits or model_fits()).items())))


@functools.lru_cache(maxsize=None)
def _wgmma_plan(rows, k, n, bt, splits, fits):
    from .fused_layer import SMEM_MAX
    if rows < 1 or k < 8 or k % 8 or n < 16 or n % 16:
        raise ValueError(f"wgmma_plan: the warpgroup route takes K a "
                         f"multiple of 8 and N of 16, not rows={rows} "
                         f"K={k} N={n}")
    fits = dict(fits)
    bts = [bt] if bt else [b for b in WGMMA_BTS if b == 64 or rows > 64]
    cost, _, sp, per, bt = min(
        (c, -b, sp, per, b) for b in bts
        for c, sp, per in [_wgmma_split(rows, k, n, b, splits, fits)])
    lay = _wgmma_offsets(bt)
    if (cost == float("inf") or sp > WGMMA_MAX_SPLITS
            or bt * WGMMA_CS_LD * 4 > lay["o_bar"]
            or lay["smem"] > SMEM_MAX):
        raise ValueError(f"wgmma_plan: no plan for rows={rows} K={k} N={n} "
                         f"bt={bt} splits={sp}")
    return dict(bt=bt, splits=sp, kb_per=per, stages=WGMMA_STAGES,
                grid=(sp, -(-n // WGMMA_BN), -(-rows // bt)), **lay)


def wgmma_launch(lib, x2, q, scale, y, rows: int, k: int, n: int, stream,
                 marks=None) -> dict:
    """One wgmma_int8_kernel launch, y = round((x2 @ q) * scale), with
    `wgmma_plan` on the card's `wgmma_fits`; returns the plan, counts
    nothing. marks: an int64
    (blocks, len(WGMMA_MARKS)) tensor on the device (block (z, y, x) of the
    plan's grid at row z + splits (y + grid[1] x)) for the WGMMA_MARKS, or
    None."""
    plan = wgmma_plan(rows, k, n, fits=wgmma_fits(lib))
    if x2.data_ptr() % 16 or q.data_ptr() % 16 or scale.data_ptr() % 16:
        raise ValueError("wgmma: x, q and scale must be 16-byte aligned")
    blocks = plan["grid"][0] * plan["grid"][1] * plan["grid"][2]
    if marks is not None and not (
            marks.dtype == torch.int64 and marks.is_contiguous()
            and marks.shape == (blocks, len(WGMMA_MARKS))
            and marks.device == x2.device):
        raise ValueError(f"wgmma: marks must be int64 ({blocks}, "
                         f"{len(WGMMA_MARKS)}) on {x2.device}")
    keys = (ctypes.c_int * len(WGMMA_PLAN_KEYS))(
        *[plan[key] for key in WGMMA_PLAN_KEYS])
    cuda_lib.check(lib.ptt_wgmma_int8(
        x2.data_ptr(), q.data_ptr(), scale.data_ptr(), y.data_ptr(), rows,
        k, n, keys, 0 if marks is None else marks.data_ptr(), stream),
        f"ptt_wgmma_int8 (rows {rows}, K {k}, N {n}, plan {plan})")
    return plan


def int8_matmul(x, q, scale):
    """Same contract as int8_matmul_plain; for CUDA tensors (x float32 or
    bfloat16, `kernel_operands`' layouts) launches the kernel of x's
    route (`int8_route`) once (`_int8_cuda`)."""
    if x.device.type == "cpu":
        return int8_matmul_plain(x, q, scale)
    if x.device.type != "cuda":
        raise ValueError(f"int8_matmul: unsupported device {x.device}")
    return _int8_cuda(x, q, scale)


def _int8_cuda(x, q, scale):
    """int8_matmul on the card: one launch of wgmma_int8_kernel
    (`wgmma_launch`) or of the row-block product (`fused_layer.
    rows_launch`), counted in `int8_matmul.launches` only (the warpgroup
    kernel's once more in `launches_wgmma`)."""
    from .fused_layer import EPI_ROUND, ROWS_LOAD, rows_launch
    k, n = q.shape
    x2 = x.reshape(-1, x.shape[-1])
    rows = x2.shape[0]
    if not (x2.shape[1] == k and rows >= 1 and x2.is_contiguous()
            and x.dtype in (torch.float32, torch.bfloat16)):
        raise _bad("int8_matmul", x=x, q=q, scale=scale)
    lin, layout = kernel_operands({"q": q, "scale": scale}, k, n, x)
    y = torch.empty(rows, n, dtype=x.dtype, device=x.device)
    lib, stream = cuda_lib.library(), cuda_lib.stream_ptr(x.device)
    if int8_route(x.dtype, rows) == "wgmma":
        wgmma_launch(lib, x2, q, scale, y, rows, k, n, stream)
        int8_matmul.launches_wgmma += 1
    else:
        rows_launch(lib, x.dtype, x2, (None, None), lin, layout, None, None,
                    y, rows, k, n, ROWS_LOAD, EPI_ROUND, False, 0.0, stream)
    int8_matmul.launches += 1
    return y.reshape(*x.shape[:-1], n)


def int4_matmul_plain(x, q4, scale):
    """x (..., K) @ dequant(q4 (K/2, N)) accumulated in float32, with
    per-channel scale (N,) applied to the product or grouped scale
    (K/group, N) to the weight (nibble x bf16 scale is exact in float32),
    rounded once to x's type."""
    y = deq_dot(x.reshape(-1, x.shape[-1]), {"q4": q4, "scale": scale})
    return y.to(x.dtype).reshape(*x.shape[:-1], q4.shape[-1])


def int4_matmul(x, q4, scale):
    """Same contract as int4_matmul_plain; for CUDA tensors (x float32 or
    bfloat16, `kernel_operands`' layouts) launches the row-block product
    of x's route once (`fused_layer.rows_launch`), counted here only."""
    if x.device.type == "cpu":
        return int4_matmul_plain(x, q4, scale)
    if x.device.type != "cuda":
        raise ValueError(f"int4_matmul: unsupported device {x.device}")
    from .fused_layer import EPI_ROUND, ROWS_LOAD, rows_launch
    kh, n = q4.shape
    x2 = x.reshape(-1, x.shape[-1])
    if not (x2.shape[1] == 2 * kh and x2.shape[0] >= 1
            and x2.is_contiguous()
            and x.dtype in (torch.float32, torch.bfloat16)):
        raise _bad("int4_matmul", x=x, q4=q4, scale=scale)
    lin, layout = kernel_operands({"q4": q4, "scale": scale}, 2 * kh, n, x)
    y = torch.empty(x2.shape[0], n, dtype=x.dtype, device=x.device)
    rows_launch(cuda_lib.library(), x.dtype, x2, (None, None), lin, layout,
                None, None, y, x2.shape[0], 2 * kh, n, ROWS_LOAD, EPI_ROUND,
                False, 0.0, cuda_lib.stream_ptr(x.device))
    int4_matmul.launches += 1
    return y.reshape(*x.shape[:-1], n)


int8_matmul.launches = int8_matmul.launches_wgmma = 0
int4_matmul.launches = 0


def bits(lin) -> int:
    """8 or 4 for a quantized linear, 16 for a plain one, 0 otherwise (the
    JAX package's `fused_layer._qw` classes)."""
    for key, b in (("q", 8), ("q4", 4), ("w", 16)):
        if key in lin:
            return b
    return 0


def kernel_operands(lin, k: int, n: int, x, layers=None):
    """[w, scale, bias] and [kind, group] of a linear of logical shape
    (k, n) (stacked over `layers` when given) for the fused kernels, after
    checking what they read: shapes, dtypes, contiguity, x's device, N a
    multiple of 4, and the alignment of 4-column loads. A missing scale or
    bias is None. Raises ValueError on anything else."""
    pre = () if layers is None else (layers,)
    b = lin.get("b")
    items = [(b, pre + (n,), x.dtype, 1)]
    layout_ok = n % 4 == 0
    if "q" in lin:
        w, s, kind, group = lin["q"], lin["scale"], INT8, 0
        items += [(w, pre + (k, n), torch.int8, 4),
                  (s, pre + (n,), torch.float32, 1)]
    elif "q4" in lin:
        w, s = lin["q4"], lin["scale"]
        items.append((w, pre + (k // 2, n), torch.int8, 4))
        layout_ok = layout_ok and k % 2 == 0
        if grouped(lin):
            ng = s.shape[-2]
            kind, group = INT4_GROUPED, k // max(ng, 1)
            items.append((s, pre + (ng, n), torch.bfloat16, 8))
            # whole groups in each half of K (io/quant.py's rule)
            layout_ok = layout_ok and ng * group == k and (k // 2) % group == 0
        else:
            kind, group = INT4, 0
            items.append((s, pre + (n,), torch.float32, 1))
    elif "w" in lin:
        w, s, kind, group = lin["w"], None, PLAIN, 0
        items.append((w, pre + (k, n), x.dtype, 4 * x.element_size()))
    else:
        raise ValueError(f"not a linear: {sorted(lin)}")
    bad = [(tuple(t.shape), t.dtype) for t, shape, dtype, align in items
           if t is not None and not (
               tuple(t.shape) == shape and t.dtype == dtype
               and t.is_contiguous() and t.device == x.device
               and t.data_ptr() % align == 0)]
    if bad or not layout_ok:
        raise ValueError(f"linear ({k}, {n}): bad operands {bad}")
    return [w, s, b], [kind, group]
