"""K3: the whole SEANet decoder for one frame.

Replaces the TPU kernel `pocket_tts_tpu/ops/pallas_seanet.py:
seanet_frame`. On the card, `seanet_frame` launches a fixed sequence of
hand-written kernels from `csrc/seanet_frame.cu` (its header says what
bounds the decoder on the H100 and what the design does about it): per
frame one conv-GEMM per convolution but the last, on the tensor cores in
bf16, with bias, ELU and residual in its epilogue, the reduction split
over a thread-block cluster where the tile grid is small (`k3_plan`),
and carries written by a later launch of the frame; one overlap-add per
transposed conv, which writes y and ELU(y) and updates its carry in
place; and one small kernel for the final one-channel conv. 14 launches
per frame, at any lane count (`frame_shapes` lists them; the first port
made 22). The plain version is the `models/seanet.py` chain
(`forward_plain`).

The weight transforms of the TPU kernel's `_prep_weights` run once, at
load, in `prep_weights`: window-stacked (K*Cin, Cout) conv weights and
j-major (Cin, K*Cout) transposed-conv weights. The TPU kernel's
block-diagonal taps for the narrow last stage are not built: that stage's
blocked-time layout is the flat time-major tensor byte for byte, so the
kernels run it flat.

`seanet_frame` runs the plain version for tensors on the CPU and the kernels
for tensors on the card; there is no other switch. Both update the 8
carries in `state` IN PLACE. Both take an optional lane axis: x (B, T,
in_ch) with carries (B, ...); the kernels then stack the B streams on the
GEMMs' M axis, with the weights shared, and launch the same sequence as
for one stream.
"""
from __future__ import annotations

import ctypes

import torch

from . import cuda_lib

STAGES = (("model_2", "model_3"), ("model_5", "model_6"),
          ("model_8", "model_9"))
CARRY_KEYS = ("model_0", "model_2", "model_3", "model_5", "model_6",
              "model_8", "model_9", "model_11")


def kernel_ok(cfg) -> bool:
    """The decoder shape the kernels cover: three K == 2*stride stages and
    one output channel."""
    return (len(cfg.stages) == 3 and cfg.out_ch == 1
            and all(st.kernel == 2 * st.stride for st in cfg.stages))


def _window(mod):
    """conv (Cout, Cin, K) -> window-stacked (K*Cin, Cout), bias."""
    w = mod["w"]
    cout, cin, k = w.shape
    return w.permute(2, 1, 0).reshape(k * cin, cout).contiguous(), \
        mod.get("b")


def prep_weights(p, cfg) -> dict:
    """The kernels' weight layouts, built once per checkpoint. p: the
    decoder params (`params["mimi"]["decoder"]`)."""
    if not kernel_ok(cfg):
        raise NotImplementedError(f"SEANet shape not covered: {cfg}")
    out = {"model_0": _window(p["model_0"]),
           "model_11": _window(p["model_11"])}
    for tr, rn in STAGES:
        w = p[tr]["w"]
        cin, cout, k = w.shape
        out[tr] = (w.permute(0, 2, 1).reshape(cin, k * cout).contiguous(),
                   p[tr].get("b"))
        wr, br = _window(p[rn]["block_1"])
        wc = p[rn]["block_3"]["w"][:, :, 0].T.contiguous()
        out[rn] = (wr, br, wc, p[rn]["block_3"].get("b"))
    return out


# conv-GEMM tiling (csrc/seanet_frame.cu): the reduction's k-tile, the
# output tiles the kernel is built for (in the order tried), the blocks a
# grid should reach (2.5 on each of the card's 132 SMs), the most reduction
# slices (a cluster of at most 8 blocks), the fewest k-tiles a slice takes
# and the shortest reduction that is split. chip_smoke.py's
# `time_k3_plans` times every tile and split of the frame's GEMMs; with
# these values the plans' times sum to within 4% of the per-GEMM fastest,
# solo and at 32 lanes (PERF.md, section 6).
BK = 32
TILES = ((128, 64), (64, 64), (128, 32), (32, 64), (64, 32), (32, 32),
         (16, 64), (16, 32))
WAVE = 330
MAX_SPLITS = 8
MIN_KTILES = 3
SPLIT_KTILES = 12
# the final conv: LAST_ROWS output rows a block (csrc/seanet_frame.cu
# K3_LAST_ROWS)
LAST_ROWS = 64
# conv-GEMM A operands (csrc/seanet_frame.cu A_ROWS, A_WINDOW)
A_ROWS, A_WINDOW = 0, 1


def k3_plan(m: int, n: int, k: int):
    """(BM, BN, splits) of one conv-GEMM, M x N outputs over a reduction of
    K: the first tile of TILES whose grid, with a reduction of at least
    SPLIT_KTILES k-tiles split over up to MAX_SPLITS blocks of a cluster
    (each at least MIN_KTILES k-tiles, none empty), reaches WAVE blocks;
    the last tile when none does. A tile is skipped when half of it would
    already hold every row, or when it is 64 wide and N <= 32."""
    ktiles = -(-k // BK)
    plan = None
    for bm, bn in TILES:
        if (bm > 16 and bm // 2 >= m) or (bn == 64 and n <= 32):
            continue
        tiles = -(-m // bm) * -(-n // bn)
        splits = 1 if ktiles < SPLIT_KTILES else max(1, min(
            MAX_SPLITS, ktiles // MIN_KTILES, -(-WAVE // tiles)))
        per = -(-ktiles // splits)
        plan = (bm, bn, -(-ktiles // per))
        if tiles * plan[2] >= WAVE:
            break
    return plan


def k3_last_split(nt: int) -> int:
    """Blocks a lane of the final conv: one per LAST_ROWS of its nt rows."""
    return -(-nt // LAST_ROWS)


def frame_shapes(cfg, b: int, t: int):
    """The frame's launches over b lanes of t latent rows each, in order:
    [(name, kind, M, N, K)]: the conv-GEMMs ("gemm", K the reduction: taps
    x Cin), the overlap-adds ("overlap", M rows of N channels, K = 0) and
    the final conv ("last", N = out_ch)."""
    m = b * t
    rows = [("model_0", "gemm", m, cfg.stages[0].in_ch,
             cfg.first_kernel * cfg.in_ch)]
    for st, (tr, rn) in zip(cfg.stages, STAGES):
        rows.append((tr, "gemm", m, st.kernel * st.out_ch, st.in_ch))
        m *= st.stride
        hid = st.out_ch // 2
        rows += [(tr + ".overlap", "overlap", m, st.out_ch, 0),
                 (rn + ".block_1", "gemm", m, hid,
                  cfg.resnet_kernel * st.out_ch),
                 (rn + ".block_3", "gemm", m, st.out_ch, hid)]
    rows.append(("model_11", "last", m, cfg.out_ch,
                 cfg.last_kernel * cfg.stages[-1].out_ch))
    return rows


def frame_launches(cfg, state: dict, x, weights: dict, nb: int):
    """The frame's launches as data, in order: ([(name, kind, spec)], pcm).
    kind "gemm": spec holds the conv-GEMM's operands (mode, src, carry, w,
    bias, res, out: tensors or None), its ints (cin, nt, kw, pc, out_elu,
    res_elu), its `k3_plan` tile ("plan") and its tail (src, dst, rows,
    nt) or None, the carry it writes; kind "overlap": the transposed conv's
    overlap-add (u, carry, bias, y, ye, nu, s); kind "last": the final
    conv's (h, carry, w, bias, out, nt, cin, kw, pc, blocks). x: (nb*T,
    in_ch), lane-major; the carries in `state` hold nb lanes. Every
    intermediate tensor is made here and referenced by the list, so no
    launch's tail reads memory the allocator has handed to another
    tensor."""
    t = x.shape[0] // nb
    out = []

    def new(rows, cols):
        return torch.empty(rows, cols, dtype=x.dtype, device=x.device)

    def carry_rows(key, ch):
        return state[key].numel() // (nb * ch)

    def gemm(name, mode, src, w, bias, dst, cin, nt, kw=1, carry=None,
             pc=0, out_elu=0, res=None, res_elu=0, tail=None):
        out.append((name, "gemm", dict(
            mode=mode, src=src, carry=carry, w=w, bias=bias, res=res,
            out=dst, cin=cin, nt=nt, kw=kw, pc=pc, out_elu=out_elu,
            res_elu=res_elu, tail=tail,
            plan=k3_plan(dst.shape[0], dst.shape[1], w.shape[0]))))

    w0, b0 = weights["model_0"]
    h = new(nb * t, w0.shape[1])
    pc0 = carry_rows("model_0", cfg.in_ch)
    gemm("model_0", A_WINDOW, x, w0, b0, h, cfg.in_ch, t,
         kw=cfg.first_kernel, carry=state["model_0"], pc=pc0, out_elu=1)
    # the first conv's carry (the last latent rows), once launch 1 read it
    tail = (x, state["model_0"], pc0, t)
    for st, (tr, rn) in zip(cfg.stages, STAGES):
        s, cout = st.stride, st.out_ch
        w2, b2 = weights[tr]
        u = new(nb * t, w2.shape[1])
        gemm(tr, A_ROWS, h, w2, None, u, h.shape[1], t, tail=tail)
        tu, t = t, t * s
        y, ye = new(nb * t, cout), new(nb * t, cout)
        out.append((tr + ".overlap", "overlap", dict(
            u=u, carry=state[tr], bias=b2, y=y, ye=ye, nu=tu, s=s)))
        wr, br, wc, bc = weights[rn]
        v = new(nb * t, wr.shape[1])
        pr = carry_rows(rn, cout)
        gemm(rn + ".block_1", A_WINDOW, ye, wr, br, v, cout, t,
             kw=cfg.resnet_kernel, carry=state[rn], pc=pr, out_elu=1)
        h = new(nb * t, cout)
        # the resnet conv's carry (the last rows of ELU(y)), which only the
        # k3 conv read
        gemm(rn + ".block_3", A_ROWS, v, wc, bc, h, wc.shape[0], t, res=y,
             res_elu=1, tail=(ye, state[rn], pr, t))
        tail = None
    w11, b11 = weights["model_11"]
    pcm = new(nb * t, cfg.out_ch)
    out.append(("model_11", "last", dict(
        h=h, carry=state["model_11"], w=w11, bias=b11, out=pcm, nt=t,
        cin=h.shape[1], kw=cfg.last_kernel,
        pc=carry_rows("model_11", h.shape[1]), blocks=k3_last_split(t))))
    return out, pcm


def _ptr(t):
    return None if t is None else t.data_ptr()


def gemm_args(sp, nb: int, plan, dt: int, stream: int):
    """`ptt_seanet_gemm`'s arguments for a "gemm" spec of
    `frame_launches` over nb lanes, tiled by plan = (BM, BN, splits)."""
    bm, bn, splits = plan
    tsrc, tdst, trows, tnt = sp["tail"] or (None, None, 0, 0)
    return ((ctypes.c_void_p * 8)(*(_ptr(v) for v in (
        sp["src"], sp["carry"], sp["w"], sp["bias"], sp["res"], sp["out"],
        tsrc, tdst))),
        (ctypes.c_int * 15)(
            sp["mode"], nb, sp["nt"], sp["cin"], sp["out"].shape[1],
            sp["kw"], sp["pc"], sp["out_elu"], sp["res_elu"], bm, bn,
            splits, 0 if tsrc is None else tsrc.shape[1], trows, tnt),
        dt, stream)


def frame_steps(cfg, state: dict, x, weights: dict, nb: int):
    """`frame_launches` bound to the kernels: ([(name, (M, N, K), run)],
    pcm), `run()` making one launch (`seanet_frame` runs them all in
    order; chip_smoke.py times each)."""
    lib = cuda_lib.library()
    dt = cuda_lib.dtype_code(x)
    stream = cuda_lib.stream_ptr(x.device)
    launches, pcm = frame_launches(cfg, state, x, weights, nb)
    steps = []
    for name, kind, sp in launches:
        if kind == "gemm":
            args = gemm_args(sp, nb, sp["plan"], dt, stream)
            fn = lib.ptt_seanet_gemm
            mnk = (*sp["out"].shape, sp["w"].shape[0])
        elif kind == "overlap":
            args = (sp["u"].data_ptr(), sp["carry"].data_ptr(),
                    _ptr(sp["bias"]), sp["y"].data_ptr(),
                    sp["ye"].data_ptr(), nb, sp["nu"], sp["s"],
                    sp["y"].shape[1], dt, stream)
            fn = lib.ptt_seanet_overlap
            mnk = (*sp["y"].shape, 0)
        else:
            args = (sp["h"].data_ptr(), sp["carry"].data_ptr(),
                    sp["w"].data_ptr(), _ptr(sp["bias"]),
                    sp["out"].data_ptr(), nb, sp["nt"], sp["cin"], sp["kw"],
                    sp["pc"], sp["blocks"], dt, stream)
            fn = lib.ptt_seanet_last
            mnk = (*sp["out"].shape, sp["w"].shape[0])

        def run(fn=fn, args=args, label=fn.__name__):
            cuda_lib.check(fn(*args), label)
        steps.append((name, mnk, run))
    return steps, pcm


def seanet_frame(p, cfg, state: dict, x, weights: dict = None):
    """x: (T, in_ch) -> pcm (T * total_stride, out_ch), or with a lane axis
    x (B, T, in_ch) -> (B, T * total_stride, out_ch); the carries in
    `state` (with the lane axis: (B, ...) each) are updated in place. p:
    decoder params; weights: their `prep_weights` (built here when not
    given, which costs the transforms every call)."""
    if x.device.type == "cpu":
        from ..models.seanet import forward_plain
        new, pcm = forward_plain(p, cfg, state, x)
        for key in state:
            state[key].copy_(new[key])
        return pcm
    if x.device.type != "cuda":
        raise ValueError(f"seanet_frame: unsupported device {x.device}")
    if weights is None:
        weights = prep_weights(p, cfg)
    lanes = x.dim() == 3
    nb = x.shape[0] if lanes else 1
    for key in CARRY_KEYS:
        c = state[key]
        if c.dtype != x.dtype or not c.is_contiguous() \
                or c.device != x.device:
            raise ValueError(f"seanet_frame: bad carry {key}")
        if lanes and c.shape[0] != nb:
            raise ValueError(f"seanet_frame: carry {key} has no lane axis "
                             f"of {nb}")
    steps, pcm = frame_steps(cfg, state, x.reshape(-1, x.shape[-1])
                             .contiguous(), weights, nb)
    for _, _, run in steps:
        run()
    seanet_frame.launches += 1
    return pcm.reshape(nb, -1, cfg.out_ch) if lanes else pcm


seanet_frame.launches = 0
