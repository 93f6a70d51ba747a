"""K6: the whole quantized flow net (SimpleMLPAdaLN) in one launch.

Replaces the TPU kernel `pocket_tts_tpu/ops/fused_flow.py:_make_flow`. The
CUDA kernel is `csrc/fused_flow.cu` (its header says what bounds it on the
H100 and what the design does about it). The plain version follows the
TPU kernel's arithmetic (`fused_flow.py:_kernel`), not the unfused chain
of `linear` calls: activations stay float32 between dots, each dot's
operand is rounded to the working type, LayerNorm eps is 1e-6, the
conditioning silu(tc + cond_embed(c)) is computed once, and the output is
rounded once. Missing in_ln / final-norm affine parameters read as ones
and zeros, missing biases as zeros. Each linear keeps its own layout
(quant_matmul.deq_dot): the big ones are all int8 or all int4, with
per-channel or K-grouped (q4_0) scales; input_proj and final.linear may be
int8, int4 or plain (under q4_0 at full width input_proj, K = 32, falls
back to per-channel int4 beside grouped big linears).

On the card a call is two launches (`LAUNCHES`): the modulations (sy and
every AdaLN modulation, clusters of blocks over the whole card), then the
chain of residual blocks on one thread-block cluster of 16 blocks (8 where
the card cannot place 16: `flow_cluster`) per row block, the steps
separated by cluster barriers and the activations exchanged through
distributed shared memory (csrc/fused_flow.cu). `flow_plan` sizes both:
bf16 calls of FLOW_MMA_ROWS rows or more run their products on the tensor
cores in row blocks of up to MMA_ROWS_BLOCK rows (64: the 64 lanes of a
large server in one cluster), smaller bf16 calls and float32 on SIMT in
row blocks of up to SIMT_ROWS_BLOCK (16); the chain keeps its next W0 / W2
weight columns in a ring of up to 3 slots in shared memory.

Lanes: c (B, d_model) and x (B, latent) give (B, latent), the JAX
package's vmap rule (`fused_flow.py:202-211`): all B rows in the same two
launches, a cluster per row block. The plain version takes either shape.

`flow_forward` runs the plain version for tensors on the CPU and the
kernels for tensors on the card; there is no other switch. Solo launches
(1-D x) whose big linears are int8 count in `flow_forward.launches`, int4
in `flow_forward.launches_int4`; launches over lanes (2-D x) in
`flow_forward.launches_lanes`, each call adding LAUNCHES.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import cuda_lib
from .basic import layer_norm, silu, slice_layer_params
from .quant_matmul import bits, deq_dot, kernel_operands


def _big(p):
    rb = p["res_blocks"]
    return (p["cond_embed"], rb["adaln"], rb["mlp_0"], rb["mlp_2"],
            p["final"]["adaln"])


def supported(p) -> bool:
    """The JAX package's `fused_flow.supported`: the big flow linears share
    one of int8 and int4 (either scale layout); input_proj and
    final.linear (a few KB) may be int8, int4 or plain."""
    kinds = {bits(m) for m in _big(p)}
    return (len(kinds) == 1 and kinds <= {4, 8}
            and all(bits(m) in (4, 8, 16)
                    for m in (p["input_proj"], p["final"]["linear"])))


def _dot(v32, lin, dt):
    """round(v32) @ W in float32 with the weight's scales, plus the
    bias."""
    y = deq_dot(v32.to(dt), lin)
    b = lin.get("b")
    return y if b is None else y + b.float()


def _modulated_ln(h, norm, shift, scale):
    return layer_norm(norm, h, eps=1e-6) * (1.0 + scale) + shift


def flow_forward_plain(p, c, x, t_combined):
    """c (..., d_model), x (..., latent), t_combined (dim,) -> (...,
    latent) in x's dtype."""
    dt = x.dtype
    rb = p["res_blocks"]
    sy = silu(t_combined.float() + _dot(c.float(), p["cond_embed"], dt))
    h = _dot(x.float(), p["input_proj"], dt)
    for i in range(rb["adaln"]["scale"].shape[0]):
        blk = slice_layer_params(rb, i)
        shift, scale, gate = _dot(sy, blk["adaln"], dt).chunk(3, -1)
        hn = _modulated_ln(h, blk.get("in_ln"), shift, scale)
        h = h + gate * _dot(silu(_dot(hn, blk["mlp_0"], dt)), blk["mlp_2"],
                            dt)
    shift, scale = _dot(sy, p["final"]["adaln"], dt).chunk(2, -1)
    hn = _modulated_ln(h, p["final"].get("norm"), shift, scale)
    return _dot(hn, p["final"]["linear"], dt).to(dt)


# launches a call makes on the card: the modulations, then the chain
LAUNCHES = 2
# the product route: bf16 calls of at least FLOW_MMA_ROWS rows run on the
# tensor cores; row blocks (a cluster each) of at most MMA_ROWS_BLOCK rows
# there, SIMT_ROWS_BLOCK on SIMT (float32, and fewer bf16 rows)
FLOW_MMA_ROWS = 16
MMA_ROWS_BLOCK, SIMT_ROWS_BLOCK = 64, 16
# csrc/fused_flow.cu: cluster sizes tried in order, weight ring slots tried
# in order, logical weight rows widened at once and the widened tile's row
# stride, modulation columns a tile; qdot.cuh QD_RED; the dynamic shared
# memory a block may take beside the kernels' static peer tables; the SMs
# the modulation launch aims to fill
CLUSTERS = (16, 8)
SLOTS = (3, 2)
FF_KC, FF_BS_LD, FF_MTILE = 256, 40, 32
QD_RED = 8192
SMEM_LIMIT = 232448 - 2048
SMS = 132


def flow_cols(n: int, parts: int) -> int:
    """Columns of n a chain block takes when `parts` blocks share them
    (csrc/fused_flow.cu `ff_cols`: a multiple of 8; the last blocks may
    take fewer, or none)."""
    return (-(-n // parts) + 7) // 8 * 8


def _up16(n):
    return -(-n // 16) * 16


def _work_smem(mma, rb, kmax):
    if mma:
        return 2 * _up16(rb) * (_up16(kmax) + 8) + 2 * FF_KC * FF_BS_LD
    return 4 * (rb * kmax + QD_RED)


def slot_bytes(dim, hid, rb, csize, packed, group):
    """Bytes of one slot of the chain's weight ring (csrc/fused_flow.cu
    `ff_slot`): one block's columns of W0 (dim, hid) or W2 (hid, dim), the
    larger, then their grouped scales (group 0: per-channel), per-channel
    scales and bias, then the step's modulation columns (shift and scale
    of rb rows, the norm's scale and bias; or the gate)."""
    cwd, cwh = flow_cols(dim, csize), flow_cols(hid, csize)
    half = 2 if packed else 1
    w = max(dim // half * cwh, hid // half * cwd)
    g = max(dim // group * cwh, hid // group * cwd) * 2 if group else 0
    return (-(-w // 16) * 16 + -(-g // 16) * 16 + 8 * max(cwd, cwh)
            + 4 * (2 * rb * cwd + 2 * cwd))


def flow_plan(dmodel, dim, hid, latent, depth, rows, dtype, packed, group,
              csize):
    """How a call of `rows` rows runs on clusters of `csize` blocks:
    {"mma": tensor cores, "rb": rows a row block, "nslot": chain ring
    slots, "ncl": modulation clusters a row block, "chain_smem",
    "mods_smem": dynamic shared memory a block of each launch
    (csrc/fused_flow.cu `ff_chain_smem`, `ff_mods_smem`)}. nslot is the
    most of SLOTS that fits, with the row block halved on the tensor cores
    when none does at MMA_ROWS_BLOCK; raises when none fits at all."""
    mma = dtype == torch.bfloat16 and rows >= FLOW_MMA_ROWS
    for rb in ((MMA_ROWS_BLOCK, MMA_ROWS_BLOCK // 2) if mma
               else (SIMT_ROWS_BLOCK,)):
        rb = min(rows, rb)
        fixed = (4 * rb * (2 * flow_cols(dim, csize)
                           + flow_cols(hid, csize))
                 + _work_smem(mma, rb, max(dim, hid, latent)))
        slot = slot_bytes(dim, hid, rb, csize, packed, group)
        nslot = next((n for n in SLOTS if fixed + n * slot <= SMEM_LIMIT),
                     0)
        if nslot:
            break
    mods_smem = (4 * rb * flow_cols(dim, csize)
                 + _work_smem(mma, rb, max(dmodel, dim)))
    if not nslot or mods_smem > SMEM_LIMIT:
        raise ValueError(f"flow_plan: {rows} rows of dim {dim} do not fit "
                         f"a cluster of {csize}")
    tiles = depth * -(-3 * dim // FF_MTILE) + -(-2 * dim // FF_MTILE)
    return dict(mma=mma, rb=rb, nslot=nslot,
                ncl=max(1, min(-(-tiles // csize), SMS // csize)),
                chain_smem=fixed + nslot * slot, mods_smem=mods_smem)


@functools.lru_cache(maxsize=None)
def flow_cluster(dmodel, dim, hid, latent, depth, rows, dtype, packed,
                 group) -> int:
    """The first of CLUSTERS (16 blocks, non-portable; then 8) whose
    clusters the card can place with this call's shared memory. Cached
    per process, which drives one card (parallel/launch.py: one a rank)."""
    lib = cuda_lib.library()
    code = cuda_lib.dtype_code(torch.empty(0, dtype=dtype))
    for csize in CLUSTERS:
        plan = flow_plan(dmodel, dim, hid, latent, depth, rows, dtype,
                         packed, group, csize)
        if lib.ptt_flow_max_clusters(csize, plan["chain_smem"],
                                     plan["mods_smem"], int(plan["mma"]),
                                     int(rows == 1), code) >= 1:
            return csize
    raise RuntimeError(f"flow_cluster: no cluster of {CLUSTERS} fits")


@cuda_lib.entry
def flow_forward(p, c, x, t_combined, out=None):
    """Same contract as flow_forward_plain, for x (latent,) or (B, latent);
    launches K6 for CUDA tensors (LAUNCHES launches for any B; float32 or
    bfloat16; supported(p); dim, hid and latent multiples of 8). out: an
    earlier call's result, written again."""
    if x.device.type == "cpu":
        return cuda_lib.into(out, flow_forward_plain(p, c, x, t_combined))
    if x.device.type != "cuda":
        raise ValueError(f"flow_forward: unsupported device {x.device}")
    if not supported(p):
        raise ValueError("flow_forward: unsupported linear layouts")
    if any(v % 8 for v in (t_combined.shape[0], x.shape[-1],
                           p["res_blocks"]["mlp_0"]["scale"].shape[-1])):
        raise ValueError("flow_forward: dim, hid and latent must be "
                         "multiples of 8")
    lanes = x.dim() == 2
    x2, c2 = x.reshape(-1, x.shape[-1]), c.reshape(-1, c.shape[-1])
    rb, fin = p["res_blocks"], p["final"]
    (b, latent), (_, dmodel), (dim,) = x2.shape, c2.shape, t_combined.shape
    depth, hid = rb["mlp_0"]["scale"].shape[0], rb["mlp_0"]["scale"].shape[-1]
    vecs = [(c2, (b, dmodel)), (t_combined, (dim,))]
    ptrs, ints = [], [latent, dmodel, dim, hid, depth, 0]

    def lin(m, k, n, layers=None):
        tensors, layout = kernel_operands(m, k, n, x, layers)
        ptrs.extend(tensors)
        ints.extend(layout)

    def norm(m, shape):
        for key in ("scale", "bias"):
            v = (m or {}).get(key)
            vecs.append((v, shape))
            ptrs.append(v)

    lin(p["input_proj"], latent, dim)
    lin(p["cond_embed"], dmodel, dim)
    norm(rb.get("in_ln"), (depth, dim))
    lin(rb["adaln"], dim, 3 * dim, depth)
    lin(rb["mlp_0"], dim, hid, depth)
    lin(rb["mlp_2"], hid, dim, depth)
    norm(fin.get("norm"), (dim,))
    lin(fin["adaln"], dim, 2 * dim)
    lin(fin["linear"], dim, latent)
    bad = [tuple(t.shape) for t, shape in vecs if t is not None
           and not (tuple(t.shape) == shape and t.dtype == x.dtype
                    and t.is_contiguous() and t.device == x.device)]
    if bad or not x.is_contiguous() or x.dtype not in (torch.float32,
                                                         torch.bfloat16):
        raise ValueError(f"flow_forward: bad operands {bad} for x"
                         f"{tuple(x.shape)} {x.dtype}")
    code = cuda_lib.dtype_code(x)
    packed, group = ints[12] != 1, ints[13]     # mlp_0's (kind, group)
    shape = (dmodel, dim, hid, latent, depth, b, x.dtype, packed, group)
    csize = flow_cluster(*shape)
    plan = flow_plan(*shape, csize)
    ints[5] = b
    ints += [plan["rb"], csize, plan["nslot"], plan["ncl"], int(plan["mma"])]
    mods = torch.empty(b * (depth * 3 * dim + 2 * dim), dtype=torch.float32,
                       device=x.device)
    given = out
    out = torch.empty_like(x2) if given is None else given.view(x2.shape)
    args = [x2, c2, t_combined] + ptrs + [mods, out]
    rc = cuda_lib.library().ptt_fused_flow(
        (ctypes.c_void_p * len(args))(*[0 if t is None else t.data_ptr()
                                        for t in args]),
        (ctypes.c_int * len(ints))(*ints), code,
        cuda_lib.stream_ptr(x.device))
    cuda_lib.check(rc, "ptt_fused_flow")
    if lanes:
        flow_forward.launches_lanes += LAUNCHES
    elif bits(rb["adaln"]) == 4:
        flow_forward.launches_int4 += LAUNCHES
    else:
        flow_forward.launches += LAUNCHES
    return out.reshape(x.shape) if given is None else given


flow_forward.launches = flow_forward.launches_int4 = 0
flow_forward.launches_lanes = 0
