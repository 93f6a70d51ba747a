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

Lanes: c (B, d_model) and x (B, latent) give (B, latent), the JAX
package's vmap rule (`fused_flow.py:202-211`): all B rows in one launch
(up to ROWS; more run as successive launches of ROWS rows), so each weight
tile is read once for all of them. The plain version takes either shape.

`flow_forward` runs the plain version for tensors on the CPU and the kernel
for tensors on the card; there is no other switch. Solo launches (1-D x)
whose big linears are int8 count in `flow_forward.launches`, int4 in
`flow_forward.launches_int4`; launches over lanes (2-D x) in
`flow_forward.launches_lanes`.
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


# rows one K6 launch holds in shared memory (32 x the widest activation,
# d_model = 1024 floats, at full width)
ROWS = 32


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


@functools.lru_cache(maxsize=None)
def _grid(dmodel: int, dim: int, hid: int, latent: int, depth: int,
          rows: int, code: int) -> int:
    """K6's cooperative grid: enough blocks for the widest phase (the
    modulations, 32 columns a block) but at most one per SM (every extra
    block slows each of the grid barriers) and as many as the card holds
    at once with `rows` rows in shared memory (0 when the query fails)."""
    widest = depth * -(-3 * dim // 32) + -(-2 * dim // 32)
    sms = torch.cuda.get_device_properties(
        torch.cuda.current_device()).multi_processor_count
    return min(widest, sms, cuda_lib.library().ptt_fused_flow_max_blocks(
        dmodel, dim, hid, latent, rows, code))


def flow_forward(p, c, x, t_combined):
    """Same contract as flow_forward_plain, for x (latent,) or (B, latent);
    launches K6 for CUDA tensors (one cooperative launch per ROWS rows;
    float32 or bfloat16; supported(p))."""
    if x.device.type == "cpu":
        return flow_forward_plain(p, c, x, t_combined)
    if x.device.type != "cuda":
        raise ValueError(f"flow_forward: unsupported device {x.device}")
    if not supported(p):
        raise ValueError("flow_forward: unsupported linear layouts")
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
    rows = min(b, ROWS)
    grid = _grid(dmodel, dim, hid, latent, depth, rows, code)
    scratch = torch.empty(rows * (2 * dim + hid + depth * 3 * dim + 2 * dim),
                          dtype=torch.float32, device=x.device)
    out = torch.empty_like(x2)
    lib, stream = cuda_lib.library(), cuda_lib.stream_ptr(x.device)
    for r0 in range(0, b, rows):
        n = min(rows, b - r0)
        ints[5] = n
        args = [x2[r0:r0 + n], c2[r0:r0 + n], t_combined] + ptrs + [
            scratch, out[r0:r0 + n]]
        rc = lib.ptt_fused_flow(
            (ctypes.c_void_p * len(args))(*[0 if t is None else t.data_ptr()
                                            for t in args]),
            (ctypes.c_int * len(ints))(*ints), grid, code, stream)
        cuda_lib.check(rc, "ptt_fused_flow")
        if lanes:
            flow_forward.launches_lanes += 1
        elif bits(rb["adaln"]) == 4:
            flow_forward.launches_int4 += 1
        else:
            flow_forward.launches += 1
    return out.reshape(x.shape)


flow_forward.launches = flow_forward.launches_int4 = 0
flow_forward.launches_lanes = 0
