"""K6: the whole int8 flow net (SimpleMLPAdaLN) in one launch.

Replaces the TPU kernel `pocket_tts_tpu/ops/fused_flow.py:_make_flow`. The
CUDA kernel is `csrc/fused_flow.cu` (its header says what bounds it on the
H100 and what the design does about it). The plain version follows the
TPU kernel's arithmetic (`fused_flow.py:_kernel`), not the unfused chain
of `linear` calls: activations stay float32 between dots, each dot's
operand is rounded to the working type, LayerNorm eps is 1e-6, the
conditioning silu(tc + cond_embed(c)) is computed once, and the output is
rounded once. Missing in_ln / final-norm affine parameters read as ones
and zeros, missing biases as zeros.

`flow_forward` runs the plain version for tensors on the CPU and the kernel
for tensors on the card; there is no other switch.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import cuda_lib
from .basic import layer_norm, silu, slice_layer_params


def supported(p) -> bool:
    """The JAX package's `fused_flow.supported` for int8 trees: the big
    flow linears are all int8; input_proj and final.linear (a few KB) may
    stay plain weights."""
    rb = p["res_blocks"]
    big = (p["cond_embed"], rb["adaln"], rb["mlp_0"], rb["mlp_2"],
           p["final"]["adaln"])
    return (all("q" in m for m in big)
            and all("q" in m or "w" in m
                    for m in (p["input_proj"], p["final"]["linear"])))


def _dot(v32, lin, dt):
    """round(v32) @ W in float32, times the scale (int8) plus the bias."""
    xb = v32.to(dt).float()
    if "q" in lin:
        y = (xb @ lin["q"].float()) * lin["scale"]
    else:
        y = xb @ lin["w"].float()
    b = lin.get("b")
    return y if b is None else y + b.float()


def _modulated_ln(h, norm, shift, scale):
    return layer_norm(norm, h, eps=1e-6) * (1.0 + scale) + shift


def flow_forward_plain(p, c, x, t_combined):
    """c (d_model,), x (latent,), t_combined (dim,) -> (latent,) in x's
    dtype."""
    dt = x.dtype
    rb = p["res_blocks"]
    sy = silu(t_combined.float() + _dot(c.float(), p["cond_embed"], dt))
    h = _dot(x.float(), p["input_proj"], dt)
    for i in range(rb["adaln"]["q"].shape[0]):
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
          code: int) -> int:
    """K6's cooperative grid: enough blocks for the widest phase (the
    modulations, 32 columns a block) but at most one per SM (every extra
    block slows each of the grid barriers) and as many as the card holds
    at once (0 when the query fails)."""
    widest = depth * -(-3 * dim // 32) + -(-2 * dim // 32)
    sms = torch.cuda.get_device_properties(
        torch.cuda.current_device()).multi_processor_count
    return min(widest, sms, cuda_lib.library().ptt_fused_flow_max_blocks(
        dmodel, dim, hid, latent, code))


def _lin_ptrs(lin, shape, x, items):
    """Pointers (w, scale or 0, bias or 0) of a linear; queues its tensors
    for the checks."""
    if "q" in lin:
        w, s = lin["q"], lin["scale"]
        items += [(w, shape, torch.int8), (s, shape[:1] + shape[-1:]
                                           if len(shape) == 3
                                           else shape[-1:], torch.float32)]
    else:
        w, s = lin["w"], None
        items.append((w, shape, x.dtype))
    b = lin.get("b")
    items.append((b, shape[:-2] + shape[-1:], x.dtype))
    return [w.data_ptr(), 0 if s is None else s.data_ptr(),
            0 if b is None else b.data_ptr()]


def flow_forward(p, c, x, t_combined):
    """Same contract as flow_forward_plain; launches K6 for CUDA tensors
    (one cooperative launch; float32 or bfloat16; supported(p))."""
    if x.device.type == "cpu":
        return flow_forward_plain(p, c, x, t_combined)
    if x.device.type != "cuda":
        raise ValueError(f"flow_forward: unsupported device {x.device}")
    rb, fin = p["res_blocks"], p["final"]
    (latent,), (dmodel,), (dim,) = x.shape, c.shape, t_combined.shape
    depth, _, hid = rb["mlp_0"]["q"].shape
    items = [(c, (dmodel,), x.dtype), (t_combined, (dim,), x.dtype)]
    ptrs = [x.data_ptr(), c.data_ptr(), t_combined.data_ptr()]
    ptrs += _lin_ptrs(p["input_proj"], (latent, dim), x, items)
    ptrs += _lin_ptrs(p["cond_embed"], (dmodel, dim), x, items)
    inln = rb.get("in_ln") or {}
    for key in ("scale", "bias"):
        v = inln.get(key)
        items.append((v, (depth, dim), x.dtype))
        ptrs.append(0 if v is None else v.data_ptr())
    ptrs += _lin_ptrs(rb["adaln"], (depth, dim, 3 * dim), x, items)
    ptrs += _lin_ptrs(rb["mlp_0"], (depth, dim, hid), x, items)
    ptrs += _lin_ptrs(rb["mlp_2"], (depth, hid, dim), x, items)
    fnorm = fin.get("norm") or {}
    for key in ("scale", "bias"):
        v = fnorm.get(key)
        items.append((v, (dim,), x.dtype))
        ptrs.append(0 if v is None else v.data_ptr())
    ptrs += _lin_ptrs(fin["adaln"], (dim, 2 * dim), x, items)
    ptrs += _lin_ptrs(fin["linear"], (dim, latent), x, items)
    bad = [tuple(t.shape) for t, shape, dtype in items if t is not None
           and not (tuple(t.shape) == shape and t.dtype == dtype
                    and t.is_contiguous() and t.device == x.device
                    and t.data_ptr() % 16 == 0)]
    if (bad or not supported(p) or not x.is_contiguous()
            or any(n % 4 for n in (latent, dim, hid))):
        raise ValueError(f"flow_forward: bad operands {bad} for x"
                         f"{tuple(x.shape)} {x.dtype}")
    lib = cuda_lib.library()
    code = cuda_lib.dtype_code(x)
    grid = _grid(dmodel, dim, hid, latent, depth, code)
    scratch = torch.empty(2 * dim + hid + depth * 3 * dim + 2 * dim,
                          dtype=torch.float32, device=x.device)
    out = torch.empty_like(x)
    ptrs += [scratch.data_ptr(), out.data_ptr()]
    dims = (ctypes.c_int * 5)(latent, dmodel, dim, hid, depth)
    rc = lib.ptt_fused_flow((ctypes.c_void_p * len(ptrs))(*ptrs), dims,
                            grid, code, cuda_lib.stream_ptr(x.device))
    cuda_lib.check(rc, "ptt_fused_flow")
    flow_forward.launches += 1
    return out


flow_forward.launches = 0
