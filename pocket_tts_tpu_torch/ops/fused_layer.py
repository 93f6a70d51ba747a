"""K5a and K5b: a transformer layer's quantized linears fused around
attention.

Replaces the TPU kernels `pocket_tts_tpu/ops/fused_layer.py:_pre_call`
(K5a: norm1 + in_proj) and `_post_call` (K5b: out_proj + residual + norm2
+ MLP + residual), for int8 and for int4 weights with per-channel or
K-grouped (q4_0) scales (io/quant.py). The CUDA kernels are in
`csrc/fused_layer.cu` (its header says what bounds them on the H100 and
what the design does about it). The plain versions here round where the
kernels round, which is not where the unfused chain of `linear` calls
rounds:

  K5a  qkv = round(round(LN(x)) @ W_in + b_in)
  K5b  x1  = x + ls1 * (attn @ W_o + b_o)             kept in float32
       ln  = round(LN(x1))
       h   = round(gelu(ln @ W_1 + b_1))             computed in float32
       out = round(x1 + ls2 * (h @ W_2 + b_2))

where "v @ W" is the float32 product with the weight's scales
(quant_matmul.deq_dot: per-channel scales on the product, grouped scales
on the weight). Absent biases read as zeros, absent layer scales as ones.
The backbone calls them at T = 1 with eps 1e-5, the mimi decoder
transformer at T = 16 with eps = cfg.norm_eps (0) and its two layer
scales.

`pre_attention` and `post_attention` run the plain version for tensors on
the CPU and the kernel for tensors on the card; there is no other switch.
Launches with int8 weights count in `.launches`, with int4 weights (either
scale layout) in `.launches_int4`.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import cuda_lib
from .basic import gelu, layer_norm
from .quant_matmul import bits, deq_dot, kernel_operands

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


def post_attention_plain(p, x, attn, eps: float = 1e-5,
                         approx: bool = False):
    """x, attn (T, dm) -> (T, dm) in x's dtype."""
    ls1 = p.get("layer_scale_1", {}).get("scale")
    ls2 = p.get("layer_scale_2", {}).get("scale")
    proj = _deq(attn, p["out_proj"])
    x1 = x.float() + (proj if ls1 is None else ls1.float() * proj)
    ln = layer_norm(p["norm2"], x1, eps=eps).to(x.dtype)
    h = gelu(_deq(ln, p["linear1"]), approx).to(x.dtype)
    up = _deq(h, p["linear2"])
    return (x1 + (up if ls2 is None else ls2.float() * up)).to(x.dtype)


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


def _count(fn, p):
    if bits(p["in_proj"]) == 4:
        fn.launches_int4 += 1
    else:
        fn.launches += 1


@functools.lru_cache(maxsize=None)
def _post_grid(t: int, dm: int, hid: int, code: int) -> int:
    """K5b's cooperative grid: one block per 32-unit hidden tile (32 W2
    rows of int8, 16 packed rows of int4), at most as many as the card
    holds at once (0 when the query fails)."""
    return min(-(-hid // 32),
               cuda_lib.library().ptt_fused_post_max_blocks(t, dm, code))


def pre_attention(p, x, eps: float = 1e-5):
    """Same contract as pre_attention_plain; launches K5a for CUDA
    tensors (x float32 or bfloat16, supported(p))."""
    if x.device.type == "cpu":
        return pre_attention_plain(p, x, eps)
    if x.device.type != "cuda":
        raise ValueError(f"pre_attention: unsupported device {x.device}")
    t, dm = x.shape
    norm = p["norm1"]
    _check("pre_attention", p, x,
           [(norm.get("scale"), dm), (norm.get("bias"), dm)])
    n = p["in_proj"]["scale"].shape[-1]
    (w, s, b), (kind, group) = kernel_operands(p["in_proj"], dm, n, x)
    if t * dm > 16384:
        raise ValueError(f"pre_attention: {t} rows of {dm} exceed the "
                         "kernel's shared-memory row buffer")
    out = torch.empty(t, n, dtype=x.dtype, device=x.device)
    rc = cuda_lib.library().ptt_fused_pre(
        x.data_ptr(), _ptr(norm.get("scale")), _ptr(norm.get("bias")),
        w.data_ptr(), _ptr(s), _ptr(b), out.data_ptr(), t, dm, n, kind,
        group, float(eps), cuda_lib.dtype_code(x),
        cuda_lib.stream_ptr(x.device))
    cuda_lib.check(rc, "ptt_fused_pre")
    _count(pre_attention, p)
    return out


def post_attention(p, x, attn, eps: float = 1e-5, approx: bool = False):
    """Same contract as post_attention_plain; launches K5b for CUDA
    tensors (one cooperative launch; x, attn float32 or bfloat16,
    supported(p))."""
    if x.device.type == "cpu":
        return post_attention_plain(p, x, attn, eps, approx)
    if x.device.type != "cuda":
        raise ValueError(f"post_attention: unsupported device {x.device}")
    t, dm = x.shape
    n2 = p["norm2"]
    ls1 = p.get("layer_scale_1", {}).get("scale")
    ls2 = p.get("layer_scale_2", {}).get("scale")
    _check("post_attention", p, x,
           [(ls1, dm), (ls2, dm), (n2.get("scale"), dm),
            (n2.get("bias"), dm)])
    hid = p["linear1"]["scale"].shape[-1]
    ptrs, ints = [x, attn, ls1, ls2, n2.get("scale"), n2.get("bias")], []
    for name, k, n in (("out_proj", dm, dm), ("linear1", dm, hid),
                       ("linear2", hid, dm)):
        tensors, layout = kernel_operands(p[name], k, n, x)
        ptrs += tensors
        ints += layout
    if not (attn.shape == x.shape and attn.dtype == x.dtype
            and attn.is_contiguous() and attn.device == x.device
            and t * dm <= 16384):
        raise ValueError(f"post_attention: bad attn{tuple(attn.shape)} for "
                         f"x{tuple(x.shape)}")
    code = cuda_lib.dtype_code(x)
    grid = _post_grid(t, dm, hid, code)
    x1 = torch.empty(t, dm, dtype=torch.float32, device=x.device)
    part = torch.empty(grid, t, dm, dtype=torch.float32, device=x.device)
    out = torch.empty_like(x)
    ptrs += [x1, part, out]
    rc = cuda_lib.library().ptt_fused_post(
        (ctypes.c_void_p * len(ptrs))(*[_ptr(v) for v in ptrs]),
        (ctypes.c_int * len(ints))(*ints), t, dm, hid, float(eps),
        int(approx), grid, code, cuda_lib.stream_ptr(x.device))
    cuda_lib.check(rc, "ptt_fused_post")
    _count(post_attention, p)
    return out


pre_attention.launches = pre_attention.launches_int4 = 0
post_attention.launches = post_attention.launches_int4 = 0
