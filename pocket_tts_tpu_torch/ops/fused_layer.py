"""K5a and K5b: a transformer layer's int8 linears fused around attention.

Replaces the TPU kernels `pocket_tts_tpu/ops/fused_layer.py:_pre_call`
(K5a: norm1 + in_proj) and `_post_call` (K5b: out_proj + residual + norm2
+ MLP + residual). The CUDA kernels are in `csrc/fused_layer.cu` (its
header says what bounds them on the H100 and what the design does about
it). The plain versions here round where the kernels round, which is not
where the unfused chain of `linear` calls rounds:

  K5a  qkv = round(round(LN(x)) @ q_in * s_in + b_in)
  K5b  x1  = x + ls1 * (attn @ q_o * s_o + b_o)        kept in float32
       ln  = round(LN(x1))
       h   = round(gelu(ln @ q_1 * s_1 + b_1))        computed in float32
       out = round(x1 + ls2 * ((h @ q_2) * s_2 + b_2))

Absent biases read as zeros, absent layer scales as ones. The backbone
calls them at T = 1 with eps 1e-5, the mimi decoder transformer at T = 16
with eps = cfg.norm_eps (0) and its two layer scales.

`pre_attention` and `post_attention` run the plain version for tensors on
the CPU and the kernel for tensors on the card; there is no other switch.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import cuda_lib
from .basic import gelu, layer_norm

_LINEARS = ("in_proj", "out_proj", "linear1", "linear2")


def supported(p) -> bool:
    """True when every linear of the layer is int8 (the JAX package's
    `fused_layer.supported` for int8 trees): plain weights take the unfused
    route, as do layers with cross-attention or RMSNorm ("alpha") norms."""
    if "cross_attention" in p:
        return False
    if "alpha" in p.get("norm1", {}) or "alpha" in p.get("norm2", {}):
        return False
    return all("q" in p[k] for k in _LINEARS)


def _deq(x, lin):
    """float32 (x @ q) * scale + b: the kernels' dot with its epilogue."""
    y = (x.float() @ lin["q"].float()) * lin["scale"]
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
    lin2 = p["linear2"]
    up = (h.float() @ lin2["q"].float()) * lin2["scale"]
    if lin2.get("b") is not None:
        up = up + lin2["b"].float()
    return (x1 + (up if ls2 is None else ls2.float() * up)).to(x.dtype)


def _ptr(t):
    return 0 if t is None else t.data_ptr()


def _check(name, x, vecs, mats):
    """Device, dtype, shape and contiguity checks of a CUDA call. vecs:
    optional working-type vectors and their lengths; mats: (q, scale,
    (K, N)) of each int8 linear."""
    ok = x.is_contiguous() and x.dtype in (torch.float32, torch.bfloat16)
    for v, n in vecs:
        ok = ok and (v is None or (v.shape == (n,) and v.dtype == x.dtype
                                   and v.is_contiguous()
                                   and v.device == x.device))
    for q, s, shape in mats:
        ok = ok and (q.shape == shape and q.dtype == torch.int8
                     and q.is_contiguous() and q.device == x.device
                     and s.shape == shape[1:] and s.dtype == torch.float32
                     and s.is_contiguous() and s.device == x.device
                     and q.data_ptr() % 4 == 0 and shape[1] % 4 == 0)
    if not ok:
        raise ValueError(f"{name}: bad operands x{tuple(x.shape)} {x.dtype}")


@functools.lru_cache(maxsize=None)
def _post_grid(t: int, dm: int, hid: int, code: int) -> int:
    """K5b's cooperative grid: one block per 32-wide hidden tile, at most
    as many as the card holds at once (0 when the query fails)."""
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
    lin, norm = p["in_proj"], p["norm1"]
    n = lin["q"].shape[1]
    _check("pre_attention", x,
           [(norm.get("scale"), dm), (norm.get("bias"), dm),
            (lin.get("b"), n)], [(lin["q"], lin["scale"], (dm, n))])
    if t * dm > 16384:
        raise ValueError(f"pre_attention: {t} rows of {dm} exceed the "
                         "kernel's shared-memory row buffer")
    out = torch.empty(t, n, dtype=x.dtype, device=x.device)
    rc = cuda_lib.library().ptt_fused_pre(
        x.data_ptr(), _ptr(norm.get("scale")), _ptr(norm.get("bias")),
        lin["q"].data_ptr(), lin["scale"].data_ptr(), _ptr(lin.get("b")),
        out.data_ptr(), t, dm, n, float(eps), cuda_lib.dtype_code(x),
        cuda_lib.stream_ptr(x.device))
    cuda_lib.check(rc, "ptt_fused_pre")
    pre_attention.launches += 1
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
    lo, l1, l2, n2 = (p["out_proj"], p["linear1"], p["linear2"], p["norm2"])
    hid = l1["q"].shape[1]
    ls1 = p.get("layer_scale_1", {}).get("scale")
    ls2 = p.get("layer_scale_2", {}).get("scale")
    _check("post_attention", x,
           [(lo.get("b"), dm), (ls1, dm), (ls2, dm), (n2.get("scale"), dm),
            (n2.get("bias"), dm), (l1.get("b"), hid), (l2.get("b"), dm)],
           [(lo["q"], lo["scale"], (dm, dm)), (l1["q"], l1["scale"],
                                                (dm, hid)),
            (l2["q"], l2["scale"], (hid, dm))])
    if not (attn.shape == x.shape and attn.dtype == x.dtype
            and attn.is_contiguous() and attn.device == x.device
            and t * dm <= 16384):
        raise ValueError(f"post_attention: bad attn{tuple(attn.shape)} for "
                         f"x{tuple(x.shape)}")
    lib = cuda_lib.library()
    code = cuda_lib.dtype_code(x)
    grid = _post_grid(t, dm, hid, code)
    x1 = torch.empty(t, dm, dtype=torch.float32, device=x.device)
    part = torch.empty(grid, t, dm, dtype=torch.float32, device=x.device)
    out = torch.empty_like(x)
    ptrs = (ctypes.c_void_p * 18)(*[_ptr(v) for v in (
        x, attn, lo["q"], lo["scale"], lo.get("b"), ls1, ls2,
        n2.get("scale"), n2.get("bias"), l1["q"], l1["scale"], l1.get("b"),
        l2["q"], l2["scale"], l2.get("b"), x1, part, out)])
    rc = lib.ptt_fused_post(ptrs, t, dm, hid, float(eps), int(approx),
                            grid, code, cuda_lib.stream_ptr(x.device))
    cuda_lib.check(rc, "ptt_fused_post")
    post_attention.launches += 1
    return out


pre_attention.launches = 0
post_attention.launches = 0
