"""1-D convolutions, offline and streaming (causal, stateful), TIME-MAJOR.

Counterpart of `pocket_tts_tpu/ops/conv.py`. Every function works on one
stream with x of shape (T, C), as the JAX package does, or on B streams at
once with x (B, T, C) and carries (B, ...); products accumulate in float32
and round to the input dtype at the same points as there.

Weight layouts follow the torch checkpoint:
  conv1d:           w (out_ch, in_ch, K), b (out_ch,)
  conv_transpose1d: w (in_ch, out_ch, K), b (out_ch,)
  depthwise convtr (groups == in_ch == out_ch): w (ch, 1, K)

The streaming functions return fresh carries, like the JAX ones; the
SEANet model writes them back into its state dict. With models/seanet.py
these are the plain version of kernel K3 (ops/seanet_frame.py).

Quantized convs (io/quant.py, convs=True) hold the 2-D weight the product
takes: conv1d {"qc"/"qc4", "scale"} over wf (K*Cin, Cout), transposed conv
{"qt"/"qt4", "scale"} over the j-major w2 (Cin, K*Cout) of a K == 2*stride
conv. A quantized conv1d concatenates its K strided views of x along the
features (one activation copy, contiguous) and runs ONE int8_matmul (K4a)
or int4_matmul (K4b) over every row, the lanes' rows included; a quantized
transposed conv runs one over x. Those wrappers run their plain versions
for tensors on the CPU and their kernels for tensors on the card.
"""
from __future__ import annotations

import torch


def _dot32(a, b):
    return a.float() @ b.float()


def _conv_kernel_size(p, cin: int) -> int:
    """K of a conv1d from its "w" (Cout, Cin, K) or its quantized layout
    (qc (K*Cin, Cout); qc4 packs K*Cin / 2 rows)."""
    if "w" in p:
        return p["w"].shape[-1]
    if "qc" in p:
        return p["qc"].shape[0] // cin
    return 2 * p["qc4"].shape[0] // cin


def _quant_matmul(p, x, key: str):
    """x (..., K) @ the quantized 2-D weight p[key] (int8) or p[key + "4"]
    (packed int4) with p["scale"]: one launch of K4a or K4b over all of
    x's rows, rounded to x's dtype."""
    from .quant_matmul import int4_matmul, int8_matmul
    x = x.contiguous()
    if key in p:
        return int8_matmul(x, p[key], p["scale"])
    return int4_matmul(x, p[key + "4"], p["scale"])


def _conv1d_quant(p, x, stride: int):
    """conv1d against a quantized layout: the K strided views of x side by
    side along the features ((..., Tout, K*Cin), so row t holds x_t,
    x_{t+1}, ...: wf's row order), one quantized product, then the bias."""
    k = _conv_kernel_size(p, x.shape[-1])
    tout = (x.shape[-2] - k) // stride + 1
    if k == 1 and stride == 1:
        xw = x
    else:
        xw = torch.cat([x[..., j: j + stride * (tout - 1) + 1: stride, :]
                        for j in range(k)], -1)
    y = _quant_matmul(p, xw, "qc")
    if p.get("b") is not None:
        y = y + p["b"][None, :]
    return y.to(x.dtype)


def conv1d(p, x, stride: int = 1):
    """VALID conv1d. x: (..., T, Cin) -> (..., (T-K)//stride + 1, Cout)."""
    if "qc" in p or "qc4" in p:
        return _conv1d_quant(p, x, stride)
    w = p["w"]
    cout, cin, k = w.shape
    tout = (x.shape[-2] - k) // stride + 1
    y = torch.zeros(*x.shape[:-2], tout, cout, dtype=torch.float32,
                    device=x.device)
    for j in range(k):
        y = y + _dot32(x[..., j: j + stride * (tout - 1) + 1: stride, :],
                       w[:, :, j].T)
    y = y.to(x.dtype)
    b = p.get("b")
    if b is not None:
        y = y + b[None, :]
    return y


def streaming_conv1d(p, prev, x, stride: int = 1):
    """Causal streaming conv: prepend the cached tail, conv, save the new
    tail. prev: (K - stride, Cin). Returns (new_prev, y)."""
    tp = _conv_kernel_size(p, x.shape[-1]) - stride
    xc = torch.cat([prev, x], -2) if tp > 0 else x
    new_prev = xc[..., xc.shape[-2] - tp:, :] if tp > 0 else prev
    return new_prev, conv1d(p, xc, stride)


def conv1d_init_state(in_ch: int, kernel: int, stride: int = 1,
                      dtype=torch.float32, device="cpu"):
    return torch.zeros(kernel - stride, in_ch, dtype=dtype, device=device)


def _convtr_kernel_size(p, stride: int) -> int:
    """K of a transposed conv: its "w" (Cin, Cout, K), or 2*stride for a
    quantized layout (which exists only for K == 2*stride)."""
    return p["w"].shape[-1] if "w" in p else 2 * stride


def _convtr_matmul(p, x, stride: int):
    """u = x @ w2 against the j-major flattened (Cin, K*Cout) weight, full
    or quantized (qt / qt4); returns (u (T, K*Cout) rounded to x's dtype,
    cout, k)."""
    if "w" not in p:
        k = 2 * stride
        u = _quant_matmul(p, x, "qt")
        return u, u.shape[-1] // k, k
    w = p["w"]
    cin, cout, k = w.shape
    w2 = w.permute(0, 2, 1).reshape(cin, k * cout)
    return _dot32(x, w2).to(x.dtype), cout, k


def conv_transpose1d(p, x, stride: int, include_bias: bool = True):
    """Full VALID transposed conv for K == 2*stride (every convtr of this
    model). x: (T, Cin) -> (T*stride + stride, Cout): output row i*s + j is
    u[i, j] + u[i-1, j+s]."""
    lead, t = x.shape[:-2], x.shape[-2]
    s = stride
    u, cout, k = _convtr_matmul(p, x, stride)
    if k != 2 * s:
        raise NotImplementedError("conv_transpose1d needs K == 2*stride")
    a = u[..., : s * cout].reshape(*lead, t * s, cout)
    bb = u[..., s * cout:].reshape(*lead, t * s, cout)
    z = a.new_zeros(*lead, s, cout)
    y = torch.cat([a, z], -2) + torch.cat([z, bb], -2)
    if include_bias and p.get("b") is not None:
        y = y + p["b"][None, :]
    return y


def streaming_conv_transpose1d(p, prev_y, x, stride: int):
    """Streaming transposed conv with an overlap-add carry holding the
    previous step's trailing PT = K - stride PRE-BIAS output rows.
    Returns (new_prev, out (T*stride, Cout))."""
    pt = _convtr_kernel_size(p, stride) - stride
    y = conv_transpose1d(p, x, stride, include_bias=False)
    y = torch.cat([y[..., :pt, :] + prev_y, y[..., pt:, :]], -2)
    new_prev = y[..., y.shape[-2] - pt:, :]
    if p.get("b") is not None:
        y = y + p["b"][None, :]
    return new_prev, y[..., : y.shape[-2] - pt, :]


def conv_transpose1d_init_state(out_ch: int, kernel: int, stride: int,
                                dtype=torch.float32, device="cpu"):
    return torch.zeros(kernel - stride, out_ch, dtype=dtype, device=device)


# ---------------------------------------------------------------------------
# BLOCKED-TIME ops for the narrow last stage: xb[t, j*C + c] == x[t*s + j, c]
# ---------------------------------------------------------------------------

def _blockdiag(wj, s: int):
    """(Cin, Cout) tap -> (s*Cin, s*Cout) block-diagonal (I_s kron wj)."""
    return torch.kron(torch.eye(s, dtype=wj.dtype, device=wj.device),
                      wj.contiguous())


def conv1d_blocked(p, xb, prev_row):
    """Causal streaming conv over a blocked (T, s*Cin) tensor. prev_row:
    (1, s*Cin), the previous frame's last blocked input row. Returns
    (new_prev_row, yb (T, s*Cout))."""
    w = p["w"]
    cout, cin, k = w.shape
    t, sc = xb.shape[-2:]
    sblk = sc // cin
    if sc % cin or k - 1 >= sblk:
        raise ValueError((w.shape, xb.shape))
    top = torch.cat([prev_row, xb[..., :-1, :]], -2)
    y = torch.zeros(*xb.shape[:-2], t, sblk * cout, dtype=torch.float32,
                    device=xb.device)
    for d in range(k):
        wj = w[:, :, k - 1 - d].T
        if d == 0:
            src = xb
        else:
            lanes = d * cin
            src = torch.cat([top[..., sc - lanes:], xb[..., : sc - lanes]],
                            -1)
        y = y + _dot32(src, _blockdiag(wj, sblk).to(xb.dtype))
    y = y.to(xb.dtype)
    if p.get("b") is not None:
        y = y + p["b"].repeat(sblk)[None, :]
    return xb[..., -1:, :], y


def streaming_conv_transpose1d_blocked(p, prev_row, x, stride: int):
    """Streaming K == 2*stride transposed conv emitting the BLOCKED layout.
    x: (T, Cin); prev_row: (1, s*Cout) pre-bias overlap row. Returns
    (new_prev_row, yb (T, s*Cout))."""
    s = stride
    u, cout, k = _convtr_matmul(p, x, stride)
    if k != 2 * s:
        raise NotImplementedError("blocked convtr needs K == 2*stride")
    a = u[..., : s * cout]
    bb = u[..., s * cout:]
    z = a.new_zeros(*a.shape[:-2], 1, s * cout)
    yb = torch.cat([a, z], -2) + torch.cat([z, bb], -2)
    yb = torch.cat([yb[..., :1, :] + prev_row, yb[..., 1:, :]], -2)
    new_prev = yb[..., -1:, :]
    out = yb[..., :-1, :]
    if p.get("b") is not None:
        out = out + p["b"].repeat(s)[None, :]
    return new_prev, out


def depthwise_upsample(p, x, kernel: int, stride: int):
    """Depthwise transposed conv of a T=1 input (the mimi x16 upsampler).
    x: (1, C); w: (C, 1, K). Returns the full pre-bias y: (K, C)."""
    return x * p["w"][:, 0, :].T
