"""K3: the whole SEANet decoder for one frame.

Replaces the TPU kernel `pocket_tts_tpu/ops/pallas_seanet.py:
seanet_frame`. On the card, `seanet_frame` launches a fixed sequence of
hand-written kernels from `csrc/seanet_frame.cu` (its header says what
bounds the decoder on the H100 and what the design does about it): per
frame one fused conv-GEMM per convolution (plus a split-K epilogue where
the tile grid is small), one overlap-add per transposed conv and one carry
update per causal conv, 22 launches at the default sizes. The plain
version is the `models/seanet.py` chain (`forward_plain`).

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

import torch

from . import cuda_lib

STAGES = (("model_2", "model_3"), ("model_5", "model_6"),
          ("model_8", "model_9"))
CARRY_KEYS = ("model_0", "model_2", "model_3", "model_5", "model_6",
              "model_8", "model_9", "model_11")


def kernel_ok(cfg) -> bool:
    """The decoder shape the kernels cover: three K == 2*stride stages."""
    return (len(cfg.stages) == 3
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


# conv-GEMM tiling (csrc/seanet_frame.cu: BM, BN, BK)
_BM, _BN, _BK = 16, 32, 32


def split_k(m: int, n: int, k: int, target_blocks: int = 128) -> int:
    """Reduction slices for one conv-GEMM: enough blocks to reach about
    target_blocks, with at least 4 K-tiles per slice."""
    blocks = -(-m // _BM) * -(-n // _BN)
    ktiles = -(-k // _BK)
    return max(1, min(target_blocks // blocks, ktiles // 4))


def _ptr(t):
    return 0 if t is None else t.data_ptr()


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
    for key in CARRY_KEYS:
        c = state[key]
        if c.dtype != x.dtype or not c.is_contiguous() \
                or c.device != x.device:
            raise ValueError(f"seanet_frame: bad carry {key}")
    lanes = x.dim() == 3
    nb = x.shape[0] if lanes else 1
    for key in CARRY_KEYS:
        if lanes and state[key].shape[0] != nb:
            raise ValueError(f"seanet_frame: carry {key} has no lane axis "
                             f"of {nb}")
    lib = cuda_lib.library()
    dt = cuda_lib.dtype_code(x)
    stream = cuda_lib.stream_ptr(x.device)
    x = x.reshape(-1, x.shape[-1]).contiguous()   # (B*T, in_ch)

    def conv(src, carry, w, b, cout, kw, in_elu=0, out_elu=0, res=None,
             res_elu=0):
        m, cin = src.shape
        pc = 0 if carry is None else carry.numel() // (nb * cin)
        splits = split_k(m, cout, kw * cin)
        y = torch.empty(m, cout, dtype=src.dtype, device=src.device)
        ws = (torch.empty(splits, m, cout, dtype=torch.float32,
                          device=src.device) if splits > 1 else None)
        rc = lib.ptt_conv_gemm(
            src.data_ptr(), _ptr(carry), w.data_ptr(), _ptr(b), _ptr(res),
            y.data_ptr(), _ptr(ws), nb, m // nb, cin, cout, kw, pc, splits,
            in_elu, out_elu, res_elu, dt, stream)
        cuda_lib.check(rc, "ptt_conv_gemm")
        return y

    def carry_tail(src, carry, use_elu):
        m, c = src.shape
        rc = lib.ptt_carry_tail(src.data_ptr(), carry.data_ptr(), nb,
                                m // nb, c, carry.numel() // (nb * c),
                                use_elu, dt, stream)
        cuda_lib.check(rc, "ptt_carry_tail")

    w0, b0 = weights["model_0"]
    h = conv(x, state["model_0"], w0, b0, w0.shape[1], cfg.first_kernel,
             out_elu=1)
    carry_tail(x, state["model_0"], 0)
    for st, (tr, rn) in zip(cfg.stages, STAGES):
        m, s, cout = h.shape[0], st.stride, st.out_ch
        w2, b2 = weights[tr]
        u = conv(h, None, w2, None, w2.shape[1], 1)
        y = torch.empty(m * s, cout, dtype=h.dtype, device=h.device)
        rc = lib.ptt_convtr_overlap(u.data_ptr(), state[tr].data_ptr(),
                                    _ptr(b2), y.data_ptr(), nb, m // nb, s,
                                    cout, dt, stream)
        cuda_lib.check(rc, "ptt_convtr_overlap")
        wr, br, wc, bc = weights[rn]
        v = conv(y, state[rn], wr, br, wr.shape[1], cfg.resnet_kernel,
                 in_elu=1, out_elu=1)
        carry_tail(y, state[rn], 1)
        h = conv(v, None, wc, bc, cout, 1, res=y, res_elu=1)
    w11, b11 = weights["model_11"]
    pcm = conv(h, state["model_11"], w11, b11, cfg.out_ch, cfg.last_kernel)
    carry_tail(h, state["model_11"], 0)
    seanet_frame.launches += 1
    return pcm.reshape(nb, -1, cfg.out_ch) if lanes else pcm


seanet_frame.launches = 0
