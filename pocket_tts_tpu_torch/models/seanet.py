"""SEANet streaming decoder: latent channels -> 24 kHz PCM.

Counterpart of `pocket_tts_tpu/models/seanet.py` (the decoder):
  model_0:  streaming conv k7 s1          + ELU
  model_2:  streaming convtr k12 s6       + model_3 resnet + ELU
  model_5:  streaming convtr k10 s5       + model_6 resnet + ELU
  model_8:  streaming convtr k8 s4        + model_9 resnet + ELU
  model_11: streaming conv k3 s1 -> 1 channel
Moshi's Mimi has a fourth stage (convtr k16 s8 at model_2, the others
moved up by three) and its first conv widens 512 -> 1024 channels; the
final conv is then model_14 (`ops.seanet_frame.stage_keys`, `last_key`).
Time-major (T, C) throughout; a narrow last stage runs in the JAX package's
BLOCKED-TIME layout (T, s*C), so the carries have the same shapes in both
packages.

`forward` picks its route from the params' layout, as the JAX package's
does (`"w" in p["model_0"]`): a float decoder runs kernel K3
(ops/seanet_frame.py; its plain version, `forward_plain`, for tensors on
the CPU); a decoder whose convs are quantized (io/quant.py, convs=True)
runs the chain of `forward_plain` itself, each quantized conv one launch
of K4a or K4b over all rows (ops/conv.py) and the small float convs,
ELUs and overlap-adds as torch ops. K3 is never launched for it. State is
a dict of carries, updated IN PLACE by `forward`.

The ENCODER (`encoder_init_state`, `encoder_forward`; a checkpoint that
ships `mimi.encoder.*`) is the decoder mirrored, as the JAX package
builds it: model_0 (k7), then per reversed stage a resnet at 3i+1, ELU
and a strided conv at 3i+3 (the decoder's kernel and stride), ELU, and
the final conv at 3N+2, each a causal streaming conv (ops/conv.py). Its
quantized convs (io/quant.py convs=True: the large `block_1` / `block_3`
and the final model_{3N+2}) run one K4a or K4b launch over all rows;
the rest are plain PyTorch, as the JAX package runs them in XLA.
"""
from __future__ import annotations

import torch

from ..ops.basic import elu
from ..ops.conv import (conv1d, conv1d_blocked, conv1d_init_state,
                        conv_transpose1d_init_state, streaming_conv1d,
                        streaming_conv_transpose1d,
                        streaming_conv_transpose1d_blocked)
from ..ops.seanet_frame import last_key, seanet_frame, stage_keys


def _blocked(cfg, idx: int) -> bool:
    """Run a stage blocked when it is the last, its output channels
    underfill a 128-lane tile, and the k=3 convs' left context fits in one
    block (the JAX package's rule, kept so the carries match)."""
    st = cfg.stages[idx]
    return (idx == len(cfg.stages) - 1 and st.out_ch < 128
            and st.stride > max(cfg.resnet_kernel, cfg.last_kernel) - 1)


def init_state(cfg, t_in: int, dtype=torch.float32, device="cpu") -> dict:
    """Zeroed conv tails / overlap-add carries."""
    dd = dict(dtype=dtype, device=device)
    state = {"model_0": conv1d_init_state(cfg.in_ch, cfg.first_kernel, 1,
                                          **dd)}
    for si, (st, (name, rname)) in enumerate(zip(cfg.stages,
                                                 stage_keys(cfg))):
        if _blocked(cfg, si):
            state[name] = torch.zeros(1, st.stride * st.out_ch, **dd)
            state[rname] = torch.zeros(1, st.stride * st.out_ch, **dd)
        else:
            state[name] = conv_transpose1d_init_state(
                st.out_ch, st.kernel, st.stride, **dd)
            state[rname] = conv1d_init_state(st.out_ch, cfg.resnet_kernel,
                                             1, **dd)
    last = cfg.stages[-1]
    if _blocked(cfg, len(cfg.stages) - 1):
        state[last_key(cfg)] = torch.zeros(1, last.stride * last.out_ch,
                                           **dd)
    else:
        state[last_key(cfg)] = conv1d_init_state(last.out_ch,
                                                 cfg.last_kernel, 1, **dd)
    return state


def encoder_init_state(cfg, dtype=torch.float32, device="cpu") -> dict:
    """Zeroed causal-conv tails of the streaming encoder (the decoder's
    module indices transposed: model_0, (3i+1, 3i+3) per reversed stage,
    3N+2)."""
    dd = dict(dtype=dtype, device=device)
    n = len(cfg.stages)
    state = {"model_0": conv1d_init_state(cfg.out_ch, cfg.first_kernel, 1,
                                          **dd)}
    for gi, st in enumerate(reversed(cfg.stages)):
        state[f"model_{3 * gi + 1}"] = conv1d_init_state(
            st.out_ch, cfg.resnet_kernel, 1, **dd)
        state[f"model_{3 * gi + 3}"] = conv1d_init_state(
            st.out_ch, st.kernel, st.stride, **dd)
    state[f"model_{3 * n + 2}"] = conv1d_init_state(
        cfg.stages[0].in_ch, cfg.last_kernel, 1, **dd)
    return state


def encoder_forward(p, cfg, state: dict, x):
    """Streaming encode: pcm x (T, out_ch) -> (state, latents
    (T // total_stride, in_ch)), the carries updated IN PLACE. T must be
    a multiple of cfg.total_stride (1920 samples: 16 latent steps at full
    width)."""
    if x.shape[-2] % cfg.total_stride:
        raise ValueError(f"encoder_forward: {x.shape[-2]} samples is not a "
                         f"multiple of {cfg.total_stride}")
    new = {}
    new["model_0"], x = streaming_conv1d(p["model_0"], state["model_0"], x,
                                         stride=1)
    n = len(cfg.stages)
    for gi, st in enumerate(reversed(cfg.stages)):
        ri, ci = f"model_{3 * gi + 1}", f"model_{3 * gi + 3}"
        new[ri], x = _resnet(p[ri], state[ri], x)
        new[ci], x = streaming_conv1d(p[ci], state[ci], elu(x),
                                      stride=st.stride)
    fi = f"model_{3 * n + 2}"
    new[fi], x = streaming_conv1d(p[fi], state[fi], elu(x), stride=1)
    for key in state:
        state[key] = new[key]
    return state, x


def _resnet(p, prev, x):
    """x + conv1x1(elu(conv_k(elu(x))))."""
    v = elu(x)
    prev, v = streaming_conv1d(p["block_1"], prev, v, stride=1)
    v = elu(v)
    v = conv1d(p["block_3"], v, stride=1)
    return prev, x + v


def _resnet_blocked(p, prev, xb):
    v = elu(xb)
    prev, v = conv1d_blocked(p["block_1"], v, prev)
    v = elu(v)
    _, v = conv1d_blocked(p["block_3"], v, v[..., -1:, :] * 0)
    return prev, xb + v


def forward_plain(p, cfg, state: dict, x):
    """The plain chain (K3's plain version). x: (T, in_ch) -> (new_state,
    pcm (T * total_stride, out_ch)), or with a lane axis x (B, T, in_ch)
    and carries (B, ...) -> pcm (B, T * total_stride, out_ch); `state` is
    not modified."""
    new_state = {}
    new_state["model_0"], x = streaming_conv1d(
        p["model_0"], state["model_0"], x, stride=1)
    x = elu(x)
    blocked = False
    last = last_key(cfg)
    for si, (st, (name, rname)) in enumerate(zip(cfg.stages,
                                                 stage_keys(cfg))):
        if _blocked(cfg, si):
            blocked = True
            new_state[name], x = streaming_conv_transpose1d_blocked(
                p[name], state[name], x, st.stride)
            new_state[rname], x = _resnet_blocked(p[rname], state[rname], x)
        else:
            new_state[name], x = streaming_conv_transpose1d(
                p[name], state[name], x, stride=st.stride)
            new_state[rname], x = _resnet(p[rname], state[rname], x)
        x = elu(x)
    if blocked:
        new_state[last], yb = conv1d_blocked(p[last], x, state[last])
        return new_state, yb.reshape(*yb.shape[:-2], -1, cfg.out_ch)
    new_state[last], x = streaming_conv1d(p[last], state[last], x, stride=1)
    return new_state, x


def quantized(p) -> bool:
    """True when the decoder's convs are quantized: the route without K3
    (the JAX package's condition, `"w" not in p["model_0"]`)."""
    return "w" not in p["model_0"]


def forward(p, cfg, state: dict, x, weights: dict = None):
    """x: (T, in_ch) -> (state, pcm (T * total_stride, out_ch)), the
    carries updated in place; with a lane axis x (B, T, in_ch), carries
    (B, ...) and pcm (B, T * total_stride, out_ch). weights:
    `ops.seanet_frame.prep_weights(p, cfg)` of a float decoder, built once
    at load for the card (None with quantized convs)."""
    if not quantized(p):
        return state, seanet_frame(p, cfg, state, x, weights)
    new, pcm = forward_plain(p, cfg, state, x)
    for key in state:
        state[key].copy_(new[key])
    return state, pcm
