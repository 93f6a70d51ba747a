"""Decode-only Mimi codec: 32-d latent -> 1920 samples of 24 kHz PCM.

Counterpart of `pocket_tts_tpu/models/mimi.py`:
  quantizer output projection, conv 1x1 (32 -> 512)
  x16 depthwise transposed-conv upsample (k32 s16) with its carry
  2-layer ring-KV transformer over the 16 rows (kernel K2 per layer)
  SEANet decoder (kernel K3)
The state is updated in place, each tensor in its own storage. With lanes
(continuous batching) every tensor of the state has a leading (B,) axis
(the int8 ring's scale rows too), except the transformer's shared ring
`offset`, and `decode_frame` takes latents (B, latent_dim). The
checkpoint-driven variants of the transformer's layers (RMSNorm `alpha`,
gating) run over lanes as they do solo; a cross-attention state
(mimi_transformer.init_cross) decodes solo only, and the lane entry
points refuse it.
"""
from __future__ import annotations

import dataclasses

import torch

from . import mimi_transformer, seanet
from ..ops.conv import depthwise_upsample


@dataclasses.dataclass
class MimiState:
    upsample_prev: torch.Tensor  # (upsample_kernel, dim) overlap-add carry
    transformer: mimi_transformer.MimiTransformerState
    seanet: dict


def init_state(cfg, dtype=torch.float32, device="cpu") -> MimiState:
    return MimiState(
        upsample_prev=torch.zeros(cfg.upsample_kernel, cfg.dim, dtype=dtype,
                                  device=device),
        transformer=mimi_transformer.init_state(cfg.transformer, dtype,
                                                device),
        seanet=seanet.init_state(cfg.seanet, cfg.upsample_stride, dtype,
                                 device))


def init_state_lanes(cfg, b: int, dtype=torch.float32,
                     device="cpu") -> MimiState:
    """A B-lane state of zeros: offset 0, every lane's start 0."""
    one = init_state(cfg, dtype, device)
    tr = one.transformer

    def lanes(cs):
        return None if cs is None else [c.expand(b, *c.shape).clone()
                                         for c in cs]

    return MimiState(
        upsample_prev=one.upsample_prev.expand(b, -1, -1).clone(),
        transformer=mimi_transformer.MimiTransformerState(
            k=lanes(tr.k), v=lanes(tr.v), offset=0,
            start=torch.zeros(b, dtype=torch.int32, device=device),
            k_scale=lanes(tr.k_scale), v_scale=lanes(tr.v_scale)),
        seanet={key: c.expand(b, *c.shape).clone()
                for key, c in one.seanet.items()})


def decode_frame(p, cfg, state: MimiState, latent, gelu_approx: bool = False,
                 seanet_weights: dict = None):
    """latent: (latent_dim,) de-normalized latent -> (state, pcm (frame,)),
    or with lanes (B, latent_dim) -> (state, pcm (B, frame)).
    seanet_weights: the decoder's kernel layouts
    (ops.seanet_frame.prep_weights), built once at load."""
    w = p["quantizer"]["w"][:, :, 0].float()
    x = (w @ latent.float() if latent.dim() == 1
         else latent.float() @ w.T).to(latent.dtype)
    k, s = cfg.upsample_kernel, cfg.upsample_stride
    y = depthwise_upsample(p["upsample"], x[..., None, :], k, s)  # (k, dim)
    prev = state.upsample_prev
    y = torch.cat([y[..., : k - s, :] + prev[..., s:, :],
                   y[..., k - s:, :]], -2)
    prev.copy_(y)   # in place: a frame replayed from graphs keeps addresses
    if p["upsample"].get("b") is not None:
        y = y + p["upsample"]["b"][None, :]
    emb = y[..., : k - s, :]
    _, z = mimi_transformer.forward(p["decoder_transformer"],
                                    cfg.transformer, state.transformer, emb,
                                    gelu_approx)
    _, pcm = seanet.forward(p["decoder"], cfg.seanet, state.seanet, z,
                            seanet_weights)
    return state, pcm[..., 0]
