"""Decode-only Mimi codec: 32-d latent -> 1920 samples of 24 kHz PCM
(Pocket TTS), or Moshi's 8 codes a frame through the split RVQ
(`decode_codes_frame`).

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
    return _decode_emb(p, cfg, state, x, gelu_approx, seanet_weights)


def decode_codes_frame(p, cfg, state: MimiState, codes,
                       seanet_weights: dict = None):
    """Moshi's Mimi: codes (B, n_q) int64, one frame of each lane ->
    (state, pcm (B, frame)). The split RVQ: the first group's codebook
    rows and the rest's each summed in float32, each group through its
    own 1x1 projection, the two added and rounded once to the working
    type (p["quantizer"]: "first" (n_semantic, bins, dim), "rest" (n_q -
    n_semantic, bins, dim), "proj_first" / "proj_rest" (dim, mimi dim));
    then the upsample, transformer and SEANet of `decode_frame`."""
    x = rvq_decode(p["quantizer"], codes).to(p["upsample"]["w"].dtype)
    return _decode_emb(p, cfg, state, x, False, seanet_weights)


def rvq_decode(q, codes):
    """The split RVQ's float32 embedding (B, mimi dim) of codes (B, n_q)."""
    nf = q["first"].shape[0]
    rows = torch.arange(codes.shape[1], device=codes.device)[None]
    first = q["first"][rows[:, :nf], codes[:, :nf]].sum(1)
    rest = q["rest"][rows[:, nf:] - nf, codes[:, nf:]].sum(1)
    return first @ q["proj_first"] + rest @ q["proj_rest"]


def clear_lanes(state: MimiState, lanes) -> None:
    """Zero the streaming carries (the upsample's and SEANet's) of the
    lanes where `lanes` (B,) bool is set, in place: those lanes' next
    frame decodes from silence, as a fresh stream's first does."""
    def clear(c):
        c.masked_fill_(lanes.view(-1, *([1] * (c.dim() - 1))), 0)

    clear(state.upsample_prev)
    for c in state.seanet.values():
        clear(c)


def _decode_emb(p, cfg, state: MimiState, x, gelu_approx: bool,
                seanet_weights: dict):
    """The frame's mimi.dim embedding x ((dim,) or (B, dim)) -> (state,
    pcm): upsample, transformer, SEANet."""
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
