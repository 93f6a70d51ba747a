"""Top-level TTS model: prefill, per-frame step, sentence decode.

Counterpart of `pocket_tts_tpu/models/tts.py`. The JAX package compiles a
frame into one program and scans it on the device; here the solo frame
(`frame_step`) is a host loop over eager PyTorch ops and kernels, and its
EOS decision is read on the host once per frame (one device sync per
frame). Noise is an argument of `frame_step`: the caller draws it (the
engine from a seeded torch.Generator on the device; tests inject the JAX
package's noise).

Lanes (continuous batching): `BatchedStreamState` holds B streams, and
`frame_step_lanes` follows the JAX `frame_step` under vmap: every lane is
computed unconditionally (a finished lane runs on garbage and its frame is
masked, so the shared slot cursor stays uniform), and eos_step, step and
done are updated on the device, in place, with no host read: the caller
reads pcm, valid and done when it chooses (the servers once per chunk).
A lane batch in ring mode on one CUDA card runs its frames from CUDA
graphs (models/frame_graph.py): the PyTorch ops between the hand-written
kernels are captured at the batch's first frame and replayed after it,
each kernel still launched by a call to its entry; elsewhere (a linear
cursor, a mesh, the CPU) the same frame function runs eagerly.

`init_stream_state` and the fixed-length `decode_sentence` are the JAX
package's names; the engine decodes with `decode_sentence_early_exit`.
"""
from __future__ import annotations

import dataclasses

import torch

from . import backbone, flow_lm, frame_graph, mimi, mimi_transformer


@dataclasses.dataclass
class StreamState:
    """Everything carried across frames for one stream."""
    flow: backbone.BackboneState
    mimi: mimi.MimiState
    prev_latent: torch.Tensor  # (latent,) backbone input for the next step
    eos_step: int = -1         # frame at which EOS fired, -1 until then
    step: int = 0              # frames generated this sentence
    done: bool = False


def init_stream_state(p, cfg, dtype=torch.float32, device=None
                      ) -> StreamState:
    """An empty stream: empty backbone cache and mimi state, bos_emb as the
    first latent. device: the params' when None."""
    device = p["bos_emb"].device if device is None else device
    return StreamState(
        flow=backbone.init_state(cfg.backbone, dtype, device),
        mimi=mimi.init_state(cfg.mimi, dtype, device),
        prev_latent=p["bos_emb"].to(device=device, dtype=dtype))


def prime_voice(p, cfg, flow_state, prompt, n_valid: int):
    """Run the voice prompt rows (Tp, d_model), padded, through the
    backbone once; the KV is the reusable per-voice prefix."""
    return flow_lm.prefill(p, cfg, flow_state, prompt, n_valid)


def sentence_prefill(p, cfg, voice_state: backbone.BackboneState, tokens,
                     n_valid: int, mimi_cond=None) -> StreamState:
    """Start a sentence from a COPY of the voice prefix (`shrink_state` it
    first: the prefill writes in place), with fresh mimi state.
    tokens: (Tt,) int padded; n_valid real tokens. A voice prefix with
    cross-attention KV (backbone.init_cross before prime_voice) is used
    as it is, and is written in place; mimi_cond (S_c, mimi d_model), when
    given, fills the mimi transformer's cross-attention KV
    (mimi_transformer.init_cross). frame_step then decodes the stream
    unchanged."""
    emb = flow_lm.embed_tokens(p, tokens)
    flow_state = flow_lm.prefill(p, cfg, voice_state, emb, n_valid)
    mstate = mimi.init_state(cfg.mimi, emb.dtype, emb.device)
    if mimi_cond is not None:
        mimi_transformer.init_cross(p["mimi"]["decoder_transformer"],
                                    cfg.mimi.transformer, mstate.transformer,
                                    mimi_cond)
    return StreamState(flow=flow_state, mimi=mstate,
                       prev_latent=p["bos_emb"].to(emb.dtype))


def frame_step(p, cfg, state: StreamState, noise, frames_after_eos: int,
               max_steps: int, seanet_weights: dict = None):
    """Generate one frame in place. Returns (pcm (frame_size,) float32 on
    the device, valid).

    EOS protocol (the JAX package's): the backbone runs first; if this step
    fires EOS for the first time, eos_step is recorded; the frame is NOT
    emitted once step >= eos_step + frames_after_eos or step >= max_steps.
    When the KV slot budget runs out, the current frame is still emitted
    and later frames stop. A stream already done emits nothing and computes
    nothing (the JAX step computes a masked frame there).
    """
    if state.done:
        return torch.zeros(cfg.mimi.frame_size,
                           device=state.prev_latent.device), False
    _, latent, is_eos = flow_lm.decode_step(p, cfg, state.flow,
                                            state.prev_latent, noise)
    if state.eos_step < 0 and bool(is_eos):
        state.eos_step = state.step
    stop = ((state.eos_step >= 0
             and state.step >= state.eos_step + frames_after_eos)
            or state.step >= max_steps)
    capacity = state.flow.k[0].shape[0]
    _, pcm = mimi.decode_frame(p["mimi"], cfg.mimi, state.mimi,
                               flow_lm.denormalize(p, latent),
                               cfg.gelu_approx, seanet_weights)
    state.prev_latent = latent
    state.step += 1
    state.done = stop or state.flow.end >= capacity
    pcm = pcm.float()
    return (pcm * 0.0 if stop else pcm), not stop


def decode_sentence(p, cfg, state: StreamState, noise_fn,
                    frames_after_eos: int, max_steps: int, scan_len: int,
                    seanet_weights: dict = None):
    """Exactly scan_len frames (the JAX package's fixed-length scan): frame
    i takes noise_fn(i). Returns (state, pcm (scan_len, frame_size)
    float32, valid (scan_len,) bool), both on the device: frames after the
    stop are zeros with valid False. The JAX scan steps a finished stream
    on in the background; here a done stream computes nothing (frame_step),
    so its state stays where the stream stopped."""
    pcms, valids = [], []
    for i in range(scan_len):
        pcm, valid = frame_step(p, cfg, state, noise_fn(i), frames_after_eos,
                                max_steps, seanet_weights)
        pcms.append(pcm)
        valids.append(valid)
    dev = state.prev_latent.device
    if not pcms:
        return (state, torch.zeros(0, cfg.mimi.frame_size, device=dev),
                torch.zeros(0, dtype=torch.bool, device=dev))
    return state, torch.stack(pcms), torch.tensor(valids, device=dev)


def decode_sentence_early_exit(p, cfg, state: StreamState, noise_fn,
                               frames_after_eos: int, max_steps: int,
                               scan_len: int, seanet_weights: dict = None):
    """Step until the stream is done or scan_len frames ran. noise_fn(i)
    gives frame i's noise. Returns the emitted frames' pcm, (n, frame)."""
    frames = []
    for i in range(scan_len):
        if state.done:
            break
        pcm, valid = frame_step(p, cfg, state, noise_fn(i),
                                frames_after_eos, max_steps, seanet_weights)
        if valid:
            frames.append(pcm)
    if not frames:
        return torch.zeros(0, cfg.mimi.frame_size,
                           device=state.prev_latent.device)
    return torch.stack(frames)


# ---------------------------------------------------------------------------
# lanes (continuous batching)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class BatchedStreamState:
    """B streams decoding together; every field has a leading lane axis
    except the shared cursors inside `flow` (end, ring_start) and `mimi`
    (the ring offset)."""
    flow: backbone.BatchedBackboneState
    mimi: mimi.MimiState
    prev_latent: torch.Tensor  # (B, latent)
    eos_step: torch.Tensor     # (B,) int32, -1 until EOS fired
    step: torch.Tensor         # (B,) int32 frames generated
    done: torch.Tensor         # (B,) bool
    # the frame's CUDA graphs (frame_graph.FrameGraphs), made at the first
    # frame that takes them
    graphs: object = dataclasses.field(default=None, repr=False,
                                       compare=False)

    @property
    def lanes(self) -> int:
        return self.step.shape[0]


def sentence_prefill_lanes(p, cfg, voice_states, tokens, n_valid
                           ) -> BatchedStreamState:
    """Start B sentences. voice_states: a BatchedBackboneState holding each
    lane's voice prefix, WRITTEN IN PLACE (pass a copy); tokens (B, Tt)
    padded, n_valid (B,) int tensor. The mimi states start at zero."""
    emb = flow_lm.embed_tokens(p, tokens)
    flow = flow_lm.prefill_lanes(p, cfg, voice_states, emb, n_valid)
    b, dev = tokens.shape[0], emb.device
    return BatchedStreamState(
        flow=flow, mimi=mimi.init_state_lanes(cfg.mimi, b, emb.dtype, dev),
        prev_latent=p["bos_emb"].to(emb.dtype).expand(b, -1).clone(),
        eos_step=torch.full((b,), -1, dtype=torch.int32, device=dev),
        step=torch.zeros(b, dtype=torch.int32, device=dev),
        done=torch.zeros(b, dtype=torch.bool, device=dev))


def frame_step_lanes(p, cfg, state: BatchedStreamState, noise,
                     frames_after_eos, max_steps, seanet_weights: dict = None):
    """One frame of every lane, in place. noise (B, latent); frames_after_eos
    and max_steps (B,) int tensors. Returns (pcm (B, frame_size) float32,
    valid (B,) bool), both on the device. The EOS protocol is frame_step's;
    a lane done before this step emits nothing but is still computed. On a
    mesh the ranks of a "model" group read the same EOS: the hidden state
    after each all-reduce (or whole product on a gathered input) is the
    same bits on all of them, and what
    follows runs whole on each (tests/test_torch_sharding.py and
    chip_smoke.py phase 11 hold the ranks' audio equal bit for bit).

    The frame runs from CUDA graphs when the batch is in ring mode on one
    CUDA card (`frame_graph.graphable`), or when `state.graphs` holds a
    FrameGraphs already (the CPU tests' stand-in); otherwise eagerly. How
    it ran: `frame_mode(state)`; the captures, replays and graph segments
    a frame count in `frame_graph.run_frame`'s attributes."""
    graphs = state.graphs
    if graphs is None and frame_graph.graphable(cfg, state):
        graphs = state.graphs = frame_graph.FrameGraphs()
    if graphs is None:
        return _frame_lanes(p, cfg, state, noise, frames_after_eos,
                            max_steps, seanet_weights)
    frame_graph.attach_cursors(state)
    inputs = (noise, frames_after_eos, max_steps)
    return frame_graph.run_frame(
        graphs, lambda *a: _frame_lanes(p, cfg, state, *a, seanet_weights),
        frame_graph.frame_key(p, cfg, state, seanet_weights, inputs),
        inputs)


def frame_mode(state: BatchedStreamState) -> str:
    """How the batch's last frame ran: "capture" or "replay" (CUDA graphs),
    or "eager"."""
    return "eager" if state.graphs is None else state.graphs.last


def _frame_lanes(p, cfg, state: BatchedStreamState, noise, frames_after_eos,
                 max_steps, seanet_weights):
    """frame_step_lanes' body, run eagerly or under capture: every state
    tensor is written in place."""
    _, latent, is_eos = flow_lm.decode_step_lanes(p, cfg, state.flow,
                                                  state.prev_latent, noise)
    step, done = state.step, state.done
    eos_step = torch.where((state.eos_step < 0) & is_eos & ~done, step,
                           state.eos_step)
    stop = (done | ((eos_step >= 0) & (step >= eos_step + frames_after_eos))
            | (step >= max_steps))
    # linear cursor: the KV budget ran out with this frame (ring mode
    # wraps below capacity, so this never fires there)
    full = state.flow.end >= state.flow.pos.shape[1]
    _, pcm = mimi.decode_frame(p["mimi"], cfg.mimi, state.mimi,
                               flow_lm.denormalize(p, latent),
                               cfg.gelu_approx, seanet_weights)
    state.prev_latent.copy_(latent)
    state.eos_step.copy_(eos_step)
    step.add_(1)
    state.done.copy_(stop | full)
    pcm = torch.where(stop[:, None], 0.0, 1.0) * pcm.float()
    return pcm, ~stop
