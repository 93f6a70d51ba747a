"""Batched multi-stream decode: B streams on one card.

Counterpart of `pocket_tts_tpu/runtime/batched.py`. Stream states carry a
leading lane axis written out (models: `BatchedBackboneState`,
`BatchedStreamState`, the mimi state with (B, ...) tensors) where the JAX
package vmaps. Cursors that index storage stay uniform across the lanes,
as the JAX package's `_axes_like` keeps them: the backbone slot cursor
`end` (and `ring_start`) and the mimi ring `offset` are host ints. Every
per-stream quantity (positions, `next_pos`, the mimi `start`, `step`,
`eos_step`, `done`) is a (B, ...) tensor on the device, so lanes can sit
at different points of their sentences (continuous batching), and a frame
of all lanes launches K7 once per backbone layer, K2 once per mimi layer
and one K3 sequence, whatever B is.

Noise does not depend on scheduling. The JAX package folds each lane's key
with the lane's own step; torch cannot reproduce `jax.random`, so here a
request draws its whole noise sequence from its own seeded
torch.Generator (`draw_noise`) into a per-lane buffer on the device, which
the decode loop indexes by the lane's step. At temp 0 the noise is zero on
both sides. The state is updated in place throughout; the JAX functions
donate and return it.

Quantized weights (the decode step's K5a/K5b over the B rows, K6 over the
lanes), the int8 backbone KV cache and the int8 mimi ring (their per-row
scales ride along with the rows) and shared-prefix tables (`pk`/`pv`
shared by the lanes, `ppos` per lane) go through every function here.
Sharding over a mesh is not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence

import numpy as np
import torch

from ..models import backbone, flow_lm, mimi, mimi_transformer, tts
from ..text.preprocess import count_words, prepare_text_prompt
from .engine import _SCAN_BUCKET, _bucket

_PROMPT_BUCKETS = (32, 64, 128, 256)


def serving_cfg(cfg, mesh=None):
    """The cfg every batched decode runs with: `fuse_insert` on (K7) unless
    the caller set it. A mesh (sharded serving) is not ported yet."""
    if mesh is not None:
        raise NotImplementedError(
            "sharded serving over a device mesh is not ported yet")
    if cfg.backbone.fuse_insert is None:
        cfg = dataclasses.replace(cfg, backbone=dataclasses.replace(
            cfg.backbone, fuse_insert=True))
    return cfg


def draw_noise(seed: int, n: int, latent_dim: int, temp: float, dtype,
               device) -> torch.Tensor:
    """A request's noise for its first n frames, (n, latent): N(0, temp)
    from a torch.Generator seeded with `seed` on `device` (zeros at temp
    0). The same seed gives the same sequence in any lane at any time."""
    if temp == 0:
        return torch.zeros(n, latent_dim, dtype=dtype, device=device)
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    z = torch.randn(n, latent_dim, generator=g, device=device,
                    dtype=torch.float32)
    return (float(np.sqrt(np.float32(temp))) * z).to(dtype)


# ---------------------------------------------------------------------------
# stacking solo states into lanes and back
# ---------------------------------------------------------------------------

def _uniform(vals, what):
    if any(v != vals[0] for v in vals):
        raise ValueError(f"stack_states: {what} differs across streams "
                         f"({vals}); it is shared by the lanes")
    return vals[0]


def _i32(vals, device):
    return torch.tensor(vals, dtype=torch.int32, device=device)


def stack_states(states: Sequence):
    """Stack solo BackboneStates or StreamStates into one lane-axis state
    (copies). The shared cursors must be equal across the streams."""
    s0 = states[0]
    if isinstance(s0, backbone.BackboneState):
        def layers(name):
            if getattr(s0, name) is None:
                return None
            return [torch.stack([getattr(s, name)[l] for s in states])
                    for l in range(len(s0.k))]

        if any(s.pk is not s0.pk for s in states):
            raise ValueError("stack_states: the streams hold different "
                             "shared-prefix tables")
        return backbone.BatchedBackboneState(
            k=layers("k"), v=layers("v"),
            pos=torch.stack([s.pos for s in states]),
            next_pos=_i32([s.next_pos for s in states], s0.pos.device),
            end=_uniform([s.end for s in states], "end"),
            k_scale=layers("k_scale"), v_scale=layers("v_scale"),
            pk=s0.pk, pv=s0.pv,
            ppos=(None if s0.ppos is None
                  else torch.stack([s.ppos for s in states])))
    dev = s0.prev_latent.device
    trs = [s.mimi.transformer for s in states]

    def ring(name):
        if getattr(trs[0], name) is None:
            return None
        return [torch.stack([getattr(t, name)[l] for t in trs])
                for l in range(len(trs[0].k))]

    mstate = mimi.MimiState(
        upsample_prev=torch.stack([s.mimi.upsample_prev for s in states]),
        transformer=mimi_transformer.MimiTransformerState(
            k=ring("k"), v=ring("v"),
            offset=_uniform([t.offset for t in trs], "mimi offset"),
            start=_i32([t.start for t in trs], dev),
            k_scale=ring("k_scale"), v_scale=ring("v_scale")),
        seanet={key: torch.stack([s.mimi.seanet[key] for s in states])
                for key in s0.mimi.seanet})
    return tts.BatchedStreamState(
        flow=stack_states([s.flow for s in states]), mimi=mstate,
        prev_latent=torch.stack([s.prev_latent for s in states]),
        eos_step=_i32([s.eos_step for s in states], dev),
        step=_i32([s.step for s in states], dev),
        done=torch.tensor([s.done for s in states], device=dev))


def unstack_states(state, n: int = None) -> list:
    """The first n lanes of a lane-axis state as solo states (copies)."""
    n = state.lanes if n is None else n
    if isinstance(state, backbone.BatchedBackboneState):
        nxt = state.next_pos.tolist()

        def lane(cs, i):
            return None if cs is None else [c[i].clone() for c in cs]

        return [backbone.BackboneState(
            k=lane(state.k, i), v=lane(state.v, i), pos=state.pos[i].clone(),
            end=state.end, next_pos=nxt[i], k_scale=lane(state.k_scale, i),
            v_scale=lane(state.v_scale, i), pk=state.pk, pv=state.pv,
            ppos=None if state.ppos is None else state.ppos[i].clone())
            for i in range(n)]
    tr = state.mimi.transformer
    flows = unstack_states(state.flow, n)
    starts, eos = tr.start.tolist(), state.eos_step.tolist()
    steps, done = state.step.tolist(), state.done.tolist()

    def lane(cs, i):
        return None if cs is None else [c[i].clone() for c in cs]

    return [tts.StreamState(
        flow=flows[i],
        mimi=mimi.MimiState(
            upsample_prev=state.mimi.upsample_prev[i].clone(),
            transformer=mimi_transformer.MimiTransformerState(
                k=lane(tr.k, i), v=lane(tr.v, i), offset=tr.offset,
                start=starts[i], k_scale=lane(tr.k_scale, i),
                v_scale=lane(tr.v_scale, i)),
            seanet={k: c[i].clone() for k, c in state.mimi.seanet.items()}),
        prev_latent=state.prev_latent[i].clone(), eos_step=eos[i],
        step=steps[i], done=bool(done[i])) for i in range(n)]


def shrink_lanes(state: backbone.BatchedBackboneState, capacity: int,
                 lanes=None) -> backbone.BatchedBackboneState:
    """A COPY of the first `capacity` slots of the given lanes (all when
    None), cursors unchanged: the prefill writes in place, so a reusable
    voice prefix is never handed to it itself."""
    idx = (slice(None) if lanes is None
           else torch.as_tensor(lanes, dtype=torch.long,
                                device=state.pos.device))

    def take(cs):
        return None if cs is None else [c[idx, :capacity].clone()
                                        for c in cs]

    return backbone.BatchedBackboneState(
        k=take(state.k), v=take(state.v),
        pos=state.pos[idx, :capacity].clone(),
        next_pos=state.next_pos[idx].clone(), end=state.end,
        ring_start=state.ring_start, k_scale=take(state.k_scale),
        v_scale=take(state.v_scale), pk=state.pk, pv=state.pv,
        ppos=None if state.ppos is None else state.ppos[idx].clone())


# ---------------------------------------------------------------------------
# batched steps
# ---------------------------------------------------------------------------

def batched_prime_voice(p, cfg, states, prompts, n_valid):
    """states: a BatchedBackboneState (written in place); prompts
    (B, Tp, d_model); n_valid (B,) int tensor."""
    with torch.no_grad():
        return flow_lm.prefill_lanes(p, cfg, states, prompts, n_valid)


def batched_sentence_prefill(p, cfg, voice_states, tokens, n_valid):
    """voice_states: a BatchedBackboneState, written in place (pass a
    copy); tokens (B, Tt); n_valid (B,). Returns a BatchedStreamState ready
    for batched_frame_step."""
    with torch.no_grad():
        return tts.sentence_prefill_lanes(p, cfg, voice_states, tokens,
                                          n_valid)


def batched_frame_step(p, cfg, states, noise, frames_after_eos, max_steps,
                       seanet_weights: dict = None):
    """One frame of every lane in place: noise (B, latent); scalars (B,)
    int tensors. Returns (pcm (B, frame), valid (B,)) on the device."""
    with torch.no_grad():
        return tts.frame_step_lanes(p, cfg, states, noise, frames_after_eos,
                                    max_steps, seanet_weights)


def _run_frames(p, cfg, states, n_frames: int, noise_of, frames_after_eos,
                max_steps, seanet_weights):
    pcms, valids = [], []
    with torch.no_grad():
        for i in range(n_frames):
            pcm, valid = tts.frame_step_lanes(
                p, cfg, states, noise_of(i), frames_after_eos, max_steps,
                seanet_weights)
            pcms.append(pcm)
            valids.append(valid)
    return states, torch.stack(pcms, 1), torch.stack(valids, 1)


def batched_decode_sentence(p, cfg, states, noise, frames_after_eos,
                            max_steps, scan_len: int, frame_offset: int = 0,
                            seanet_weights: dict = None):
    """scan_len frames of every lane. noise: (B, N, latent) per-lane
    sequences; frame i uses noise[:, frame_offset + i], so chunked decoding
    (scan_len frames at a time) gives the same audio as one long run.
    Returns (states, pcm (B, scan_len, frame), valid (B, scan_len))."""
    # a contiguous (B, latent) copy: the kernels (K6 over the lanes) read
    # row-major rows, and noise[:, i] is a strided view
    return _run_frames(p, cfg, states, scan_len,
                       lambda i: noise[:, frame_offset + i].contiguous(),
                       frames_after_eos, max_steps, seanet_weights)


def continuous_decode_chunk(p, cfg, chunk_frames: int, states, noise,
                            frames_after_eos, max_steps,
                            seanet_weights: dict = None):
    """chunk_frames of every lane; lanes are at DIFFERENT steps, so each
    takes its noise at its own step: noise (B, N, latent), frame uses
    noise[b, min(step[b], N - 1)] (a lane past its budget is done and
    masked). Returns (states, pcm (B, chunk, frame), valid (B, chunk))."""
    lane = torch.arange(states.lanes, device=noise.device)
    last = noise.shape[1] - 1
    return _run_frames(
        p, cfg, states, chunk_frames,
        lambda i: noise[lane, states.step.clamp(max=last).long()],
        frames_after_eos, max_steps, seanet_weights)


# ---------------------------------------------------------------------------
# continuous batching primitives (per-chunk admission into a running batch)
# ---------------------------------------------------------------------------

def empty_batch_state(p, cfg, b: int, capacity: int, prefix_slots: int,
                      dtype=torch.float32, device="cpu", ring: bool = False,
                      prefix_tables=None) -> tts.BatchedStreamState:
    """A B-lane batch with every lane idle (done) and the shared slot
    cursor parked at `prefix_slots`, the uniform prompt+text budget every
    admission prefills into slots [0, prefix_slots). ring=True: the cursor
    wraps inside [prefix_slots, capacity) instead of exhausting (the
    continuous server's no-compaction mode). The caches are int8 with
    per-row scales under cfg.backbone.quantize_kv. prefix_tables: the
    (pk, pv) shared-prefix tables (prefix_slots then budgets the text
    only); each lane's ppos row arrives with its admission."""
    bb = cfg.backbone
    shape = (b, capacity, bb.num_heads * bb.head_dim)
    dd = dict(dtype=torch.int8 if bb.quantize_kv else dtype, device=device)

    def scales():
        return ([torch.zeros(b, capacity, device=device)
                 for _ in range(bb.num_layers)] if bb.quantize_kv else None)

    pk, pv = prefix_tables if prefix_tables is not None else (None, None)
    flow = backbone.BatchedBackboneState(
        k=[torch.zeros(shape, **dd) for _ in range(bb.num_layers)],
        v=[torch.zeros(shape, **dd) for _ in range(bb.num_layers)],
        pos=torch.full((b, capacity), -1, dtype=torch.int32, device=device),
        next_pos=torch.zeros(b, dtype=torch.int32, device=device),
        end=prefix_slots, ring_start=prefix_slots if ring else None,
        k_scale=scales(), v_scale=scales(), pk=pk, pv=pv,
        ppos=(None if pk is None else torch.full(
            (b, pk[0].shape[1]), -1, dtype=torch.int32, device=device)))
    return tts.BatchedStreamState(
        flow=flow, mimi=mimi.init_state_lanes(cfg.mimi, b, dtype, device),
        prev_latent=p["bos_emb"].to(dtype).expand(b, -1).clone(),
        eos_step=torch.full((b,), -1, dtype=torch.int32, device=device),
        step=torch.zeros(b, dtype=torch.int32, device=device),
        done=torch.ones(b, dtype=torch.bool, device=device))


def admit_group(batch: tts.BatchedStreamState, lanes: Sequence[int],
                fresh: tts.BatchedStreamState) -> tts.BatchedStreamState:
    """Admit a group of freshly prefilled streams into a RUNNING batch, in
    place: fresh lane i goes to lane lanes[i]; entries >= B are padding
    and dropped. The lanes' backbone caches, positions and next_pos, their
    mimi state, latent and counters are replaced; the shared slot cursor
    and mimi ring offset stay, and each joining lane's mimi `start` is the
    ring offset now, so its RoPE phases and ring window are its own (its
    audio equals solo synthesis). int8 KV scale rows (backbone and mimi
    ring) and shared-prefix `ppos` rows go with their lanes; the shared
    tables stay. The caches of
    `fresh` must have the batch's slot count."""
    src = [i for i, lane in enumerate(lanes) if lane < batch.lanes]
    if not src:
        return batch
    dev = batch.step.device
    dst = torch.tensor([lanes[i] for i in src], dtype=torch.long, device=dev)
    srci = torch.tensor(src, dtype=torch.long, device=dev)

    def put(dst_t, src_t):
        dst_t.index_copy_(0, dst, src_t.index_select(0, srci).to(
            dst_t.dtype))

    bf, ff = batch.flow, fresh.flow
    for dst_c, src_c in zip(bf.k + bf.v + (bf.k_scale or [])
                            + (bf.v_scale or []),
                            ff.k + ff.v + (ff.k_scale or [])
                            + (ff.v_scale or [])):
        put(dst_c, src_c)
    put(bf.pos, ff.pos)
    put(bf.next_pos, ff.next_pos)
    if bf.ppos is not None:
        put(bf.ppos, ff.ppos)
    bm, fm = batch.mimi, fresh.mimi
    bt, ft = bm.transformer, fm.transformer
    put(bm.upsample_prev, fm.upsample_prev)
    for dst_c, src_c in zip(bt.k + bt.v + (bt.k_scale or [])
                            + (bt.v_scale or []),
                            ft.k + ft.v + (ft.k_scale or [])
                            + (ft.v_scale or [])):
        put(dst_c, src_c)
    for key, c in bm.seanet.items():
        put(c, fm.seanet[key])
    bm.transformer.start.index_fill_(0, dst, bm.transformer.offset)
    put(batch.prev_latent, fresh.prev_latent)
    batch.eos_step.index_fill_(0, dst, -1)
    batch.step.index_fill_(0, dst, 0)
    batch.done.index_fill_(0, dst, False)
    return batch


def compact_batch(batch: tts.BatchedStreamState, live,
                  prefix_slots: int) -> tts.BatchedStreamState:
    """Compact every live lane's KV rows to the front of the cache and pull
    the shared slot cursor back, in place: the linear-cursor server's
    answer to exhaustion without draining. Rows move with their positions
    (RoPE was applied at write time and masks read `pos`), so this is a
    pure slot permutation: each lane's valid rows (pos >= 0, lane live)
    keep their order at the front, dead lanes compact to nothing, and the
    cursor restarts at the longest live lane's row count. live: (B,) bool
    tensor."""
    bf = batch.flow
    if bf.ring_start is not None:
        raise ValueError("compact_batch is the linear-cursor (epoch) "
                         "reclaim; ring mode recycles slots in place")
    pos = bf.pos
    s = pos.shape[1]
    valid = (pos >= 0) & live[:, None]
    key = torch.where(valid, 0, s) + torch.arange(s, device=pos.device)
    idx = torch.argsort(key, dim=1)
    for c in bf.k + bf.v:
        c.copy_(c.gather(1, idx[..., None].expand(-1, -1, c.shape[2])))
    for c in (bf.k_scale or []) + (bf.v_scale or []):
        c.copy_(c.gather(1, idx))
    pos.copy_(torch.where(valid.gather(1, idx), pos.gather(1, idx), -1))
    bf.end = max(prefix_slots, int(valid.sum(-1).max()))
    return batch


# ---------------------------------------------------------------------------
# cohort batching on one card
# ---------------------------------------------------------------------------

class BatchedEngine:
    """Synthesize many sentences concurrently on one card."""

    def __init__(self, engine, mesh=None):
        self.engine = engine
        # kept local: mutating engine.cfg would change the solo engine too
        self.cfg = serving_cfg(engine.cfg, mesh)

    def prime_voices(self, prompts: Sequence[np.ndarray]):
        """prompts: list of (Tp_i, d_model) arrays -> one lane-axis voice
        state; all prompts pad to one bucket so the slot cursor is
        uniform."""
        eng = self.engine
        tp = max(_bucket(p.shape[0], _PROMPT_BUCKETS) for p in prompts)
        padded = np.stack([
            np.pad(np.asarray(p, np.float32), ((0, tp - p.shape[0]), (0, 0)))
            for p in prompts])
        n_valid = torch.tensor([p.shape[0] for p in prompts],
                               dtype=torch.int32, device=eng.device)
        states = stack_states([backbone.init_state(
            self.cfg.backbone, eng.dtype, eng.device) for _ in prompts])
        return batched_prime_voice(
            eng.params, self.cfg, states,
            torch.from_numpy(padded).to(eng.device, eng.dtype), n_valid)

    def synthesize_batch(self, texts: List[str], voice_states,
                         temp: float = 0.6, seeds=None) -> List[np.ndarray]:
        """One prepared sentence per stream -> list of PCM arrays. seeds:
        one noise seed per stream (drawn from the engine when None)."""
        eng = self.engine
        b = len(texts)
        prepared = [prepare_text_prompt(t) for t in texts]
        ids = [eng.tokenizer.encode(t) for t, _ in prepared]
        tp = max(_bucket(len(i)) for i in ids)
        tokens = torch.from_numpy(np.stack([
            np.pad(np.asarray(i, np.int64), (0, tp - len(i)))
            for i in ids])).to(eng.device)
        dev = eng.device
        n_valid = torch.tensor([len(i) for i in ids], dtype=torch.int32,
                               device=dev)
        max_steps = [int((count_words(t) + 2.0) * eng.cfg.mimi.frame_rate)
                     for t, _ in prepared]
        cap = eng._sentence_capacity(tp, max(max_steps),
                                     prompt_slots=voice_states.end)
        states = batched_sentence_prefill(
            eng.params, self.cfg, shrink_lanes(voice_states, cap), tokens,
            n_valid)
        scan_len = -(-max(max_steps) // _SCAN_BUCKET) * _SCAN_BUCKET
        seeds = seeds or [eng.request_seed() for _ in range(b)]
        noise = torch.stack([draw_noise(s, scan_len, eng.cfg.latent_dim,
                                        temp, eng.dtype, dev)
                             for s in seeds])
        _, pcm, valid = batched_decode_sentence(
            eng.params, self.cfg, states, noise,
            torch.tensor([g + 2 for _, g in prepared], dtype=torch.int32,
                         device=dev),
            torch.tensor(max_steps, dtype=torch.int32, device=dev), scan_len,
            seanet_weights=eng.seanet_weights)
        pcm, valid = pcm.cpu().numpy(), valid.cpu().numpy()
        return [pcm[i, valid[i]].reshape(-1) for i in range(b)]
