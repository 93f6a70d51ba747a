"""Batched multi-stream decode: B streams on one card.

Counterpart of `pocket_tts_tpu/runtime/batched.py`. Stream states carry a
leading lane axis written out (models: `BatchedBackboneState`,
`BatchedStreamState`, the mimi state with (B, ...) tensors) where the JAX
package vmaps. Cursors that index storage stay uniform across the lanes,
as the JAX package's `_axes_like` keeps them: the backbone slot cursor
`end` (and `ring_start`) and the mimi ring `offset` are host ints (a
batch whose frames run from CUDA graphs keeps `end` and `offset` on the
device as well, models/frame_graph.py). Every
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

On a ("data", "model") mesh (parallel/sharding.py; `BatchedEngine(mesh=)`
and both servers) each rank holds its block of the lanes and of the
heads: the cfg comes from `mesh_cfg`, the params from `shard_params`, and
the functions here run unchanged on the rank's block; `compact_batch`
takes the new cursor over every rank's lanes, and the engine gathers the
audio over "data" where the host reads it. Quantized weights run there
too, with no fused kernel (K5a / K5b, K6): each linear is one K4a / K4b
call on the block the rank holds (`sharding.fusable`, `row_linear`).
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence

import numpy as np
import torch

from ..models import backbone, flow_lm, mimi, mimi_transformer, tts
from ..parallel.sharding import (axis_rank, axis_size, gather_lanes,
                                 local_heads, max_over_data, shard_params)
from ..text.preprocess import count_words, prepare_text_prompt
from ..utils.profiling import span
from .engine import _SCAN_BUCKET, _bucket

_PROMPT_BUCKETS = (32, 64, 128, 256)


def mesh_cfg(cfg, mesh=None):
    """The cfg every batched decode runs with, the JAX package's rule:
    `fuse_insert` on (K7) unless the caller set it; without a mesh nothing
    else changes. On a mesh (parallel.sharding.make_mesh): `on_mesh` set
    (the flow net then never takes K6), `mimi.seanet.mesh` set (each rank
    runs K3 over its own lanes), and each transformer part whose head
    count "model" divides gets the mesh: its heads, q/k/v columns, caches
    and MLP width split over "model", its kernels (K1 / K7, K2) on the
    local heads. A part "model" does not divide takes the plain route
    (`use_pallas_attn=False`), as the JAX package pins its kernels off
    there, and keeps its params and state whole on every rank (a split by
    whole heads is impossible), which computes what GSPMD computes.

    K1, K2 and K7 launch any local head count of at least one (K7's grid
    takes heads four at a time and masks the heads past the last), at the
    head dim of 64 they take with or without a mesh: divisibility is the
    only condition a mesh adds (tests/test_torch_sharding.py runs one head
    a rank).

    Every consumer of a mesh (BatchedEngine, MultiStreamServer,
    ContinuousBatchingServer) builds its cfg through this one helper."""
    if cfg.backbone.fuse_insert is None:
        cfg = dataclasses.replace(cfg, backbone=dataclasses.replace(
            cfg.backbone, fuse_insert=True))
    if mesh is None:
        return cfg
    model = axis_size(mesh, "model")

    def sub(c):
        if c.num_heads % model == 0:
            return dataclasses.replace(c, mesh=mesh)
        return dataclasses.replace(c, use_pallas_attn=False)

    return dataclasses.replace(
        cfg, on_mesh=True, backbone=sub(cfg.backbone),
        mimi=dataclasses.replace(
            cfg.mimi, transformer=sub(cfg.mimi.transformer),
            seanet=dataclasses.replace(cfg.mimi.seanet, mesh=mesh)))


def lane_block(n: int, mesh) -> range:
    """The lanes of n that this rank holds: its contiguous block of
    n / data (all n without a mesh)."""
    data = axis_size(mesh, "data")
    if n % data:
        raise ValueError(f"{n} lanes do not split over data {data}")
    c = n // data
    r = axis_rank(mesh, "data")
    return range(r * c, (r + 1) * c)


def mesh_setup(engine, mesh):
    """(cfg, params) of a batched decode: mesh_cfg of the engine's cfg, and
    this rank's block of its params (shard_params) on a mesh, else the
    engine's own; float or quantized (int8, int4, q4_0, with or without
    quantized convs), whatever the engine loaded them from."""
    if mesh is None:
        return mesh_cfg(engine.cfg), engine.params
    cfg = mesh_cfg(engine.cfg, mesh)
    return cfg, shard_params(engine.params, mesh, cfg)


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
    (copies). The shared cursors must be equal across the streams. Raises
    ValueError for a state holding cross-attention KV (init_cross): such
    a state decodes solo."""
    s0 = states[0]
    for s in states:
        if isinstance(s, tts.StreamState):
            backbone.refuse_cross(s.mimi.transformer, "stack_states")
            s = s.flow
        backbone.refuse_cross(s, "stack_states")
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
            with span("ptt.frame", i=i) as sp:
                pcm, valid = tts.frame_step_lanes(
                    p, cfg, states, noise_of(i), frames_after_eos, max_steps,
                    seanet_weights)
                if sp:  # "capture", "replay" (CUDA graphs) or "eager"
                    sp.set(graph=tts.frame_mode(states))
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
    shape = (b, capacity, local_heads(bb) * bb.head_dim)
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


def admit_stream(batch: tts.BatchedStreamState, lane: int,
                 fresh: tts.StreamState) -> tts.BatchedStreamState:
    """Insert one freshly prefilled SOLO stream into lane `lane` of a
    RUNNING batch, in place: the lane's backbone cache, positions and
    next_pos (and int8 scale rows) are replaced wholesale, its mimi state
    zeroed with its `start` at the ring offset now (so its RoPE phases and
    ring window are its own), its latent and counters reset; the shared
    slot cursor and ring offset stay. The JAX package's `admit_stream`;
    `admit_group` admits many prefilled lanes at once. The fresh cache
    must have the batch's slot count."""
    if fresh.flow.pk is not None or batch.flow.pk is not None:
        raise ValueError("admit_stream: shared-prefix lanes are admitted "
                         "with admit_group")
    bf, ff = batch.flow, fresh.flow
    for dst, src in zip(bf.k + bf.v + (bf.k_scale or [])
                        + (bf.v_scale or []),
                        ff.k + ff.v + (ff.k_scale or [])
                        + (ff.v_scale or [])):
        dst[lane].copy_(src)
    bf.pos[lane].copy_(ff.pos)
    bf.next_pos[lane] = ff.next_pos
    bm = batch.mimi
    bt = bm.transformer
    bm.upsample_prev[lane].zero_()
    for c in bt.k + bt.v + (bt.k_scale or []) + (bt.v_scale or []):
        c[lane].zero_()
    for c in bm.seanet.values():
        c[lane].zero_()
    bt.start[lane] = bt.offset
    batch.prev_latent[lane].copy_(fresh.prev_latent)
    batch.eos_step[lane] = -1
    batch.step[lane] = 0
    batch.done[lane] = False
    return batch


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
                  prefix_slots: int, mesh=None) -> tts.BatchedStreamState:
    """Compact every live lane's KV rows to the front of the cache and pull
    the shared slot cursor back, in place: the linear-cursor server's
    answer to exhaustion without draining. Rows move with their positions
    (RoPE was applied at write time and masks read `pos`), so this is a
    pure slot permutation: each lane's valid rows (pos >= 0, lane live)
    keep their order at the front, dead lanes compact to nothing, and the
    cursor restarts at the longest live lane's row count. live: (B,) bool
    tensor. mesh: on a mesh the batch holds this rank's lanes, and the
    longest live lane is taken over every "data" rank's, so that the
    shared cursor stays the same on all ranks."""
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
    bf.end = max(prefix_slots,
                 max_over_data(int(valid.sum(-1).max()), mesh))
    return batch


# ---------------------------------------------------------------------------
# cohort batching on one card
# ---------------------------------------------------------------------------

class BatchedEngine:
    """Synthesize many sentences concurrently on one card, or on a mesh.

    mesh (parallel.sharding.make_mesh, one process per rank, every rank
    making the same calls): the params are sharded once (`shard_params`,
    float or quantized weights), each rank primes,
    prefills and decodes only its own block of the lanes (`lane_block`)
    at its own heads, which is the layout `shard_batched_state` gives a
    whole batch state, and the audio is gathered over "data" where the
    host reads it, so `synthesize_batch` returns every stream's audio on
    every rank, as the JAX package's single-controller call does."""

    def __init__(self, engine, mesh=None):
        self.engine = engine
        self.mesh = mesh
        # kept local: mutating engine.cfg would change the solo engine too
        self.cfg, self.params = mesh_setup(engine, mesh)

    def prime_voices(self, prompts: Sequence[np.ndarray]):
        """prompts: list of (Tp_i, d_model) arrays -> one lane-axis voice
        state (this rank's lanes on a mesh); all prompts pad to one bucket
        so the slot cursor is uniform."""
        eng = self.engine
        tp = max(_bucket(p.shape[0], _PROMPT_BUCKETS) for p in prompts)
        own = [prompts[i] for i in lane_block(len(prompts), self.mesh)]
        padded = np.stack([
            np.pad(np.asarray(p, np.float32), ((0, tp - p.shape[0]), (0, 0)))
            for p in own])
        n_valid = torch.tensor([p.shape[0] for p in own],
                               dtype=torch.int32, device=eng.device)
        states = stack_states([backbone.init_state(
            self.cfg.backbone, eng.dtype, eng.device) for _ in own])
        return batched_prime_voice(
            self.params, self.cfg, states,
            torch.from_numpy(padded).to(eng.device, eng.dtype), n_valid)

    def synthesize_batch(self, texts: List[str], voice_states,
                         temp: float = 0.6, seeds=None) -> List[np.ndarray]:
        """One prepared sentence per stream -> list of PCM arrays. seeds:
        one noise seed per stream (drawn from the engine when None)."""
        eng = self.engine
        b = len(texts)
        own = lane_block(b, self.mesh)
        prepared = [prepare_text_prompt(t) for t in texts]
        ids = [eng.tokenizer.encode(t) for t, _ in prepared]
        # buckets and budgets over every stream, so that each rank's lanes
        # decode as in the whole batch
        tp = max(_bucket(len(i)) for i in ids)
        dev = eng.device
        tokens = torch.from_numpy(np.stack([
            np.pad(np.asarray(ids[i], np.int64), (0, tp - len(ids[i])))
            for i in own])).to(dev)
        n_valid = torch.tensor([len(ids[i]) for i in own], dtype=torch.int32,
                               device=dev)
        max_steps = [int((count_words(t) + 2.0) * eng.cfg.mimi.frame_rate)
                     for t, _ in prepared]
        cap = eng._sentence_capacity(tp, max(max_steps),
                                     prompt_slots=voice_states.end)
        states = batched_sentence_prefill(
            self.params, self.cfg, shrink_lanes(voice_states, cap), tokens,
            n_valid)
        scan_len = -(-max(max_steps) // _SCAN_BUCKET) * _SCAN_BUCKET
        seeds = seeds or [eng.request_seed() for _ in range(b)]
        noise = torch.stack([draw_noise(seeds[i], scan_len,
                                        eng.cfg.latent_dim, temp, eng.dtype,
                                        dev) for i in own])
        _, pcm, valid = batched_decode_sentence(
            self.params, self.cfg, states, noise,
            torch.tensor([prepared[i][1] + 2 for i in own],
                         dtype=torch.int32, device=dev),
            torch.tensor([max_steps[i] for i in own], dtype=torch.int32,
                         device=dev), scan_len,
            seanet_weights=eng.seanet_weights)
        pcm = gather_lanes(pcm, self.mesh).numpy()
        valid = gather_lanes(valid, self.mesh).numpy()
        return [pcm[i, valid[i]].reshape(-1) for i in range(b)]
