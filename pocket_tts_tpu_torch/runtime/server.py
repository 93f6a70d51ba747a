"""Multi-stream serving: cohort-batched and continuously-batched synthesis.

Counterpart of `pocket_tts_tpu/runtime/server.py` on one card, with bf16,
f32, int8, int4 or q4_0 weights and the backbone KV cache in the working
type or in int8 (`TTSEngine(quantize_kv=True)`). Two schedulers over the
batched runtime (runtime/batched.py):

- MultiStreamServer: fixed cohorts. Requests queue, prefill together and
  decode in chunks; a late request waits for the cohort.
- ContinuousBatchingServer: per-chunk admission into a RUNNING batch,
  the lane scheduler (runtime/lanes.py) over Pocket TTS's lanes. The
  slot/position decoupling allows it with a shared slot cursor: a joining
  lane's KV prefix is written whole (admit_group), its positions, step
  and mimi start are its own, and its later KV writes share the batch's
  slot cursor, so its audio equals solo synthesis. Its own: voices, their
  prefill at admission (ptt.admit > {ptt.prefill, ptt.lane_write};
  ptt.prefill carries its real and padded rows), the lanes' noise and EOS
  tables, the chunk (ptt.chunk > ptt.frame) and the linear cursor with
  compaction beside ring admission. Noise comes from each request's seed
  (else the engine's `request_seed()`), the same in any lane and under
  any admission order.

Shared-prefix serving (`ContinuousBatchingServer(share_prefix=True)`, ring
mode only), as the JAX package's: each voice's prompt KV is split off its
primed state (models/backbone.split_prefix) into per-layer tables that
concatenate every registered voice along the slot axis and are read once
per frame for the whole batch; each lane's `ppos` row unmasks its own
voice's segment. The lane caches then hold text and decode rows only:
`prefix_slots` is `text_bucket`, and the capacity clamps to what a voice's
residual holds (kv_capacity - prompt bucket). `register_voices` may add
voices to an idle server. The JAX package's serving bench runs this mode
with int4 weights and the int8 KV cache at 32 lanes.

On a ("data", "model") mesh (`mesh=`; parallel/sharding.py, one process
per rank) the scheduler is replicated: every rank is given the same
`register_voices` and `submit` calls, and admission, compaction and
epochs are decided from the same host state everywhere. The decode cfg
comes from `mesh_cfg` and the params from `shard_params` (float, int8,
int4 or q4_0 weights; quantized convs whole on every rank). Each rank
prefills and decodes its own block of the lanes (`batched.lane_block`) at
its own heads, and the one host read of a chunk gathers pcm, valid and
done over "data" before any scheduling decision reads them. A rank
prefills only its own lanes of an admission group: the others' prefill
would be computed and thrown away, and a group's collectives stay inside
the "model" group, whose ranks hold the same lanes. The ranks of a
"model" group compute the same reduced hidden state bit for bit (the
all-reduce hands every rank the same sum), so their EOS decisions agree
without a broadcast (tests/test_torch_sharding.py holds it; chip_smoke.py
phase 11 on the card).
"""
from __future__ import annotations

import dataclasses
import itertools
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..models import backbone, tts
from ..text.preprocess import count_words, prepare_text_prompt
from ..parallel.sharding import gather_lanes, local_heads
from ..utils.profiling import span
from .batched import (_PROMPT_BUCKETS, admit_group, batched_decode_sentence,
                      batched_prime_voice, batched_sentence_prefill,
                      compact_batch, continuous_decode_chunk, draw_noise,
                      empty_batch_state, lane_block, mesh_setup,
                      shrink_lanes, stack_states)
from .engine import _SCAN_BUCKET, _bucket
from .lanes import Job, LaneScheduler, latency_stats


@dataclasses.dataclass
class Request(Job):
    """A sentence in a registered voice (scheduling fields: `Job`)."""
    text: str
    voice: str
    temp: float = 0.6


def _prep(engine, req: Request):
    """Tokenize a request once: (prepared text, frames-after-EOS guess,
    token ids), cached on the request."""
    if getattr(req, "_prep", None) is None:
        text, guess = prepare_text_prompt(req.text)
        req._prep = (text, guess, engine.tokenizer.encode(text))
    return req._prep


def _max_steps(engine, text: str) -> int:
    return int((count_words(text) + 2.0) * engine.cfg.mimi.frame_rate)


class MultiStreamServer:
    def __init__(self, engine, max_batch: int = 32, mesh=None,
                 chunk_frames: int = _SCAN_BUCKET):
        self.engine = engine
        self.max_batch = max_batch
        self.mesh = mesh
        self.cfg, self.params = mesh_setup(engine, mesh)
        self.chunk_frames = chunk_frames
        self._voices: Dict[str, int] = {}
        self._voice_states = None
        self._queue: List[Request] = []
        self._ids = itertools.count()
        self.completed: List[Request] = []

    # -- voices -------------------------------------------------------------
    def register_voices(self, prompts: Dict[str, np.ndarray]):
        """Prime all voices at once at a shared prompt bucket (a uniform
        slot cursor across the cohort)."""
        eng = self.engine
        names = list(prompts)
        arrs = [np.asarray(prompts[n], np.float32) for n in names]
        tp = max(_bucket(a.shape[0], _PROMPT_BUCKETS) for a in arrs)
        padded = torch.from_numpy(np.stack(
            [np.pad(a, ((0, tp - a.shape[0]), (0, 0))) for a in arrs])).to(
            eng.device, eng.dtype)
        n_valid = torch.tensor([a.shape[0] for a in arrs], dtype=torch.int32,
                               device=eng.device)
        states = stack_states([backbone.init_state(
            self.cfg.backbone, eng.dtype, eng.device) for _ in arrs])
        self._voice_states = batched_prime_voice(self.params, self.cfg,
                                                 states, padded, n_valid)
        self._voices = {n: i for i, n in enumerate(names)}

    # -- requests -----------------------------------------------------------
    def submit(self, text: str, voice: str, temp: float = 0.6,
               seed: Optional[int] = None) -> Request:
        req = Request(text=text, voice=voice, temp=temp, seed=seed,
                      submitted_at=time.perf_counter(), id=next(self._ids))
        self._queue.append(req)
        return req

    def run_pending(self):
        """Drain the queue in cohorts of max_batch. A request whose text
        exceeds the largest token bucket is evicted and its error raised,
        AFTER the fitting requests gathered so far have run (an eviction
        never loses its cohort siblings)."""
        while self._queue:
            cohort, err = [], None
            while self._queue and len(cohort) < self.max_batch:
                req = self._queue[0]
                try:
                    _bucket(len(_prep(self.engine, req)[2]))
                except ValueError as e:
                    self._queue.pop(0)  # evict the oversized request
                    err = e
                    break
                self._queue.pop(0)
                cohort.append(req)
            if cohort:
                self._run_cohort(cohort)
            if err is not None:
                raise err

    def _run_cohort(self, cohort: List[Request]):
        eng = self.engine
        dev = eng.device
        now = time.perf_counter()
        for req in cohort:
            req.admitted_at = now
        # pad the cohort to a fixed batch
        reqs = list(cohort) + [cohort[-1]] * (self.max_batch - len(cohort))
        # this rank's lanes (all without a mesh); buckets and budgets are
        # taken over the whole cohort
        own = lane_block(len(reqs), self.mesh)
        preps = [_prep(eng, r) for r in reqs]
        tp = max(_bucket(len(ids)) for _, _, ids in preps)
        tokens = torch.from_numpy(np.stack(
            [np.pad(np.asarray(preps[i][2], np.int64),
                    (0, tp - len(preps[i][2]))) for i in own])).to(dev)
        n_valid = torch.tensor([len(preps[i][2]) for i in own],
                               dtype=torch.int32, device=dev)
        max_steps = np.asarray([_max_steps(eng, t) for t, _, _ in preps],
                               np.int32)
        max_steps[len(cohort):] = 0  # padding lanes stop at frame 0
        cap = eng._sentence_capacity(tp, int(max_steps.max()),
                                     prompt_slots=self._voice_states.end)
        vstates = shrink_lanes(self._voice_states, cap,
                               [self._voices[reqs[i].voice] for i in own])
        states = batched_sentence_prefill(self.params, self.cfg, vstates,
                                          tokens, n_valid)
        total = int(max_steps.max())
        n_noise = -(-total // self.chunk_frames) * self.chunk_frames
        lat = eng.cfg.latent_dim
        # every rank draws every request's seed, in order
        seeds = [r.seed if r.seed is not None else eng.request_seed()
                 for r in cohort]
        noise = torch.stack([
            draw_noise(seeds[i], n_noise, lat, cohort[i].temp, eng.dtype,
                       dev) if i < len(cohort)
            else torch.zeros(n_noise, lat, dtype=eng.dtype, device=dev)
            for i in own])
        fae = torch.tensor([preps[i][1] + 2 for i in own], dtype=torch.int32,
                           device=dev)
        max_steps_t = torch.from_numpy(max_steps[own.start:own.stop]).to(dev)

        chunks: List[List[np.ndarray]] = [[] for _ in cohort]
        offset = 0
        while offset < total:
            states, pcm, valid = batched_decode_sentence(
                self.params, self.cfg, states, noise, fae, max_steps_t,
                self.chunk_frames, frame_offset=offset,
                seanet_weights=eng.seanet_weights)
            pcm = gather_lanes(pcm, self.mesh).numpy()
            valid = gather_lanes(valid, self.mesh).numpy()
            now = time.perf_counter()
            for i, req in enumerate(cohort):
                nv = int(valid[i].sum())
                if nv > 0:
                    if req.ttfa_s is None:
                        req.ttfa_s = now - req.submitted_at
                    chunks[i].append(pcm[i, :nv].reshape(-1))
            offset += self.chunk_frames
            if not valid.any():
                break

        now = time.perf_counter()
        for i, req in enumerate(cohort):
            req.pcm = (np.concatenate(chunks[i]) if chunks[i]
                       else np.zeros(0, np.float32))
            req.chunks = chunks[i]
            req.done_at = now
            self.completed.append(req)

    def stats(self) -> dict:
        return latency_stats(self.completed, self.engine.frame_size)




class ContinuousBatchingServer(LaneScheduler):
    """Per-chunk admission of new requests into a running batch.

    Default (ring=True) the backbone KV is a PREFIX+RING: slots
    [0, prefix_slots) hold each lane's prompt+text prefix, and the shared
    decode cursor wraps inside [prefix_slots, capacity). A slot is safely
    recycled because a row only has to outlive its own sentence, and
    admission bounds every request to the ring size; per-slot positions,
    not slot indices, key RoPE and masking, so wrapping is invisible to
    attention (K7 reads every slot and skips the stale write slot).

    ring=False is the linear-cursor epoch design: a request is admitted
    only if its worst-case frame budget fits the remaining capacity; when
    nothing fits and all lanes are idle the epoch resets, and between
    exhaustions eager compaction (compact_margin) keeps the cursor near the
    true live-row maximum.

    share_prefix=True (ring mode only): one shared copy of each voice's
    prompt KV for the whole batch (the module docstring).
    """

    def __init__(self, engine, lanes: int = 32,
                 capacity: Optional[int] = None, chunk_frames: int = 5,
                 text_bucket: int = 64, ring: bool = True,
                 compact_margin: Optional[int] = 128, mesh=None,
                 share_prefix: bool = False):
        if share_prefix and not ring:
            raise ValueError("share_prefix requires the prefix+ring KV "
                             "mode (ring=True)")
        super().__init__(engine, lanes,
                         capacity or engine.cfg.backbone.kv_capacity,
                         chunk_frames)
        self.text_bucket = text_bucket
        self.ring = ring
        # (ring=False only) eager compaction: attention reads scale with the
        # slot cursor, and finished lanes leave garbage rows below it. The
        # host knows every live lane's valid-row count (prompt rows + text
        # tokens + frames decoded), so once cursor - max(live rows) >=
        # compact_margin, one compact_batch pulls the cursor back down.
        # None disables (exhaustion-only compaction).
        self.compact_margin = compact_margin
        self.mesh = mesh
        # this rank's lanes (all without a mesh)
        self._own = lane_block(lanes, mesh)
        self.share_prefix = share_prefix
        # share_prefix: per-voice (pk, pv, ppos) from split_prefix, kept so
        # that a later register_voices rebuilds the tables over every voice
        self._voice_tables: Dict[str, tuple] = {}
        self._prefix_tables = None
        self._voice_states: Dict[str, backbone.BackboneState] = {}
        self._voice_rows: Dict[str, int] = {}
        self.prompt_pad: Optional[int] = None
        self.compactions = 0
        # compaction reclaims finished lanes' slots: until another request
        # completes, compacting again frees nothing (None: not this epoch)
        self._compacted_at: Optional[int] = None
        self.cfg, self.params = mesh_setup(engine, mesh)
        # per-lane noise (own lanes, capacity, latent): a request runs at
        # most capacity - prefix_slots frames
        self._noise = torch.zeros(len(self._own), self.capacity,
                                  engine.cfg.latent_dim, dtype=engine.dtype,
                                  device=engine.device)
        self._fae = np.ones((lanes,), np.int32)
        self._max_steps = np.zeros((lanes,), np.int32)
        self._fae_t = self._max_steps_t = None
        self._rows0 = np.zeros((lanes,), np.int32)  # valid rows at admission

    @property
    def prefix_slots(self) -> int:
        assert self.prompt_pad is not None, "register_voices first"
        if self.share_prefix:  # the prompt lives in the shared tables
            return self.text_bucket
        return self.prompt_pad + self.text_bucket

    @property
    def lane_frames(self) -> int:
        """The ring: what a lane's cache holds past its prefix."""
        return self.capacity - self.prefix_slots

    # -- voices --------------------------------------------------------------
    def register_voices(self, prompts: Dict[str, np.ndarray]):
        """Prime each voice at a COMMON prompt bucket so every admission's
        prefill lands exactly on the uniform prefix budget. Callable again
        to add voices. Anything that changes the lane cache shapes (the
        capacity tightening to what the voice residuals hold, a larger
        prompt bucket, or in share mode larger concatenated tables) starts
        a fresh epoch, so it requires an idle server (no live requests;
        queued requests survive)."""
        eng = self.engine
        arrs = {n: np.asarray(a, np.float32).reshape(-1, a.shape[-1])
                for n, a in prompts.items()}
        tp = max(_bucket(a.shape[0], _PROMPT_BUCKETS)
                 for a in arrs.values())
        # monotonic across calls: earlier voices must still fit the budget
        tp = max(tp, self.prompt_pad or 0)
        residuals = {}
        with torch.no_grad():
            for name, a in arrs.items():
                padded = torch.from_numpy(
                    np.pad(a, ((0, tp - a.shape[0]), (0, 0)))).to(
                    eng.device, eng.dtype)
                state = backbone.init_state(self.cfg.backbone, eng.dtype,
                                            eng.device)
                vstate = tts.prime_voice(self.params, self.cfg, state,
                                         padded, a.shape[0])
                if self.share_prefix:
                    self._voice_tables[name], vstate = backbone.split_prefix(
                        vstate, tp, local_heads(self.cfg.backbone),
                        eng.dtype)
                residuals[name] = vstate
                self._voice_rows[name] = a.shape[0]
        # lane caches must match the voice caches exactly (admission copies
        # voice rows into lanes): the capacity clamps to what a residual
        # holds (kv_capacity - prompt bucket in share mode)
        new_cap = min(self.capacity,
                      min(v.pos.shape[0] for v in residuals.values()))
        changed = (new_cap != self.capacity
                   or tp != (self.prompt_pad or tp))
        if new_cap < self.capacity:
            self._voice_states = {
                n: backbone.shrink_state(v, new_cap)
                for n, v in self._voice_states.items()}
            self.capacity = new_cap
        self._voice_states.update({
            n: (backbone.shrink_state(v, self.capacity)
                if self.capacity < v.pos.shape[0] else v)
            for n, v in residuals.items()})
        self.prompt_pad = tp
        if self.share_prefix:
            changed |= self._build_prefix_tables()
        if changed and self.batch is not None:
            if any(r is not None for r in self._live):
                raise ValueError(
                    "register_voices changed the lane cache shapes while "
                    "requests are live; drain the server first")
            self._free_batch()  # the next _admit builds a fresh epoch

    def _build_prefix_tables(self) -> bool:
        """Concatenate every registered voice's tables along the slot axis
        and give each voice state its ppos row (its own segment unmasked).
        Returns whether the tables' shape changed."""
        names = list(self._voice_tables)
        nl = self.cfg.backbone.num_layers
        pk, pv = ([torch.cat([self._voice_tables[n][i][l] for n in names], 1)
                   for l in range(nl)] for i in (0, 1))
        changed = (self._prefix_tables is not None
                   and pk[0].shape != self._prefix_tables[0][0].shape)
        self._prefix_tables = (pk, pv)
        off = 0
        for n in names:
            seg = self._voice_tables[n][2]
            ppos = torch.full((pk[0].shape[1],), -1, dtype=torch.int32,
                              device=seg.device)
            ppos[off:off + seg.shape[0]] = seg
            off += seg.shape[0]
            self._voice_states[n] = dataclasses.replace(
                self._voice_states[n], pk=pk, pv=pv, ppos=ppos)
        return changed

    # -- requests ------------------------------------------------------------
    def submit(self, text: str, voice: str, temp: float = 0.6,
               seed: Optional[int] = None) -> Request:
        return self._submit(Request(text=text, voice=voice, temp=temp,
                                    seed=seed))

    def _validate(self, req: Request) -> int:
        """Tokenize and bound-check a request BEFORE it joins an admission
        group; returns its worst-case frame need. Raising here is safe: the
        request is still at the front of the queue and no sibling has been
        popped."""
        text, _, ids = _prep(self.engine, req)
        if len(ids) > self.text_bucket:
            raise ValueError(
                f"request is {len(ids)} tokens > text_bucket "
                f"{self.text_bucket}; split it (engine.synthesize "
                "re-chunks)")
        return _max_steps(self.engine, text) + 8

    def _prefill_many(self, reqs: Sequence[Request]):
        """ONE batched prefill for an admission group (this rank's part of
        it on a mesh), padded to a power-of-two lane count."""
        eng = self.engine
        ids_list = [req._prep[2] for req in reqs]
        k = 1
        while k < len(reqs):
            k *= 2
        with span("ptt.prefill", lanes=len(reqs), lanes_padded=k,
                  tokens=sum(map(len, ids_list)),
                  token_slots=k * self.text_bucket):
            tokens = np.zeros((k, self.text_bucket), np.int64)
            n_valid = np.zeros((k,), np.int32)
            for i, ids in enumerate(ids_list):
                tokens[i, : len(ids)] = ids
                n_valid[i] = len(ids)
            vstates = stack_states(
                [self._voice_states[req.voice] for req in reqs]
                + [self._voice_states[reqs[-1].voice]] * (k - len(reqs)))
            return batched_sentence_prefill(
                self.params, self.cfg, vstates,
                torch.from_numpy(tokens).to(eng.device),
                torch.from_numpy(n_valid).to(eng.device))

    # -- the lanes -----------------------------------------------------------
    def _reset_epoch(self):
        eng = self.engine
        self._compacted_at = None
        self._free_batch()
        self.batch = empty_batch_state(eng.params, self.cfg, len(self._own),
                                       self.capacity, self.prefix_slots,
                                       eng.dtype, eng.device, ring=self.ring,
                                       prefix_tables=self._prefix_tables)

    def _take_lanes(self, group):
        if self.ring:
            super()._take_lanes(group)
        else:
            self._take_linear(group)

    def _compact_useful(self) -> bool:
        return self._compacted_at != len(self.completed)

    def _compact(self, live):
        own = live[self._own.start:self._own.stop]
        self.batch = compact_batch(
            self.batch, torch.tensor(own, device=self.engine.device),
            self.prefix_slots, self.mesh)
        self.compactions += 1
        self._compacted_at = len(self.completed)

    def _take_linear(self, group):
        """Linear-cursor admission: a request joins only if its frame
        budget fits the slots left, after compaction or a fresh epoch."""
        end = self.batch.flow.end
        # eager compaction: reclaim finished lanes' garbage once it exceeds
        # the margin (the cursor sets the per-frame attention read size)
        live_lanes = [r is not None for r in self._live]
        if (self.compact_margin is not None and any(live_lanes)
                and self._compact_useful()):
            est_max = max(
                int(self._rows0[lane])
                + (self.steps - r.admit_step) * self.chunk_frames
                for lane, r in enumerate(self._live) if r is not None)
            if end - max(est_max, self.prefix_slots) >= self.compact_margin:
                self._compact(live_lanes)
                end = self.batch.flow.end
        compacted = False
        for lane in range(self.lanes):
            if not self._queue or self._live[lane] is not None:
                continue
            need = self._front_need()
            if end + need > self.capacity and not compacted:
                # slot budget exhausted: compact the live lanes' rows
                # to the cache front (finished lanes' slots come back
                # without draining the epoch)
                if any(live_lanes) and self._compact_useful():
                    self._compact(live_lanes)
                    end = self.batch.flow.end
                elif not any(live_lanes):
                    self._reset_epoch()
                    end = self.prefix_slots
                compacted = True
            if end + need > self.capacity:
                if not group and all(r is None for r in self._live):
                    self._queue.pop(0)
                    raise ValueError(
                        f"request needs {need} frames + {end} prefix "
                        f"slots > capacity {self.capacity}")
                break  # even compacted, the live lanes fill the budget
            self._take(group, lane)

    def _write_lanes(self, group):
        """ONE batched prefill of the group's own lanes, then its caches,
        noise and EOS tables into its lanes."""
        eng = self.engine
        lo, b = self._own.start, len(self._own)
        # this rank's members of the group, at their local lanes
        own = [(lane - lo, req) for lane, req in group if lane in self._own]
        fresh = self._prefill_many([r for _, r in own]) if own else None
        with span("ptt.lane_write", lanes=len(group)):
            if own:
                # the prefill's power-of-two padding lanes get out-of-range
                # lane indices, so their writes are dropped
                lane_idx = ([lane for lane, _ in own]
                            + list(range(b, b + fresh.lanes - len(own))))
                self.batch = admit_group(self.batch, lane_idx, fresh)
            n = self._noise.shape[1]
            for lane, req in group:
                if lane in self._own:
                    self._noise[lane - lo] = draw_noise(
                        req.seed, n, eng.cfg.latent_dim, req.temp, eng.dtype,
                        eng.device)
                text, guess, ids = req._prep   # cached by _validate
                self._fae[lane] = guess + 2
                self._max_steps[lane] = _max_steps(eng, text)
                self._rows0[lane] = self._voice_rows[req.voice] + len(ids)
            # written in place once made: a frame replayed from CUDA graphs
            # reads them where its capture did
            own = slice(self._own.start, self._own.stop)
            fae = torch.from_numpy(self._fae[own])
            steps = torch.from_numpy(self._max_steps[own])
            if self._fae_t is None:
                self._fae_t, self._max_steps_t = (fae.to(eng.device),
                                                  steps.to(eng.device))
            else:
                self._fae_t.copy_(fae)
                self._max_steps_t.copy_(steps)

    def _decode_chunk(self):
        """chunk_frames frames of every lane: (pcm, valid) on the
        device."""
        self.batch, pcm, valid = continuous_decode_chunk(
            self.params, self.cfg, self.chunk_frames, self.batch,
            self._noise, self._fae_t, self._max_steps_t,
            self.engine.seanet_weights)
        return pcm, valid

    def _to_host(self, x) -> np.ndarray:
        """Every rank's lanes on a mesh (gathered over "data")."""
        return gather_lanes(x, self.mesh).numpy()
