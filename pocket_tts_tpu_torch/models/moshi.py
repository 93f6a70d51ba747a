"""Moshi over lanes: one 80 ms frame of every lane a step, in place.

The frame of a lane at its step t (config.MoshiConfig has the sizes):

1. Input: the sum of the embeddings of the 17 tokens of grid column
   t - 1 (text, Moshi's n_q codebooks, the user's n_q; `state.prev`). A
   stream with delay d holds at column c the token of frame c - d, and the
   initial token (`text_card`, `card`) while c - d < 0; column -1 is all
   initial tokens.
2. Temporal transformer: `num_layers` pre-RMSNorm layers (norms in
   float32), attention through kernel K7 (ops/insert_attn.py: the new K/V
   row inserted into the lane's ring and attended with the rows of its
   window, `context` frames), the SwiGLU MLP; then `out_norm` and the text
   head, and the text token drawn from the text logits.
3. Depth transformer: `depth.steps` sub-steps, one a codebook, each with
   its own linears, causal over the frame's sub-steps (its KV is the
   frame's alone), no positional embedding: sub-step k takes
   `depth.in[k](z)` plus the embedding of the token drawn before it (the
   text token at k = 0, code k - 1 after), and draws code k from its
   logits.
4. Mimi decodes frame t - 1 of Moshi's audio: codebook 0 of column t - 1
   with codebooks 1.. of column t (their delay is 1), through the split
   RVQ, the x2 upsample, the Mimi transformer (kernel K2) and SEANet
   (kernel K3) (models/mimi.decode_codes_frame). At t = 0 a lane has no
   frame to decode: its PCM is not valid, and its Mimi carries are
   cleared after the frame (its ring rows are fenced by its `start`).

Draws: top-k at a temperature, by the inverse of the top-k softmax's CDF
at one uniform number a draw, from the lane's table of uniforms (drawn
from the request's seed at admission): row t, column 0 for the text, 1 + k
for code k. Everything stays on the device, so a frame is captured and
replayed from CUDA graphs (models/frame_graph.py) as the Pocket TTS lane
frame is, in ring mode on one card; the spans `ptt.temporal`,
`ptt.depth` (attribute `substeps`) and `ptt.mimi` mark the three parts
(`frame_graph.span`). The lanes share the temporal ring's write slot
(`end`, kept on the device as well: `end_dev`) and the Mimi ring offset;
each lane has its own positions (`next_pos`, its step t).

A call can also be resumed at a step a > 0 (`resume`, after `admit`):
its first a grid columns, given, pass through the temporal transformer
in one causal pass that writes its K/V rows behind the shared write slot,
and its Mimi decodes from its frame a - 1 on, from silence.

`frame_step_lanes_eager` is the same frame run eagerly: on the CPU (the
kernels' plain versions) the tests hold it against the plain reference
(ptts_bench/moshi/reference.py), and on the card the frames replayed
from graphs are held against it bit for bit.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F

from . import frame_graph, mimi
from ..ops.basic import inv_sqrt, linear, rms_norm, silu
from ..ops.insert_attn import decode_insert_attention
from ..ops.rope import apply_rope_halves, rope_cos_sin


@dataclasses.dataclass
class MoshiLanes:
    k: list                  # L x (B, S, D) temporal ring, K rows
    v: list                  # L x (B, S, D)
    pos: torch.Tensor        # (B, S) int32 position of each slot, -1 none
    next_pos: torch.Tensor   # (B,) int32: each lane's step t
    prev: torch.Tensor       # (B, streams) int64: grid column t - 1
    length: torch.Tensor     # (B,) int32: frames a lane's request emits
    done: torch.Tensor       # (B,) bool
    dk: list                 # depth L x (B, steps, Dd): the frame's K rows
    dv: list
    mimi: mimi.MimiState
    text_logits: torch.Tensor   # (B, text_card) of the last frame
    audio_logits: torch.Tensor  # (B, n_q, card) of the last frame
    tokens: torch.Tensor     # (B, 1 + n_q) int64: the last frame's draws
    delays: torch.Tensor     # (streams,) int32: cfg.delays on the device
    end: int = 0             # the shared write slot (host mirror)
    end_dev: Optional[torch.Tensor] = None
    graphs: object = None    # frame_graph.FrameGraphs of this batch

    @property
    def lanes(self) -> int:
        return self.pos.shape[0]


def initial_tokens(cfg, device) -> torch.Tensor:
    """(streams,) int64: grid column -1, every stream's initial token."""
    t = torch.full((cfg.streams,), cfg.card, dtype=torch.int64,
                   device=device)
    t[0] = cfg.text_card
    return t


def empty_lanes(cfg, b: int, dtype=torch.float32, device="cpu"
                ) -> MoshiLanes:
    """B idle lanes (done), every slot unwritten, the cursors on the
    device as well."""
    s, d = cfg.kv_capacity, cfg.d_model
    dep = cfg.depth
    dd = dict(dtype=dtype, device=device)
    state = MoshiLanes(
        k=[torch.zeros(b, s, d, **dd) for _ in range(cfg.num_layers)],
        v=[torch.zeros(b, s, d, **dd) for _ in range(cfg.num_layers)],
        pos=torch.full((b, s), -1, dtype=torch.int32, device=device),
        next_pos=torch.zeros(b, dtype=torch.int32, device=device),
        prev=initial_tokens(cfg, device).expand(b, -1).clone(),
        length=torch.zeros(b, dtype=torch.int32, device=device),
        done=torch.ones(b, dtype=torch.bool, device=device),
        dk=[torch.zeros(b, dep.steps, dep.d_model, **dd)
            for _ in range(dep.num_layers)],
        dv=[torch.zeros(b, dep.steps, dep.d_model, **dd)
            for _ in range(dep.num_layers)],
        mimi=mimi.init_state_lanes(cfg.mimi, b, dtype, device),
        text_logits=torch.zeros(b, cfg.text_card, **dd),
        audio_logits=torch.zeros(b, cfg.n_q, cfg.card, **dd),
        tokens=torch.zeros(b, 1 + cfg.n_q, dtype=torch.int64,
                           device=device),
        delays=torch.tensor(cfg.delays, dtype=torch.int32, device=device),
        end_dev=torch.zeros(1, dtype=torch.int32, device=device))
    state.mimi.transformer.offset_dev = torch.zeros(1, dtype=torch.int32,
                                                    device=device)
    return state


def admit(cfg, state: MoshiLanes, lanes, lengths) -> None:
    """Start a request in each of `lanes` (host ints) between frames:
    its positions cleared, its step 0, its grid column -1, its length (in
    frames), its Mimi ring fenced from the next frame on (the lane's
    first frame decodes nothing). Its KV rows stay: no slot is read
    before the lane writes it again."""
    idx = torch.as_tensor(list(lanes), dtype=torch.long,
                          device=state.pos.device)
    state.pos.index_fill_(0, idx, -1)
    state.next_pos.index_fill_(0, idx, 0)
    state.prev.index_copy_(0, idx, initial_tokens(cfg, idx.device).expand(
        len(idx), -1).contiguous())
    state.length.index_copy_(0, idx, torch.as_tensor(
        list(lengths), dtype=torch.int32, device=idx.device))
    state.done.index_fill_(0, idx, False)
    tr = state.mimi.transformer
    tr.start.index_fill_(0, idx, tr.offset + cfg.mimi.upsample_stride)


def history_columns(cfg, text, codes, user) -> torch.Tensor:
    """Grid columns 0..a-1 (a, streams) int64 of a call's first a steps:
    text (a,) and codes (a, n_q) the tokens drawn at them, user (N, n_q)
    its user codes by frame, all on one device."""
    a, nq = text.shape[0], cfg.n_q
    t = torch.arange(a, device=text.device)
    dl = torch.as_tensor(cfg.delays, device=text.device)
    own = torch.where(t[:, None] >= dl[None, 1:1 + nq], codes, cfg.card)
    f = t[:, None] - dl[None, 1 + nq:]
    got = user[f.clamp(0, user.shape[0] - 1),
               torch.arange(nq, device=text.device)[None]]
    usr = torch.where(f >= 0, got, cfg.card)
    return torch.cat([text[:, None], own, usr], 1)


def resume(p, cfg, state: MoshiLanes, lane: int, cols) -> None:
    """Resume the call just admitted (`admit`) into `lane` (a host int) at
    its step a: cols (a, streams) its grid columns 0..a-1
    (`history_columns`), 0 < a <= context. Its inputs (columns -1..a-2)
    pass through the temporal transformer in one causal pass (attention
    by torch's scaled_dot_product_attention in the working type), whose
    K/V rows of positions 0..a-1 fill the a slots behind the shared write
    slot; column a - 1 is its next input; its Mimi decodes from its next
    frame (frame a - 1) on, from silence."""
    a, s = cols.shape[0], cfg.kv_capacity
    if not 0 < a <= cfg.context:
        raise ValueError(f"a call resumes at a step in 1..{cfg.context}, "
                         f"not {a}")
    dev = state.pos.device
    inp = torch.cat([initial_tokens(cfg, dev)[None], cols[:-1]])
    x = _embed(p, cfg, inp)
    pos = torch.arange(a, dtype=torch.int32, device=dev)
    slots = (state.end - a + pos.long()) % s
    state.pos[lane, slots] = pos
    cos, sin = rope_cos_sin(pos[:, None], cfg.head_dim, cfg.max_period)
    h, hd = cfg.num_heads, cfg.head_dim
    for l, lp in enumerate(p["layers"]):
        qkv = linear(lp["in_proj"], rms_norm(lp["norm1"], x, cfg.norm_eps))
        q, k, v = qkv.view(a, 1, 3, h, hd).unbind(2)
        q = apply_rope_halves(q, cos, sin)
        k = apply_rope_halves(k, cos, sin)
        state.k[l][lane, slots] = k.reshape(a, h * hd)
        state.v[l][lane, slots] = v.reshape(a, h * hd)
        attn = F.scaled_dot_product_attention(
            q[:, 0].transpose(0, 1), k[:, 0].transpose(0, 1),
            v[:, 0].transpose(0, 1), is_causal=True)
        x = x + linear(lp["out_proj"], attn.transpose(0, 1).reshape(
            a, h * hd))
        x = x + _gating(lp["linear_in"], lp["linear_out"],
                        rms_norm(lp["norm2"], x, cfg.norm_eps))
    state.prev[lane] = cols[-1]
    state.next_pos[lane] = a
    tr = state.mimi.transformer
    tr.start[lane] = tr.offset
    fresh = torch.zeros(state.lanes, dtype=torch.bool, device=dev)
    fresh[lane] = True
    mimi.clear_lanes(state.mimi, fresh)


def sample_topk(logits, u, temp: float, k: int):
    """One token a row: top-k of `logits` (B, V) at temperature `temp`,
    drawn by the inverse of the top-k softmax's CDF at the uniform u (B,)
    in [0, 1). Returns (B,) int64."""
    vals, idx = torch.topk(logits.float(), k, dim=-1)
    c = torch.cumsum(torch.softmax(vals / temp, -1), -1)
    j = (c < u[:, None] * c[:, -1:]).sum(-1).clamp(max=k - 1)
    return idx.gather(-1, j[:, None])[:, 0]


def _gating(p_in, p_out, x):
    """linear_out(silu(a) * b), [a, b] = linear_in(x), the product in
    float32 rounded once."""
    h = linear(p_in, x)
    a, b = h.float().chunk(2, -1)
    return linear(p_out, (silu(a) * b).to(x.dtype))


def _embed(p, cfg, cols):
    """The sum of the embeddings of grid columns cols (B, streams) in
    float32, rounded once: (B, D)."""
    nq2 = 2 * cfg.n_q
    return (p["text_emb"][cols[:, 0]].float()
            + p["emb"][torch.arange(nq2, device=cols.device)[None],
                       cols[:, 1:]].float().sum(1)).to(p["text_emb"].dtype)


def _temporal(p, cfg, state: MoshiLanes, x):
    """The temporal transformer over the lanes' new rows x (B, D): every
    layer's row written at the shared slot; returns z (B, D)."""
    b = x.shape[0]
    s = cfg.kv_capacity
    t = state.next_pos
    end = frame_graph.Cursor(state, "end", state.end_dev)
    slot = state.end_dev.long()
    # the window: the slot written `context` frames ago leaves it
    state.pos.index_fill_(1, (slot + (s - cfg.context)) % s, -1)
    state.pos.index_copy_(1, slot, t[:, None])
    cos, sin = rope_cos_sin(t[:, None], cfg.head_dim, cfg.max_period)
    h, hd = cfg.num_heads, cfg.head_dim
    for l, lp in enumerate(p["layers"]):
        qkv = linear(lp["in_proj"], rms_norm(lp["norm1"], x, cfg.norm_eps))
        q, k, v = qkv.view(b, 1, 3, h, hd).unbind(2)
        q = apply_rope_halves(q, cos, sin)
        k = apply_rope_halves(k, cos, sin)
        attn = decode_insert_attention(
            q[:, 0].contiguous(), k.reshape(b, 1, h * hd),
            v.reshape(b, 1, h * hd).contiguous(), t, state.k[l], state.v[l],
            state.pos, s - 1, end)
        x = x + linear(lp["out_proj"], attn.reshape(b, h * hd))
        x = x + _gating(lp["linear_in"], lp["linear_out"],
                        rms_norm(lp["norm2"], x, cfg.norm_eps))
    return rms_norm(p["out_norm"], x, cfg.norm_eps)


def _depth_attend(q, dk, dv, k: int, heads: int):
    """Sub-step k's query over the frame's K/V rows 0..k: (B, Dd)."""
    b, dm = q.shape
    d = dm // heads
    kk = dk[:, : k + 1].reshape(b, k + 1, heads, d).float()
    vv = dv[:, : k + 1].reshape(b, k + 1, heads, d).float()
    lg = torch.einsum("bhd,bshd->bhs", q.view(b, heads, d).float(),
                      kk) * inv_sqrt(d)
    w = torch.softmax(lg, -1)
    return torch.einsum("bhs,bshd->bhd", w, vv).reshape(b, dm).to(q.dtype)


def _depth(p, cfg, state: MoshiLanes, z, text, u):
    """The depth transformer's sub-steps, each drawing its code; returns
    codes (B, steps) int64 and writes each sub-step's logits."""
    dep = cfg.depth
    pd = p["depth"]
    prev_tok = text
    codes = []
    for k in range(dep.steps):
        y = linear(pd["in"][k], z)
        emb = (pd["text_emb"][prev_tok] if k == 0
               else pd["emb"][k - 1][prev_tok])
        y = y + emb
        for l, lp in enumerate(pd["layers"]):
            qkv = linear(lp["in_proj"][k], rms_norm(lp["norm1"], y,
                                                    cfg.norm_eps))
            q, kr, vr = qkv.chunk(3, -1)
            state.dk[l][:, k].copy_(kr)
            state.dv[l][:, k].copy_(vr)
            attn = _depth_attend(q, state.dk[l], state.dv[l], k,
                                 dep.num_heads)
            y = y + linear(lp["out_proj"][k], attn)
            y = y + _gating(lp["linear_in"][k], lp["linear_out"][k],
                            rms_norm(lp["norm2"], y, cfg.norm_eps))
        logits = linear(pd["linears"][k], y)
        state.audio_logits[:, k].copy_(logits)
        prev_tok = sample_topk(logits, u[:, 1 + k], cfg.audio_temp,
                               cfg.audio_topk)
        codes.append(prev_tok)
    return torch.stack(codes, 1)


def _user_column(cfg, user, t, dl):
    """The user's tokens of grid column t (B, n_q): codebook j's frame
    t - dl[j], from the lane's table user (B, N, n_q), or the initial
    token before its first."""
    b, n, nq = user.shape
    f = t[:, None] - dl[None]                                  # (B, n_q)
    got = user[torch.arange(b, device=user.device)[:, None],
               f.clamp(0, n - 1).long(),
               torch.arange(nq, device=user.device)[None]]
    return torch.where(f >= 0, got, cfg.card)


def _frame(p, cfg, state: MoshiLanes, noise, user, seanet_weights):
    """One frame of every lane, every state tensor written in place;
    returns (pcm (B, frame) float32, valid (B,) bool)."""
    b = state.lanes
    t = state.next_pos
    lane = torch.arange(b, device=t.device)
    u = noise[lane, t.clamp(max=noise.shape[1] - 1).long()]
    prev = state.prev
    with frame_graph.span("ptt.temporal", layers=cfg.num_layers):
        x = _embed(p, cfg, prev)
        z = _temporal(p, cfg, state, x)
        text_logits = linear(p["text_linear"], z)
        state.text_logits.copy_(text_logits)
        text = sample_topk(text_logits, u[:, 0], cfg.text_temp,
                           cfg.text_topk)
    with frame_graph.span("ptt.depth", substeps=cfg.depth.steps):
        codes = _depth(p, cfg, state, z, text, u)
    with frame_graph.span("ptt.mimi"):
        # frame t - 1: codebook 0 of column t - 1, the rest of column t
        frame_codes = torch.cat([prev[:, 1:2], codes[:, 1:]], 1).clamp(
            max=cfg.card - 1)
        _, pcm = mimi.decode_codes_frame(p["mimi"], cfg.mimi, state.mimi,
                                         frame_codes, seanet_weights)
        first = t == 0
        mimi.clear_lanes(state.mimi, first)
    state.tokens.copy_(torch.cat([text[:, None], codes], 1))
    # grid column t becomes the next frame's input
    nq = cfg.n_q
    own = torch.where(t[:, None] >= state.delays[None, 1:1 + nq], codes,
                      cfg.card)
    prev.copy_(torch.cat([text[:, None], own, _user_column(
        cfg, user, t, state.delays[1 + nq:])], 1))
    done = state.done
    valid = ~done & ~first
    stop = done | (t >= state.length)
    done.copy_(stop)
    t.add_(1)
    s = cfg.kv_capacity

    def move():
        state.end = (state.end + 1) % s

    frame_graph.host(move)
    state.end_dev.add_(1).remainder_(s)
    pcm = torch.where(valid[:, None], 1.0, 0.0) * pcm.float()
    return pcm, valid


def frame_step_lanes(p, cfg, state: MoshiLanes, noise, user,
                     seanet_weights: dict = None):
    """One frame of every lane, in place. noise (B, N, 1 + n_q) float32:
    each lane's uniforms, row t its step t's; user (B, N, n_q) int64: each
    lane's user codes, row f its frame f. Returns (pcm (B, frame_size)
    float32, valid (B,) bool) on the device; the frame's text and audio
    logits are in `state.text_logits` / `state.audio_logits` and its draws
    in `state.tokens` until the next frame. On a CUDA card the frame runs
    from CUDA graphs (the first frame of a batch captures); how it ran:
    `frame_mode(state)`."""
    graphs = state.graphs
    if graphs is None and state.pos.device.type == "cuda":
        # the libraries' handles are made outside the capture (cuBLAS
        # cannot make one while a stream is captured)
        x = torch.ones(8, 8, device=state.pos.device)
        for dt in (torch.bfloat16, torch.float32):
            x.to(dt) @ x.to(dt)
        graphs = state.graphs = frame_graph.FrameGraphs()
    if graphs is None:
        return _frame(p, cfg, state, noise, user, seanet_weights)
    inputs = (noise, user)
    return frame_graph.run_frame(
        graphs, lambda *a: _frame(p, cfg, state, *a, seanet_weights),
        frame_graph.frame_key(p, cfg, state, seanet_weights, inputs),
        inputs)


def frame_step_lanes_eager(p, cfg, state: MoshiLanes, noise, user,
                           seanet_weights: dict = None):
    """`frame_step_lanes` run eagerly, never from graphs: the kernels'
    entries on the card, their plain versions on the CPU."""
    return _frame(p, cfg, state, noise, user, seanet_weights)


def frame_mode(state: MoshiLanes) -> str:
    """How the batch's last frame ran: "capture", "replay" or "eager"."""
    return "eager" if state.graphs is None else state.graphs.last
