"""How K1 (csrc/decode_attn.cu), K2 (csrc/ring_attn.cu) and K7
(csrc/insert_attn.cu) cut their work over thread-block clusters, checked
on the CPU, f32:

- the split geometry: `k1_split` chunks [0, end] (units of 8 slots) and
  `k2_split` the cap + T keys (16-key tiles), units dealt out in turn by
  `chunk_units`, covering each slot exactly once with no empty chunk, at
  most 8 chunks (the portable cluster size, which is the whole grid's x
  extent, so it divides it); the split takes no lane count, so a lane of a
  batched call runs the solo call's blocks;
- a plain model of each kernel's decomposition: every chunk's flash
  partial (m, l, acc) with the plain arithmetic, merged in chunk order by
  the kernels' guarded rule (`partial_weight` in csrc/common.cuh), equals
  the unsplit plain version within 1e-6 (both f32, summation order only):
  K1 solo and over lanes, int8 caches, statistics, an idle lane (out 0, m =
  -inf, l = 0), a chunk masked by pos < 0; K2 solo and over lanes with
  starts that fence whole chunks, and over int8 rings. The K2 model masks
  the pre-insert ring plus the new rows by the TPU kernel's arithmetic
  (pallas_mimi.py:130-145), as the kernel does, and the plain version
  inserts first and masks with ring_cache_bias: their agreement checks the
  kernel's mask too. K7: `k7_split` (which also takes the lane count)
  covers [0, read_end] once at every read_end, and a plain model of its
  decomposition (the write slot's row from the new row in the chunk that
  owns it, or, int8, merged after the cluster; the insert into the caches)
  equals decode_insert_attention_plain, each lane of a many-lane call its
  own solo call. Past K7_LONG_SLOTS slots (Moshi's 3,072-slot ring) the
  split takes up to 8 chunks at any lane count, and a mirror of the
  kernel's compacted walk (each chunk's attended slots listed by warp
  ballots, then walked two rows a lane group a step) reads each attended
  slot once and no masked one; the model over that walk equals the plain
  version at 1-8 chunks.
"""
import inspect
import math

import numpy as np
import pytest
import torch

from pocket_tts_tpu_torch.ops.attention import merge_attn_partials
from pocket_tts_tpu_torch.ops.decode_attn import (K1_UNIT, MAX_SPLITS,
                                                  chunk_units,
                                                  decode_attention_plain,
                                                  k1_split)
from pocket_tts_tpu_torch.ops.insert_attn import (
    K7_LANES_SPLITS, K7_LONG_SLOTS, K7_MANY_LANES, K7_UNIT,
    decode_insert_attention_plain, k7_split)
from pocket_tts_tpu_torch.ops.ring_attn import (K2_TILE, k2_split,
                                                ring_insert_attention_plain)

ATOL = 1e-6
NEG = float("-inf")


def chunk_slots(c, n, total, unit):
    """The slots of chunk c, in the order the kernel walks them."""
    return torch.cat([torch.arange(lo, hi)
                      for lo, hi in chunk_units(c, n, total, unit)])


def assert_split(n, total, unit):
    """The n chunks cover [0, total) once, none empty, each range a whole
    unit (the last one cut at total)."""
    seen = torch.zeros(total, dtype=torch.int64)
    for c in range(n):
        ranges = chunk_units(c, n, total, unit)
        assert ranges
        for lo, hi in ranges:
            assert lo % unit == 0 and (hi - lo == unit or hi == total)
            seen[lo:hi] += 1
    assert (seen == 1).all()


@pytest.mark.parametrize("s", [128, 384, 1024])
def test_k1_split_covers_live_slots_once(s):
    for end in range(s):
        n = k1_split(end, s)
        assert 1 <= n <= MAX_SPLITS
        assert_split(n, end + 1, K1_UNIT)
    assert k1_split(300, 384) == 4            # 4 x 16 heads = 64 blocks


@pytest.mark.parametrize("t", [1, 2, 4, 8, 16])
def test_k2_split_covers_keys_once(t):
    for cap in range(t, 1025, t):
        n = k2_split(cap, t)
        assert 1 <= n <= MAX_SPLITS
        assert_split(n, cap + t, K2_TILE)
    assert k2_split(256, 16) == 2             # 17 tiles, 9 and 8


def test_splits_take_no_lane_count():
    assert list(inspect.signature(k1_split).parameters) == ["end", "s"]
    assert list(inspect.signature(k2_split).parameters) == ["cap", "t"]
    with pytest.raises(ValueError):
        k1_split(384, 384)
    with pytest.raises(ValueError):
        k2_split(250, 16)


def merge_chunks(parts):
    """The kernels' merge of flash partials (m, l, acc) of shapes (...),
    (...), (..., D), summed in chunk order: each weighed by exp(m - M), M
    the largest m, and by 0 when M = -inf (no chunk attended a key) ->
    normalised out, M, l."""
    mx = torch.stack([m for m, _, _ in parts]).amax(0)
    live = mx > NEG
    safe = torch.where(live, mx, torch.zeros_like(mx))
    l = torch.zeros_like(mx)
    acc = torch.zeros_like(parts[0][2])
    for m, lc, ac in parts:
        w = torch.where(live, torch.exp(m - safe), torch.zeros_like(mx))
        acc = acc + ac * w[..., None]
        l = l + lc * w
    out = torch.where(l[..., None] > 0, acc / l.clamp_min(1e-30)[..., None],
                      torch.zeros_like(acc))
    return out, mx, l


def flash_partial(logits, vals):
    """One chunk's partial: logits (..., K) with -inf on masked keys, vals
    (..., K, D) (the v scale already applied for int8 rings)."""
    m = logits.amax(-1)
    safe = torch.where(m > NEG, m, torch.zeros_like(m))
    p = torch.exp(logits - safe[..., None])
    return m, p.sum(-1), torch.einsum("...k,...kd->...d", p, vals)


def test_merge_guard_keeps_empty_partials_empty():
    e = (torch.full((2,), NEG), torch.zeros(2), torch.zeros(2, 4))
    out, m, l = merge_chunks([e, e, e])
    assert torch.equal(out, torch.zeros(2, 4))
    assert torch.isneginf(m).all() and (l == 0).all()
    # the unguarded rule (ops/attention.py, as the JAX package has it)
    # turns two empty partials into NaN: the kernels must not use it
    bad = merge_attn_partials(e[2], e[0], e[1], e[2], e[0], e[1])
    assert torch.isnan(bad).all()


# ---------------------------------------------------------------- K1 model --

def k1_model(q, k, v, pos, end, ks=None, vs=None):
    """K1's decomposition over lanes: q (B, H, D), caches (B, S, H*D),
    pos and scales (B, S). Returns out, m, l."""
    b, h, d = q.shape
    s = k.shape[1]
    kh = k.float().view(b, s, h, d)
    vh = v.float().view(b, s, h, d)
    n = k1_split(end, s)
    parts = []
    for c in range(n):
        i = chunk_slots(c, n, end + 1, K1_UNIT)
        lg = torch.einsum("bhd,bshd->bhs", q.float(), kh[:, i]) \
            / math.sqrt(d)
        vals = vh[:, i].permute(0, 2, 1, 3)               # (B, H, K, D)
        if ks is not None:
            lg = lg * ks[:, None, i]
            vals = vals * vs[:, None, i, None]
        lg = lg.masked_fill((pos[:, None, i] < 0), NEG)
        parts.append(flash_partial(lg, vals))
    return merge_chunks(parts)


def k1_inputs(rng, b, s, h, d, int8):
    q = torch.from_numpy(rng.randn(b, h, d).astype(np.float32))
    if int8:
        k = torch.from_numpy(rng.randint(-127, 128, (b, s, h * d))
                             .astype(np.int8))
        v = torch.from_numpy(rng.randint(-127, 128, (b, s, h * d))
                             .astype(np.int8))
        ks = torch.from_numpy(rng.uniform(0.005, 0.02, (b, s))
                              .astype(np.float32))
        vs = torch.from_numpy(rng.uniform(0.005, 0.02, (b, s))
                              .astype(np.float32))
        return q, k, v, ks, vs
    k = torch.from_numpy(rng.randn(b, s, h * d).astype(np.float32))
    v = torch.from_numpy(rng.randn(b, s, h * d).astype(np.float32))
    return q, k, v, None, None


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("s,end", [(128, 0), (128, 40), (384, 300),
                                   (384, 383), (1024, 1023)])
def test_k1_model_equals_plain(int8, s, end):
    """Solo (B = 1) and over 3 lanes: lane 1 idle (every pos < 0), lane 2
    with its third chunk masked by pos < 0 and holes; with statistics."""
    rng = np.random.RandomState(s + end)
    h, d = 4, 16
    for b in (1, 3):
        q, k, v, ks, vs = k1_inputs(rng, b, s, h, d, int8)
        pos = torch.arange(s, dtype=torch.int32).repeat(b, 1)
        pos[:, end + 1:] = -1
        if b == 3:
            pos[1] = -1
            n = k1_split(end, s)
            pos[2, chunk_slots(min(2, n - 1), n, end + 1, K1_UNIT)] = -1
            pos[2, :3] = -1
        out, m, l = k1_model(q, k, v, pos, end, ks, vs)
        want, wm, wl = decode_attention_plain(q, k, v, pos, end, ks, vs,
                                              stats=True)
        assert torch.isfinite(out).all()
        np.testing.assert_allclose(out.numpy(), want.numpy(), atol=ATOL)
        assert torch.equal(torch.isneginf(m), torch.isneginf(wm))
        live = torch.isfinite(wm)
        np.testing.assert_allclose(m[live].numpy(), wm[live].numpy(),
                                   atol=ATOL)
        np.testing.assert_allclose(l.numpy(), wl.numpy(), rtol=ATOL)
        if b == 3:
            assert (out[1] == 0).all() and (l[1] == 0).all()
            assert torch.isneginf(m[1]).all()
            # a lane runs the solo call's chunks: the split ignores B
            solo = k1_model(q[2:], k[2:], v[2:], pos[2:], end,
                            None if ks is None else ks[2:],
                            None if vs is None else vs[2:])
            np.testing.assert_allclose(solo[0].numpy(), out[2:].numpy(),
                                       atol=ATOL)


# ---------------------------------------------------------------- K2 model --

def k2_mask(t, cap, off, start, context):
    """(T, cap + T) visibility of the pre-insert ring's slots and the new
    rows to the T queries: the TPU kernel's arithmetic, as the kernel has
    it."""
    slot0 = ((off // t) % (cap // t)) * t
    last = off - 1
    end_index = last % cap
    mask = torch.zeros(t, cap + t, dtype=torch.bool)
    for j in range(cap):
        delta = j - end_index
        pk = last + delta - (cap if delta > 0 else 0)
        if not (j < off and (j - slot0) % cap >= t and pk >= start):
            continue
        for tq in range(t):
            pq = off + tq
            mask[tq, j] = pq >= pk and pq - pk < context
    for jn in range(t):
        mask[jn:, cap + jn] = True
    return mask


def k2_model(q, kn, vn, kc, vc, off, start, h, context, ks=None, vs=None,
             ksn=None, vsn=None):
    """K2's decomposition for one lane: q/kn/vn (T, H*D), PRE-insert caches
    (cap, H*D). Returns (out (T, H*D), the chunks' m (n, H, T))."""
    t, hd = q.shape
    cap = kc.shape[0]
    d = hd // h
    keys = torch.cat([kc, kn]).float().view(cap + t, h, d)
    vals = torch.cat([vc, vn]).float().view(cap + t, h, d)
    mask = k2_mask(t, cap, off, start, context)
    n = k2_split(cap, t)
    parts, ms = [], []
    for c in range(n):
        i = chunk_slots(c, n, cap + t, K2_TILE)
        lg = torch.einsum("thd,khd->htk", q.float().view(t, h, d),
                          keys[i]) / math.sqrt(d)
        vv = vals[i].permute(1, 0, 2)[:, None]               # (H, 1, K, D)
        if ks is not None:
            lg = lg * torch.cat([ks, ksn])[i]
            vv = vv * torch.cat([vs, vsn])[i, None]
        lg = lg.masked_fill(~mask[None, :, i], NEG)
        part = flash_partial(lg, vv.expand(h, t, len(i), d))
        parts.append(part)
        ms.append(part[0])
    out, _, _ = merge_chunks(parts)
    return out.permute(1, 0, 2).reshape(t, hd), torch.stack(ms)


def k2_inputs(rng, t, cap, hd, int8):
    def rows(n):
        if int8:
            return torch.from_numpy(rng.randint(-127, 128, (n, hd))
                                    .astype(np.int8))
        return torch.from_numpy(rng.randn(n, hd).astype(np.float32))

    def scales(n):
        return torch.from_numpy(rng.uniform(0.005, 0.02, n)
                                .astype(np.float32))
    q = torch.from_numpy(rng.randn(t, hd).astype(np.float32))
    kn, vn, kc, vc = rows(t), rows(t), rows(cap), rows(cap)
    sc = ((scales(cap), scales(cap), scales(t), scales(t)) if int8
          else (None,) * 4)
    return (q, kn, vn, kc, vc) + sc


def k2_plain(inp, off, start, h, ctx):
    q, kn, vn, kc, vc, ks, vs, ksn, vsn = inp
    kw = {}
    if ks is not None:
        kw = dict(k_scale=ks.clone(), v_scale=vs.clone(), ks_new=ksn,
                  vs_new=vsn)
    return ring_insert_attention_plain(q, kn, vn, kc.clone(), vc.clone(),
                                       off, start, h, ctx, **kw)


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("off", [0, 16, 240, 256, 4096])
def test_k2_model_equals_plain(int8, off):
    """Solo, cap 256, T 16, context 250; starts 0, 32, and fences that
    leave only the newest rows (whole chunks masked)."""
    rng = np.random.RandomState(off + int8)
    h, d, cap, t, ctx = 2, 16, 256, 16, 250
    for start in sorted({0, 32, max(off - 48, 0), off}):
        if start > off:
            continue
        inp = k2_inputs(rng, t, cap, h * d, int8)
        out, ms = k2_model(*inp[:5], off, start, h, ctx, *inp[5:])
        want = k2_plain(inp, off, start, h, ctx)
        assert torch.isfinite(out).all()
        np.testing.assert_allclose(out.numpy(), want.numpy(), atol=ATOL)
        if start == off:   # only the new rows' tile: the rest drop out
            dropped = sum(bool(torch.isneginf(m).all()) for m in ms)
            assert dropped == len(ms) - 1


@pytest.mark.parametrize("int8", [False, True])
def test_k2_model_over_lanes_with_fences(int8):
    """Four lanes at offset 4096 whose starts fence none, some and all of
    the ring's chunks: each lane's model equals the plain lane call's rows,
    and the fenced chunks give m = -inf and drop out."""
    rng = np.random.RandomState(5 + int8)
    h, d, cap, t, ctx, off = 2, 16, 256, 16, 250, 4096
    starts = [0, off - 96, off - 16, off]
    lanes = [k2_inputs(rng, t, cap, h * d, int8) for _ in starts]
    stacked = [None if x[0] is None else torch.stack(x)
               for x in zip(*lanes)]
    q, kn, vn, kc, vc, ks, vs, ksn, vsn = stacked
    kw = {}
    if int8:
        kw = dict(k_scale=ks.clone(), v_scale=vs.clone(), ks_new=ksn,
                  vs_new=vsn)
    want = ring_insert_attention_plain(
        q, kn, vn, kc.clone(), vc.clone(), off,
        torch.tensor(starts, dtype=torch.int32), h, ctx, **kw)
    n = k2_split(cap, t)
    for i, (inp, start) in enumerate(zip(lanes, starts)):
        out, ms = k2_model(*inp[:5], off, start, h, ctx, *inp[5:])
        np.testing.assert_allclose(out.numpy(), want[i].numpy(), atol=ATOL)
        fenced = [c for c in range(n)
                  if torch.isneginf(ms[c]).all()]
        if start >= off - 16:   # at most two tiles seen: the rest drop out
            assert len(fenced) >= n - 2


# ---------------------------------------------------------------- K7 model --

@pytest.mark.parametrize("b", [1, 2, 32, 64])
@pytest.mark.parametrize("s", [128, 896, 1024, 2048, 3072])
def test_k7_split_covers_slots_once(s, b):
    """Up to 2,048 slots the split is what it always was (at most 2 chunks
    from 8 lanes on); past that, one chunk per 32 slots up to 8 at any lane
    count (8 at S = 3,072 in ring mode, 32 lanes)."""
    for read_end in range(s):
        n = k7_split(read_end, s, b)
        assert 1 <= n <= MAX_SPLITS
        assert_split(n, read_end + 1, K7_UNIT)
        every = min(MAX_SPLITS, -(-(read_end + 1) // 32))
        if s > K7_LONG_SLOTS or b < K7_MANY_LANES:
            assert n == every
        else:
            assert n == min(every, K7_LANES_SPLITS)
    with pytest.raises(ValueError):
        k7_split(s, s, b)
    if s > K7_LONG_SLOTS:
        assert k7_split(s - 1, s, b) == MAX_SPLITS


def k7_long_walk(pos, cur, ws, read_end, n, c, quant, rpw=2):
    """The cache slots one warp of chunk c (of n) walks on the long-ring
    path, in walk order, for one lane (pos (S,) post-insert, cur its new
    row's position), mirroring csrc/insert_attn.cu: the chunk's positions
    (slot ws: attended iff the row is valid, never for int8), then its 4
    warps each list the attended local slots of a stretch of
    ceil(nloc / 128) * 32 by ballots over 32 slots, placed after the
    counts of the warps before; then step i takes rows i * 2 rpw + g and
    i * 2 rpw + g + rpw for lane group g (rpw = 2 at D = 128 in bf16).
    Returns [(step, row, cache slot)] in walk order."""
    live = read_end + 1
    units = -(-live // K7_UNIT)
    nloc = (units - c + n - 1) // n * K7_UNIT

    def slot_of(t):
        return (c + n * (t // K7_UNIT)) * K7_UNIT + t % K7_UNIT

    pos_s = []
    for t in range(nloc):
        sl = slot_of(t)
        if sl == ws:
            pos_s.append(0 if cur >= 0 and not quant else -1)
        else:
            pos_s.append(int(pos[sl]) if sl < live else -1)
    warps, per = 4, -(-nloc // 128) * 32
    stretch = [(min(w * per, nloc), min(min(w * per, nloc) + per, nloc))
               for w in range(warps)]
    counts = [sum(pos_s[t] >= 0 for t in range(lo, hi)) for lo, hi in stretch]
    listed = [None] * sum(counts)
    for w, (lo, hi) in enumerate(stretch):
        off = sum(counts[:w])
        for base in range(lo, hi, 32):
            ballot = [t < hi and pos_s[t] >= 0 for t in range(base, base + 32)]
            for lane, ok in enumerate(ballot):
                if ok:
                    listed[off + sum(ballot[:lane])] = base + lane
            off += sum(ballot)
    rows = []
    for i in range(-(-len(listed) // (2 * rpw))):
        for g in range(rpw):
            for u in range(2):
                j = i * 2 * rpw + g + u * rpw
                if j < len(listed):
                    rows.append((i, j, slot_of(listed[j])))
    return rows


def k7_model(q, kn, vn, cur, k, v, pos, read_end, ws, ks=None, vs=None,
             ksn=None, vsn=None, n=None):
    """K7's decomposition over lanes: q (B, H, D), new rows (B, 1, H*D),
    PRE-insert caches (B, S, H*D), written in place at ws as the kernel
    does, pos POST-insert (B, S). Working type: the chunk that owns ws
    takes its K, V from the new row, valid iff cur >= 0; int8: ws stays out
    of the chunks and the new row (times its scales) merges after them.
    Past K7_LONG_SLOTS slots each chunk takes the slots of its compacted
    walk (k7_long_walk) alone. n: the chunk count (k7_split's if None).
    Returns out, m, l."""
    b, h, d = q.shape
    s = k.shape[1]
    quant = ks is not None
    kh, vh = k.float().clone(), v.float().clone()
    ok = pos >= 0
    ok[:, ws] = (cur >= 0) & (not quant)
    if not quant:
        kh[:, ws], vh[:, ws] = kn[:, 0].float(), vn[:, 0].float()
    kh, vh = kh.view(b, s, h, d), vh.view(b, s, h, d)
    n = k7_split(read_end, s, b) if n is None else n
    parts = []
    for c in range(n):
        if s > K7_LONG_SLOTS:
            parts.append(k7_long_partial(q, kh, vh, cur, pos, read_end, ws,
                                         n, c, ks, vs))
            continue
        i = chunk_slots(c, n, read_end + 1, K7_UNIT)
        lg = torch.einsum("bhd,bshd->bhs", q.float(), kh[:, i]) \
            / math.sqrt(d)
        vals = vh[:, i].permute(0, 2, 1, 3)
        if quant:
            lg = lg * ks[:, None, i]
            vals = vals * vs[:, None, i, None]
        lg = lg.masked_fill(~ok[:, None, i], NEG)
        parts.append(flash_partial(lg, vals))
    if quant:
        knf = (kn[:, 0].float() * ksn[:, None]).view(b, h, d)
        vnf = (vn[:, 0].float() * vsn[:, None]).view(b, h, 1, d)
        lg = (q.float() * knf).sum(-1, keepdim=True) / math.sqrt(d)
        lg = lg.masked_fill((cur < 0)[:, None, None], NEG)
        parts.append(flash_partial(lg, vnf))
    k[:, ws], v[:, ws] = kn[:, 0], vn[:, 0]
    if quant:
        ks[:, ws], vs[:, ws] = ksn, vsn
    return merge_chunks(parts)


def k7_long_partial(q, kh, vh, cur, pos, read_end, ws, n, c, ks, vs):
    """Chunk c's partial over each lane's walked slots alone (no mask: the
    walk holds attended slots only; a lane with none gives m = -inf)."""
    b, h, d = q.shape
    out = []
    for i in range(b):
        rows = [sl for _, _, sl in k7_long_walk(
            pos[i], int(cur[i]), ws, read_end, n, c, ks is not None)]
        idx = torch.tensor(rows or [0], dtype=torch.long)
        lg = torch.einsum("hd,khd->hk", q[i].float(), kh[i, idx]) \
            / math.sqrt(d)
        vals = vh[i, idx].permute(1, 0, 2)
        if ks is not None:
            lg = lg * ks[i, idx]
            vals = vals * vs[i, idx, None]
        if not rows:
            lg = torch.full_like(lg, NEG)
        out.append(flash_partial(lg, vals))
    return tuple(torch.stack(x) for x in zip(*out))


def k7_inputs(rng, b, s, h, d, mode, ws, int8):
    """One K7 call's inputs, as chip_smoke.py's k7_case makes them: ring
    mode reads every slot and ws holds a stale row; linear mode reads up
    to ws, lanes of different lengths; padding holes; lane 1 an invalid
    new row, lane 2 idle (nothing attended) when there are lanes enough."""
    q = torch.from_numpy(rng.randn(b, h, d).astype(np.float32))
    _, k, v, ks, vs = k1_inputs(rng, b, s, h, d, int8)
    _, kn, vn, ksn, vsn = k1_inputs(rng, b, 1, h, d, int8)
    read_end = s - 1 if mode == "ring" else ws
    pos = torch.arange(s, dtype=torch.int32).repeat(b, 1) + 500
    if mode == "linear":
        pos[:, ws + 1:] = -1
        for i in range(b):
            pos[i, : (i * 37) % max(ws, 1)] = -1
    pos[::3, 40:60] = -1
    cur = pos[:, ws] + 10 ** 4
    if b > 1:
        cur[1] = -1
    if b > 2:
        pos[2], cur[2] = -1, -1
    pos[:, ws] = cur
    if int8:
        ks[:, ws] = vs[:, ws] = 1e3          # stale scales: never read
        ksn, vsn = ksn[:, 0].contiguous(), vsn[:, 0].contiguous()
    return q, kn, vn, cur, k, v, pos, read_end, ks, vs, ksn, vsn


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("mode,ws", [("ring", 0), ("ring", 64), ("ring", 255),
                                     ("ring", 100), ("linear", 0),
                                     ("linear", 63), ("linear", 64),
                                     ("linear", 255), ("linear", 200)])
def test_k7_model_equals_plain(int8, mode, ws):
    """Solo, 3 lanes and K7_MANY_LANES + 1 lanes (the split of many lanes):
    write slot at 0, at chunk boundaries (units of 8) and at read_end or
    S - 1; an invalid new row (lane 1), an idle lane (lane 2: out 0, m =
    -inf, l = 0); out, m and l, and the caches and scale rows after the
    insert."""
    rng = np.random.RandomState(ws + 7 * int8 + len(mode))
    h, d, s = 2, 64, 256
    for b in (1, 3, K7_MANY_LANES + 1):
        q, kn, vn, cur, k, v, pos, re_, ks, vs, ksn, vsn = k7_inputs(
            rng, b, s, h, d, mode, ws, int8)
        k2, v2 = k.clone(), v.clone()
        kw = {}
        if int8:
            kw = dict(k_scale=ks.clone(), v_scale=vs.clone(), ks_new=ksn,
                      vs_new=vsn)
        out, m, l = k7_model(q, kn, vn, cur, k, v, pos, re_, ws, ks, vs,
                             ksn, vsn)
        want, wm, wl = decode_insert_attention_plain(
            q, kn, vn, cur, k2, v2, pos, re_, ws, stats=True, **kw)
        plain_out = decode_insert_attention_plain(
            q, kn, vn, cur, k2.clone(), v2.clone(), pos, re_, ws, **{
                key: val.clone() for key, val in kw.items()})
        assert torch.equal(k, k2) and torch.equal(v, v2)
        if int8:
            assert torch.equal(ks, kw["k_scale"])
            assert torch.equal(vs, kw["v_scale"])
        assert torch.isfinite(out).all()
        np.testing.assert_allclose(out.numpy(), want.numpy(), atol=ATOL)
        np.testing.assert_allclose(out.numpy(), plain_out.numpy(), atol=ATOL)
        assert torch.equal(torch.isneginf(m), torch.isneginf(wm))
        live = torch.isfinite(wm)
        np.testing.assert_allclose(m[live].numpy(), wm[live].numpy(),
                                   atol=ATOL)
        np.testing.assert_allclose(l.numpy(), wl.numpy(), rtol=ATOL)
        if b > 2:
            assert (out[2] == 0).all() and (l[2] == 0).all()
            assert torch.isneginf(m[2]).all()
        if b > K7_MANY_LANES:
            # each lane is its own solo call, within summation order
            for i in (0, b - 1):
                sl = slice(i, i + 1)
                args = [t[sl] for t in (q, kn, vn, cur)]
                kc, vc = k2[sl].clone(), v2[sl].clone()
                kc[:, ws] = torch.from_numpy(rng.randn(*kc[:, ws].shape)
                                             .astype(np.float32)).to(kc.dtype)
                sc = {}
                if int8:
                    sc = dict(k_scale=kw["k_scale"][sl].clone(),
                              v_scale=kw["v_scale"][sl].clone(),
                              ks_new=ksn[sl], vs_new=vsn[sl])
                solo = k7_model(*args, kc, vc, pos[sl], re_, ws,
                                *(sc.get(x) for x in ("k_scale", "v_scale",
                                                      "ks_new", "vs_new")))
                np.testing.assert_allclose(solo[0].numpy(), out[sl].numpy(),
                                           atol=ATOL)


def k7_long_inputs(rng, h, int8, s=3072, context=3000, ws=1500, d=128):
    """A Moshi-shaped call: an S-slot ring whose write slot ws is mid-ring,
    each lane holding its last positions before the new row, those
    `context` or more back left out (-1), as models/moshi._temporal keeps
    them. Lanes: 700 positions; idle (every pos -1, cur -1); past the
    window (3,500 steps: 2,999 held, wrapped round the ring); 2,250 (the
    longest call); 1 (the new row alone)."""
    fills = (700, -1, 3500, 2250, 0)
    b = len(fills)
    q, k, v, ks, vs = k1_inputs(rng, b, s, h, d, int8)
    _, kn, vn, ksn, vsn = k1_inputs(rng, b, 1, h, d, int8)
    pos = torch.full((b, s), -1, dtype=torch.int32)
    cur = torch.full((b,), -1, dtype=torch.int32)
    for i, fill in enumerate(fills):
        if fill < 0:
            continue
        cur[i] = fill
        for j in range(1, min(fill, context - 1) + 1):
            pos[i, (ws - j) % s] = fill - j
    pos[:, ws] = cur
    if int8:
        ks[:, ws] = vs[:, ws] = 1e3          # stale scales: never read
        ksn, vsn = ksn[:, 0].contiguous(), vsn[:, 0].contiguous()
    return q, kn, vn, cur, k, v, pos, s - 1, ks, vs, ksn, vsn


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("n", range(1, MAX_SPLITS + 1))
def test_k7_long_walk_reads_each_attended_slot_once(n, int8):
    """Over a chunk count n, the long-ring walks of a lane's n chunks read
    every attended slot once and no other, each chunk's slots in the walk
    order of its compacted list (increasing local slots); the write slot
    is walked iff the new row is valid, never with int8 (merged after the
    cluster); an idle lane walks nothing; a lane past the window 2,999
    slots."""
    q, kn, vn, cur, k, v, pos, re_, ks, vs, ksn, vsn = k7_long_inputs(
        np.random.RandomState(n), 2, int8)
    ws = 1500
    for i in range(q.shape[0]):
        want = {int(x) for x in torch.nonzero(pos[i] >= 0)}
        if int8:
            want.discard(ws)
        seen = []
        for c in range(n):
            walk = k7_long_walk(pos[i], int(cur[i]), ws, re_, n, c, int8)
            rows = [j for _, j, _ in walk]
            slots = [sl for _, _, sl in sorted(walk, key=lambda r: r[1])]
            # rows 0..R-1 once each, 4 a step; the list in slot order; the
            # chunk's own units
            assert sorted(rows) == list(range(len(walk)))
            assert all(j // 4 == step for step, j, _ in walk)
            assert slots == sorted(slots)
            assert all(sl // K7_UNIT % n == c for sl in slots)
            seen += slots
        assert len(seen) == len(set(seen)) and set(seen) == want
    assert (pos[1] < 0).all() and int(cur[1]) == -1
    assert int((pos[2] >= 0).sum()) == 3000    # 2,999 held + the new row


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("n", range(1, MAX_SPLITS + 1))
def test_k7_long_model_equals_plain(n, int8):
    """The plain model of the long-ring decomposition (each chunk's
    compacted walk, merged in chunk order; int8: the new row after the
    cluster) equals decode_insert_attention_plain within 1e-6 in f32 at
    D = 128, S = 3,072, n chunks (out; m within 1e-6 of itself; l, a sum of
    up to 3,000 terms, within 4e-6 of itself), with the statistics, the
    caches and scale rows after the insert; the idle lane gives out 0, m =
    -inf, l = 0."""
    rng = np.random.RandomState(100 + n + 9 * int8)
    q, kn, vn, cur, k, v, pos, re_, ks, vs, ksn, vsn = k7_long_inputs(
        rng, 2, int8)
    ws = 1500
    k2, v2 = k.clone(), v.clone()
    kw = {}
    if int8:
        kw = dict(k_scale=ks.clone(), v_scale=vs.clone(), ks_new=ksn,
                  vs_new=vsn)
    out, m, l = k7_model(q, kn, vn, cur, k, v, pos, re_, ws, ks, vs, ksn,
                         vsn, n=n)
    want, wm, wl = decode_insert_attention_plain(
        q, kn, vn, cur, k2, v2, pos, re_, ws, stats=True, **kw)
    assert torch.equal(k, k2) and torch.equal(v, v2)
    if int8:
        assert torch.equal(ks, kw["k_scale"])
        assert torch.equal(vs, kw["v_scale"])
    np.testing.assert_allclose(out.numpy(), want.numpy(), atol=ATOL)
    assert torch.equal(torch.isneginf(m), torch.isneginf(wm))
    live = torch.isfinite(wm)
    # m: D = 128 dot products summed in another order (a few ulps at ~5)
    np.testing.assert_allclose(m[live].numpy(), wm[live].numpy(), atol=ATOL,
                               rtol=ATOL)
    # l: f32 sums of up to 3,000 terms in another order, ~sqrt(3000) ulps
    np.testing.assert_allclose(l.numpy(), wl.numpy(), rtol=4e-6)
    assert (out[1] == 0).all() and (l[1] == 0).all()
    assert torch.isneginf(m[1]).all()
