"""How the cooperative layer-tail kernels K5b, K5c and K8 (csrc/layer_post.cuh,
csrc/fused_layer.cu, csrc/megalayer.cu) cut their work, checked on the CPU:

- `fused_layer.post_plan` (K5b, K5c) and `fused_step.mega_plan` (K8) at
  DEFAULT_CONFIG's and tiny_config(64)'s widths, for int8, int4 and q4_0
  weights and every row count the cooperative route takes: each stored
  weight byte of W_o, W1, W2 (K8: and W_in; K5c: and layer l + 1's
  in_proj) belongs to exactly one block, the grid is at most 132 blocks,
  and a block's shared memory (TMA destinations 128-byte aligned) is at
  most 232448 bytes, K8 with caches of 1, 2 and 4-byte elements;
- the plan is the one source of the shared-memory layout: each region it
  places holds the units the kernel puts there, as the kernels' entry
  points check (`regions_ok`), aligned and not overlapping;
- `chunk_bounds`: K8's chunks of the live slots cover each slot once;
- a numpy model of the new summation order (out_proj slices summed in
  slice order, each block's MLP tiles into its partial, the partials
  summed in lane classes and a butterfly as `mlp_finish` sums them) equals
  `post_attention_plain` and the JAX package's `post_attention` in f32
  within 1e-5;
- a numpy model of K8's attention over (head, chunk) blocks, each chunk
  a flash loop over tiles of K8_TILE slots, merged in chunk order with the
  new row last (an empty chunk weighs 0), equals `megalayer_plain` and the
  JAX package's `megalayer` (interpret mode) in f32 within 1e-5, with an
  empty chunk, the write slot inside a chunk, and cur_pos < 0.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from scipy.special import erf

from pocket_tts_tpu.config import tiny_config as j_tiny_config
from pocket_tts_tpu.io.params import params_from_flat, random_flat
from pocket_tts_tpu.io.quant import quantize_params as j_quantize
from pocket_tts_tpu.ops import fused_layer as j_fused_layer
from pocket_tts_tpu.ops import fused_step as j_fused_step
from pocket_tts_tpu.ops.basic import slice_layer_params as j_slice
from pocket_tts_tpu_torch.config import DEFAULT_CONFIG
from pocket_tts_tpu_torch.io.params import from_jax_numpy
from pocket_tts_tpu_torch.ops import fused_layer, fused_step
from pocket_tts_tpu_torch.ops.basic import (quantize_rows,
                                            slice_layer_params)
from pocket_tts_tpu_torch.ops.quant_matmul import (INT4, INT4_GROUPED, INT8,
                                                   grouped, unpack_int4)
from pocket_tts_tpu_torch.ops.rope import apply_rope_halves, rope_cos_sin

torch.set_num_threads(1)
REL = 1e-5
SMEM_MAX = 232448
CFG0 = j_tiny_config(64)
PJ, CFG = params_from_flat(random_flat(CFG0, seed=71), CFG0)
KINDS = {"int8": (dict(bits=8), INT8, 0), "int4": (dict(bits=4), INT4, 0),
         "q4_0": (dict(bits=4, group=32), INT4_GROUPED, 32)}
_TREES = {}


def trees(kind):
    """(JAX, port) tiny_config(64) params quantized the same way."""
    if kind not in _TREES:
        qj = j_quantize(PJ, **KINDS[kind][0])
        _TREES[kind] = (qj, from_jax_numpy(jax.tree.map(np.asarray, qj)))
    return _TREES[kind]


def _tails(cfg):
    """(d_model, hidden, the rows a solo call gives) of the backbone and
    the mimi decoder transformer."""
    return ((cfg.backbone.d_model, cfg.backbone.hidden_dim, 1),
            (cfg.mimi.transformer.d_model, cfg.mimi.transformer.hidden_dim,
             16))


def _rows_taken(dm):
    """Row counts the cooperative route takes at width dm (post_launches
    == 1): every one up to 4, then powers of two and the edges."""
    top = fused_layer.ROW_FLOATS // dm
    return sorted({t for t in (1, 2, 3, 4, 8, 15, 16, 32, 64, 128, top)
                   if 1 <= t <= top})


def _col_cover(cover, ntiles, ks, grid, stored):
    """Count the stored bytes of a column-tile phase's units per block."""
    srows = stored // ks
    for b in range(grid):
        for ct, q in fused_layer.col_units(ntiles, ks, grid, b):
            cover[q * srows:(q + 1) * srows, 32 * ct:32 * ct + 32] += 1


def _mlp_cover(w1, w2, hid, grid, packed):
    """Count W1's and W2's stored bytes per block's MLP tiles."""
    for b in range(grid):
        for t in range(b, hid // 32, grid):
            if packed:
                w1[:, 16 * t:16 * t + 16] += 1
                w1[:, hid // 2 + 16 * t:hid // 2 + 16 * t + 16] += 1
                w2[16 * t:16 * t + 16] += 1
            else:
                w1[:, 32 * t:32 * t + 32] += 1
                w2[32 * t:32 * t + 32] += 1


def _check_layout(plan, keys):
    """Regions in order, 128-byte aligned (TMA destinations), within the
    card's shared memory."""
    offs = [plan[k] for k in keys]
    assert offs == sorted(offs)
    assert all(o % 128 == 0 for o in offs), plan
    assert plan["smem"] <= SMEM_MAX, plan
    assert 1 <= plan["grid"] <= fused_layer.COOP_MAX_GRID


@pytest.mark.parametrize("kind", list(KINDS))
@pytest.mark.parametrize("cfg", [DEFAULT_CONFIG, CFG], ids=["default",
                                                             "tiny64"])
def test_post_plan_covers_every_weight_byte_once(cfg, kind):
    _, code, group = KINDS[kind]
    packed = code != INT8
    for dm, hid, _ in _tails(cfg):
        stored = dm // 2 if packed else dm
        for t in _rows_taken(dm):
            plan = fused_layer.post_plan(t, dm, hid, code, group)
            g = plan["grid"]
            wo = np.zeros((stored, dm), int)
            _col_cover(wo, dm // 32, plan["ks_o"], g, stored)
            w1 = np.zeros((stored, hid), int)
            w2 = np.zeros((hid // 2 if packed else hid, dm), int)
            _mlp_cover(w1, w2, hid, g, packed)
            for name, c in (("W_o", wo), ("W1", w1), ("W2", w2)):
                assert (c == 1).all(), (name, dm, hid, t, plan)
            assert g == min(fused_layer.COOP_MAX_GRID, hid // 32)


@pytest.mark.parametrize("kind", list(KINDS))
@pytest.mark.parametrize("cfg", [DEFAULT_CONFIG, CFG], ids=["default",
                                                             "tiny64"])
def test_post_plan_fits_shared_memory(cfg, kind):
    _, code, group = KINDS[kind]
    for dm, hid, _ in _tails(cfg):
        for t in _rows_taken(dm):
            plan = fused_layer.post_plan(t, dm, hid, code, group)
            _check_layout(plan, ("o_wo", "o_w1", "o_w2", "o_nx", "o_act"))
            # the units' rows split in whole TMA boxes and q4_0 groups
            srows = (dm // 2 if code != INT8 else dm) // plan["ks_o"]
            assert srows % 32 == 0 and srows % min(256, srows) == 0
            assert plan["ks_o"] == 1 or t == 1
            assert plan["fin_e"] in (1, 2, 4, 8)


@pytest.mark.parametrize("kind", ["int4", "q4_0"])
@pytest.mark.parametrize("cfg", [DEFAULT_CONFIG, CFG], ids=["default",
                                                             "tiny64"])
def test_bilayer_plan_covers_the_next_in_proj(cfg, kind):
    _, code, group = KINDS[kind]
    dm, hid = cfg.backbone.d_model, cfg.backbone.hidden_dim
    plan = fused_layer.post_plan(1, dm, hid, code, group, n_next=3 * dm)
    _check_layout(plan, ("o_wo", "o_w1", "o_w2", "o_nx", "o_act"))
    win = np.zeros((dm // 2, 3 * dm), int)
    _col_cover(win, 3 * dm // 32, 1, plan["grid"], dm // 2)
    assert (win == 1).all()
    # K5b's regions are K5c's up to the next layer's units
    solo = fused_layer.post_plan(1, dm, hid, code, group)
    assert [solo[k] for k in ("o_w1", "o_w2", "o_nx")] == \
        [plan[k] for k in ("o_w1", "o_w2", "o_nx")]


@pytest.mark.parametrize("kv_bytes", [1, 2, 4])
@pytest.mark.parametrize("kind", ["int8", "int4"])
@pytest.mark.parametrize("cfg", [DEFAULT_CONFIG, CFG], ids=["default",
                                                             "tiny64"])
def test_mega_plan_covers_and_fits(cfg, kind, kv_bytes):
    _, code, _ = KINDS[kind]
    bb = cfg.backbone
    dm, hid, nh = bb.d_model, bb.hidden_dim, bb.num_heads
    plan = fused_step.mega_plan(dm, hid, code, nh, kv_bytes)
    _check_layout(plan, ("o_win", "o_wo", "o_w1", "o_w2", "o_act"))
    g, stored = plan["grid"], dm // 2 if code != INT8 else dm
    assert g >= nh and plan["nck"] == g // nh and nh * plan["nck"] <= g
    covers = {}
    for name, n, ks in (("W_in", 3 * dm, plan["ks_in"]),
                        ("W_o", dm, plan["ks_o"])):
        c = np.zeros((stored, n), int)
        _col_cover(c, n // 32, ks, g, stored)
        covers[name] = c
    w1 = np.zeros((stored, hid), int)
    w2 = np.zeros((hid // 2 if code != INT8 else hid, dm), int)
    _mlp_cover(w1, w2, hid, g, code != INT8)
    covers.update(W1=w1, W2=w2)
    for name, c in covers.items():
        assert (c == 1).all(), name


def _regions_hold(plan, regions):
    """The plan's regions [(offset key, units, bytes a unit)] hold their
    units as the kernels' entry points check (csrc/layer_post.cuh
    `regions_ok`): 128-byte aligned units, none overlapping another, all
    below smem less the alignment slack."""
    spans = []
    for key, n, unit in regions:
        off = plan[key]
        assert off % 128 == 0 and (n <= 1 or unit % 128 == 0), (key, plan)
        if n * unit:
            spans.append((off, off + n * unit, key))
    spans.sort()
    for (_, end, key), (start, _, nxt) in zip(spans, spans[1:]):
        assert end <= start, (key, nxt, plan)
    assert spans[-1][1] <= plan["smem"] - fused_layer.SMEM_SLACK, plan


def _tail_regions(plan, dm, hid, code, group):
    g = plan["grid"]
    w1b, w2b = fused_layer.mlp_tile_bytes(code, dm, group)
    nb_h = -(-(hid // 32) // g)
    return [("o_wo", -(-(dm // 32) * plan["ks_o"] // g),
             fused_layer.col_unit_bytes(code, dm, plan["ks_o"], group)),
            ("o_w1", nb_h, w1b), ("o_w2", nb_h, w2b)]


@pytest.mark.parametrize("kind", list(KINDS))
@pytest.mark.parametrize("cfg", [DEFAULT_CONFIG, CFG], ids=["default",
                                                             "tiny64"])
def test_post_plan_regions_hold_what_the_kernel_puts_there(cfg, kind):
    _, code, group = KINDS[kind]
    for dm, hid, _ in _tails(cfg):
        cases = [(t, 0) for t in _rows_taken(dm)]
        if code != INT8:
            cases.append((1, 3 * dm))  # K5c: layer l + 1's in_proj units
        for t, n_next in cases:
            plan = fused_layer.post_plan(t, dm, hid, code, group, n_next)
            _regions_hold(plan, _tail_regions(plan, dm, hid, code, group) + [
                ("o_nx", -(-(n_next // 32) // plan["grid"]),
                 fused_layer.col_unit_bytes(code, dm, 1, group)),
                ("o_act", 1, fused_layer.act_bytes(t, dm))])


@pytest.mark.parametrize("kv_bytes", [1, 2, 4])
@pytest.mark.parametrize("kind", ["int8", "int4"])
@pytest.mark.parametrize("cfg", [DEFAULT_CONFIG, CFG], ids=["default",
                                                             "tiny64"])
def test_mega_plan_regions_hold_what_the_kernel_puts_there(cfg, kind,
                                                           kv_bytes):
    _, code, _ = KINDS[kind]
    bb = cfg.backbone
    dm, hid, nh = bb.d_model, bb.hidden_dim, bb.num_heads
    plan = fused_step.mega_plan(dm, hid, code, nh, kv_bytes)
    merge = 4 * nh * (plan["nck"] + 1) * fused_step.PART_FLOATS
    act = max(fused_layer.act_bytes(1, dm) + merge,
              4 * fused_step.attend_floats(dm, 64, kv_bytes))
    _regions_hold(plan, _tail_regions(plan, dm, hid, code, 0) + [
        ("o_win", -(-(3 * dm // 32) * plan["ks_in"] // plan["grid"]),
         fused_layer.col_unit_bytes(code, dm, plan["ks_in"], 0)),
        ("o_act", 1, act)])


@pytest.mark.parametrize("read_end", [0, 2, 3, 100, 127, 300, 1023])
def test_chunk_bounds_cover_the_live_slots_once(read_end):
    for nck in (1, 4, 8):
        seen = np.zeros(read_end + 1, int)
        for c in range(nck):
            lo, hi = fused_step.chunk_bounds(read_end, nck, c)
            assert 0 <= lo <= hi <= read_end + 1
            seen[lo:hi] += 1
        assert (seen == 1).all()


# ------------------------------------------------- numpy models, float32 ---

def _deq(lin):
    """(W (K, N) float32 with grouped scales applied, per-channel scale or
    ones, bias or zeros) of one layer's quantized linear."""
    if "q" in lin:
        w = lin["q"].float().numpy()
    else:
        w = unpack_int4(lin["q4"]).numpy()
        if grouped(lin):
            s = lin["scale"].float().numpy()
            w = w * np.repeat(s, w.shape[0] // s.shape[0], axis=0)
    n = w.shape[1]
    pc = (np.ones(n, np.float32) if grouped(lin)
          else lin["scale"].float().numpy())
    b = lin.get("b")
    return (w.astype(np.float32), pc.astype(np.float32),
            np.zeros(n, np.float32) if b is None else b.float().numpy())


def _vec(p, name, key, n, dflt):
    v = p.get(name, {}).get(key)
    return np.full(n, dflt, np.float32) if v is None else v.float().numpy()


def _ln(x, scale, bias, eps):
    mean = x.mean(-1, keepdims=True)
    var = ((x - mean) ** 2).mean(-1, keepdims=True)
    return (x - mean) / np.sqrt(var + eps) * scale + bias


def _gelu(v):
    return (0.5 * v * (1.0 + erf(v / np.sqrt(2.0)))).astype(np.float32)


def _slice_rows(stored, ks, q, packed):
    """Logical rows of stored-row slice q of ks."""
    sr = stored // ks
    rows = np.arange(q * sr, (q + 1) * sr)
    return np.concatenate([rows, stored + rows]) if packed else rows


def _tile_units(hid, t, packed):
    """Hidden units of MLP tile t, in the h tile's column order."""
    if packed:
        return np.concatenate([np.arange(16 * t, 16 * t + 16),
                               hid // 2 + np.arange(16 * t, 16 * t + 16)])
    return np.arange(32 * t, 32 * t + 32)


def finish_sum(parts, fin_e):
    """The grid's partials summed as mlp_finish sums them: lane class gq
    walks partials gq, gq + 32 / fin_e, ... in order; the classes' sums
    meet in a butterfly (pairs of neighbours, then pairs of pairs)."""
    gq = 32 // fin_e
    sums = []
    for c in range(gq):
        v = np.zeros_like(parts[0])
        for g in range(c, len(parts), gq):
            v = v + parts[g]
        sums.append(v)
    while len(sums) > 1:
        sums = [sums[i] + sums[i + 1] for i in range(0, len(sums), 2)]
    return sums[0]


def tail_model(p, x, attn, eps, plan, packed):
    """out_proj units -> slices summed in order -> x1; LN; each block's MLP
    tiles into its partial; finish_sum; the residual. f32, where rounding
    to the working type (and K8's h kept unrounded at int4) is exact."""
    wo, so, bo = _deq(p["out_proj"])
    w1, s1, b1 = _deq(p["linear1"])
    w2, s2, b2 = _deq(p["linear2"])
    dm, hid = wo.shape[1], w1.shape[1]
    stored = dm // 2 if packed else dm
    ls1 = _vec(p, "layer_scale_1", "scale", dm, 1.0)
    ls2 = _vec(p, "layer_scale_2", "scale", dm, 1.0)
    v = np.zeros_like(x)
    for q in range(plan["ks_o"]):
        rows = _slice_rows(stored, plan["ks_o"], q, packed)
        v = v + attn[:, rows] @ wo[rows]
    x1 = x + ls1 * (v * so + bo)
    ln = _ln(x1, _vec(p, "norm2", "scale", dm, 1.0),
             _vec(p, "norm2", "bias", dm, 0.0), eps)
    parts = []
    for b in range(plan["grid"]):
        part = np.zeros_like(x)
        for t in range(b, hid // 32, plan["grid"]):
            units = _tile_units(hid, t, packed)
            h = _gelu(ln @ w1[:, units] * s1[units] + b1[units])
            part = part + h @ w2[units]
        parts.append(part)
    up = finish_sum(parts, plan["fin_e"])
    return x1 + ls2 * (up * s2 + b2)


def close_rel(got, want):
    want = np.asarray(want, dtype=np.float32)
    scale = np.abs(want).max()
    np.testing.assert_allclose(np.asarray(got) / scale, want / scale,
                               atol=REL, rtol=0)


def _layer(kind, which):
    qj, qt = trees(kind)
    if which == "backbone":
        sj, st, eps, t = qj["layers"], qt["layers"], 1e-5, 1
    else:
        sj = qj["mimi"]["decoder_transformer"]["layers"]
        st = qt["mimi"]["decoder_transformer"]["layers"]
        eps, t = CFG.mimi.transformer.norm_eps, 16
    return j_slice(sj, 1), slice_layer_params(st, 1), eps, t


@pytest.mark.parametrize("kind", list(KINDS))
@pytest.mark.parametrize("which", ["backbone", "mimi"])
def test_tail_model_equals_plain_and_jax(which, kind):
    pj, pt, eps, t = _layer(kind, which)
    _, code, group = KINDS[kind]
    dm = pt["norm1"]["scale"].shape[0]
    hid = pt["linear1"]["scale"].shape[-1]
    rng = np.random.RandomState(t + len(kind))
    x = (rng.randn(t, dm) * 0.5).astype(np.float32)
    attn = (rng.randn(t, dm) * 0.5).astype(np.float32)
    plan = fused_layer.post_plan(t, dm, hid, code, group)
    got = tail_model(pt, x, attn, eps, plan, code != INT8)
    close_rel(got, fused_layer.post_attention_plain(
        pt, torch.from_numpy(x), torch.from_numpy(attn), eps))
    close_rel(got, j_fused_layer.post_attention(
        pj, jnp.asarray(x), jnp.asarray(attn), eps=eps, interpret=True))


@pytest.mark.parametrize("fin_e", [1, 2, 4, 8])
def test_finish_sum_is_a_sum_of_every_partial(fin_e):
    parts = [np.float32(2.0 ** -i) * np.ones(3, np.float32)
             for i in range(20)]
    np.testing.assert_allclose(finish_sum(parts, fin_e),
                               sum(2.0 ** -i for i in range(20)), rtol=1e-6)


# K8: the layer with its attention as the (head, chunk) blocks compute it

def attend_model(q, kf, vf, kscale, vscale, pos, read_end, ws, knew, vnew,
                 live, nck):
    """Per head: each chunk's flash loop over tiles of K8_TILE slots (the
    write slot and slots with pos < 0 skipped) -> (m, l, acc); the new
    row's partial (its logit, 1, its V row; m = -inf, l = 0 when not
    live) last; merged in chunk order. q, knew, vnew (h, d); kf, vf (S, h,
    d) as the cache stores them; kscale, vscale (S,) or None."""
    h, d = q.shape
    scale = np.float32(1.0 / np.sqrt(d))
    out = np.zeros((h, d), np.float32)
    for hh in range(h):
        parts = []
        for c in range(nck):
            lo, hi = fused_step.chunk_bounds(read_end, nck, c)
            m, l, acc = -np.inf, np.float32(0), np.zeros(d, np.float32)
            for base in range(lo, hi, fused_step.K8_TILE):
                s = np.arange(base, min(hi, base + fused_step.K8_TILE))
                ok = (s != ws) & (pos[s] >= 0)
                lg = (kf[s, hh] @ q[hh]) * scale
                if kscale is not None:
                    lg = lg * kscale[s]
                lg = np.where(ok, lg, -np.inf).astype(np.float32)
                m_new = max(m, lg.max())
                if m_new == -np.inf:
                    continue
                corr = np.float32(np.exp(m - m_new))
                pw = np.exp(lg - m_new).astype(np.float32)
                l = l * corr + pw.sum()
                wv = pw * (vscale[s] if vscale is not None else 1.0)
                acc = acc * corr + wv @ vf[s, hh]
                m = m_new
            parts.append((m, l, acc))
        parts.append(((knew[hh] @ q[hh]) * scale, np.float32(1), vnew[hh])
                     if live else (-np.inf, np.float32(0),
                                   np.zeros(d, np.float32)))
        mx = max(pm for pm, _, _ in parts)
        l, acc = np.float32(0), np.zeros(d, np.float32)
        for pm, pl, pa in parts:
            wgt = np.float32(0) if mx == -np.inf else np.exp(pm - mx)
            l, acc = l + pl * wgt, acc + pa * wgt
        out[hh] = acc / max(l, 1e-30)
    return out


def mega_model(p, x, cos, sin, live, kc, vc, ks, vs, pos, read_end, ws,
               nck, plan, packed):
    """K8 in f32: LN1, in_proj, rope, the new row (int8: quantized as the
    cache stores it), attend_model, then the layer tail as tail_model."""
    dm = x.shape[-1]
    d = 2 * cos.shape[-1]
    h = dm // d
    win, sin_, bin_ = _deq(p["in_proj"])
    ln1 = _ln(x, _vec(p, "norm1", "scale", dm, 1.0),
              _vec(p, "norm1", "bias", dm, 0.0), 1e-5)
    row = ln1 @ win * sin_ + bin_
    rq, rk, rv = np.split(row, 3, -1)
    rot = lambda r: apply_rope_halves(torch.from_numpy(r.reshape(1, h, d)),
                                      torch.from_numpy(cos),
                                      torch.from_numpy(sin)).numpy()[0]
    q, k, v = rot(rq), rot(rk), rv.reshape(h, d)
    if ks is not None:
        (kn, kns), (vn, vns) = (quantize_rows(torch.from_numpy(
            a.reshape(1, dm))) for a in (k, v))
        knew = (kn.float().numpy() * kns.numpy()[:, None]).reshape(h, d)
        vnew = (vn.float().numpy() * vns.numpy()[:, None]).reshape(h, d)
    else:
        knew, vnew = k, v
    s = kc.shape[0]
    attn = attend_model(q, kc.reshape(s, h, d).astype(np.float32),
                        vc.reshape(s, h, d).astype(np.float32), ks, vs, pos,
                        read_end, ws, knew, vnew, live, nck)
    tail = dict(p, layer_scale_1={}, layer_scale_2={})
    return tail_model(tail, x, attn.reshape(1, dm), 1e-5, plan, packed)


@pytest.mark.parametrize("case", ["ws_inside", "empty_chunk", "cur_pos_neg"])
@pytest.mark.parametrize("kvq", [False, True])
@pytest.mark.parametrize("kind", ["int8", "int4"])
def test_mega_model_equals_plain_and_jax(kind, kvq, case):
    qj, qt = trees(kind)
    _, code, _ = KINDS[kind]
    bb = CFG.backbone
    s, dm = bb.kv_capacity, bb.d_model
    read_end, ws = {"ws_inside": (100, 37), "empty_chunk": (2, 2),
                    "cur_pos_neg": (100, 100)}[case]
    r = np.random.RandomState(len(case) + 2 * kvq)
    x = (r.randn(1, dm) * 0.5).astype(np.float32)
    if kvq:
        k, ks = (a.numpy() for a in quantize_rows(torch.from_numpy(
            r.randn(s, dm).astype(np.float32))))
        v, vs = (a.numpy() for a in quantize_rows(torch.from_numpy(
            r.randn(s, dm).astype(np.float32))))
        ks[ws] = vs[ws] = 1e3            # stale scales: never read
    else:
        k, v = (r.randn(s, dm).astype(np.float32) for _ in range(2))
        ks = vs = None
        k[ws], v[ws] = 1e3, -1e3         # stale row: never read
    pos = np.arange(s, dtype=np.int32) + 3
    pos[read_end + 1:] = -1
    pos[5:9] = -1
    cur = -1 if case == "cur_pos_neg" else int(pos[ws])
    cos, sin = (a.numpy() for a in rope_cos_sin(
        torch.tensor([max(cur, 0)], dtype=torch.int32), bb.head_dim,
        bb.max_period))
    hid = bb.hidden_dim
    plan = fused_step.mega_plan(dm, hid, code, bb.num_heads,
                                1 if kvq else 4)
    layer = 1
    pt, pj = slice_layer_params(qt["layers"], layer), j_slice(qj["layers"],
                                                              layer)
    got = mega_model(pt, x, cos, sin, cur >= 0, k, v, ks, vs, pos, read_end,
                     ws, plan["nck"], plan, code != INT8)
    caches = [torch.from_numpy(a.copy()) for a in (k, v)]
    scales = [torch.from_numpy(a.copy()) for a in (ks, vs)] if kvq else []
    want = fused_step.megalayer_plain(
        pt, torch.from_numpy(x), torch.from_numpy(cos), torch.from_numpy(sin),
        torch.tensor([cur], dtype=torch.int32), *caches,
        torch.from_numpy(pos), read_end, ws, *scales)
    close_rel(got, want)
    kw = (dict(k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs))
          if kvq else {})
    wj = j_fused_step.megalayer(pj, jnp.asarray(x), jnp.asarray(cos),
                                jnp.asarray(sin), jnp.int32(cur),
                                jnp.asarray(k), jnp.asarray(v),
                                jnp.asarray(pos), read_end, ws,
                                interpret=True, **kw)
    close_rel(got, wj[0])
