"""The int8 backbone KV cache and the shared-prefix partials of the port
against the JAX package, f32:

- `quantize_rows`: int8 rows and scales equal bit for bit;
- K1's int8-KV plain version vs `pallas_attn.decode_attention(...,
  k_scale=, v_scale=, interpret=True)` (atol 1e-5: both compute in f32 and
  differ in summation order only);
- K7's int8-KV plain version vs `decode_insert_attention(..., ks_new=,
  vs_new=, k_scale=, v_scale=, interpret=True)` vmapped over the lanes,
  linear and ring mode, one invalid lane: output within 1e-5, int8 caches
  and scale rows equal bit for bit;
- K7 stats (both cache types) vs the JAX kernel's `stats=True`: out, m and
  l within 1e-5 on every lane that attends a slot; a merge with
  `prefix_attn_stats` equals one softmax over the concatenated keys within
  1e-5, an all-masked lane included (it gives the prefix partial alone);
- `prefix_attn_stats`, `merge_attn_partials`, `sdpa_decode_seg_stats`,
  `sdpa_seg_stats` vs the JAX functions (1e-5);
- `split_prefix` of an int8-KV primed state vs the JAX one (1e-6).
"""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pocket_tts_tpu.config import tiny_config
from pocket_tts_tpu.io.params import params_from_flat, random_flat
from pocket_tts_tpu.models import backbone as jbb
from pocket_tts_tpu.ops import attention as jatt
from pocket_tts_tpu.ops.pallas_attn import decode_attention as jda
from pocket_tts_tpu.ops.pallas_attn import decode_insert_attention as jdia
from pocket_tts_tpu_torch.io.params import from_jax_numpy
from pocket_tts_tpu_torch.models import backbone as tbb
from pocket_tts_tpu_torch.ops import attention as tatt
from pocket_tts_tpu_torch.ops.decode_attn import decode_attention
from pocket_tts_tpu_torch.ops.insert_attn import decode_insert_attention

torch.set_num_threads(1)
ATOL = 1e-5
S, H, D, BS, B = 256, 4, 16, 64, 3


def t(a):
    return torch.from_numpy(np.array(a))


def quantized(rng, *shape):
    """Random int8 rows and their scales, as quantize_rows makes them."""
    x = rng.randn(*shape).astype(np.float32)
    q, s = jbb.quantize_rows(jnp.asarray(x.reshape(-1, shape[-1])))
    return (np.array(q).reshape(shape),
            np.array(s).reshape(shape[:-1]))


@pytest.mark.parametrize("scale", [1.0, 1e-3, 0.0])
def test_quantize_rows_bit_identical(scale):
    rng = np.random.RandomState(int(scale * 1000) + 1)
    x = (rng.randn(37, H * D) * scale).astype(np.float32)
    x[3, :5] = [0.5, -0.5, 1.5, 127.5, -2.5]       # rounding ties
    qj, sj = jbb.quantize_rows(jnp.asarray(x))
    qt, st = tbb.quantize_rows(t(x))
    assert qt.dtype == torch.int8 and st.dtype == torch.float32
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(st.numpy().view(np.int32),
                                  np.asarray(sj).view(np.int32))


# ------------------------------------------------------------------ K1-q --

@pytest.mark.parametrize("end", [100, 200])
def test_k1_kv8_plain_matches_pallas(end):
    rng = np.random.RandomState(end)
    q = rng.randn(H, D).astype(np.float32)
    k, ks = quantized(rng, S, H * D)
    v, vs = quantized(rng, S, H * D)
    pos = np.arange(S, dtype=np.int32)
    pos[end + 1:] = -1
    pos[10:17] = -1
    want = jda(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
               jnp.asarray(pos), end, block_size=BS, k_scale=jnp.asarray(ks),
               v_scale=jnp.asarray(vs), interpret=True)
    got = decode_attention(t(q), t(k), t(v), t(pos), end, t(ks), t(vs))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)


# ------------------------------------------------------------ K7-q, stats --

def k7_case(mode, seed, quant):
    """(q, k_new, v_new, cur_pos, k, v, pos, read_end, ws, ks_new, vs_new,
    ks, vs) as numpy; lane 2 carries an invalid new row. linear: lanes of
    different live lengths with holes; ring: every slot live, the write
    slot stale (garbage bytes and scale)."""
    r = np.random.RandomState(seed)
    q = r.randn(B, H, D).astype(np.float32)
    if quant:
        kn, ksn = quantized(r, B, H * D)
        vn, vsn = quantized(r, B, H * D)
        k, ks = quantized(r, B, S, H * D)
        v, vs = quantized(r, B, S, H * D)
    else:
        kn, vn = (r.randn(B, H * D).astype(np.float32) for _ in range(2))
        k, v = (r.randn(B, S, H * D).astype(np.float32) for _ in range(2))
        ksn = vsn = ks = vs = None
    ring = mode == "ring"
    ws = 100 if ring else 90
    read_end = S - 1 if ring else ws
    pos = np.tile(np.arange(S, dtype=np.int32) + 40, (B, 1))
    if not ring:
        pos[:, ws + 1:] = -1
        for i in range(B):
            pos[i, : 7 * i] = -1
    pos[1, 20:26] = -1
    if ring and quant:
        k[:, ws], v[:, ws] = 127, -127
        ks[:, ws] = vs[:, ws] = 1e3
    cur = pos[:, ws] + 1000
    cur[2] = -1
    pos[:, ws] = cur
    return (q, kn[:, None], vn[:, None], cur, k, v, pos, read_end, ws, ksn,
            vsn, ks, vs)


def run_jax(case, stats):
    q, kn, vn, cur, k, v, pos, read_end, ws, ksn, vsn, ks, vs = case
    quant = ks is not None
    extra = [ksn, vsn, ks, vs] if quant else []

    def one(q, kn, vn, cur, k, v, pos, *qa):
        kw = dict(ks_new=qa[0], vs_new=qa[1], k_scale=qa[2],
                  v_scale=qa[3]) if quant else {}
        return jdia(q, kn, vn, cur, k, v, pos, jnp.int32(read_end),
                    jnp.int32(ws), block_size=BS, interpret=True,
                    stats=stats, **kw)

    outs = jax.vmap(one)(*(jnp.asarray(a) for a in
                           (q, kn, vn, cur, k, v, pos, *extra)))
    return [np.asarray(o) for o in outs]


def run_port(case, stats):
    q, kn, vn, cur, k, v, pos, read_end, ws, ksn, vsn, ks, vs = case
    kc, vc = t(k.copy()), t(v.copy())
    kw = {}
    if ks is not None:
        kw = dict(k_scale=t(ks.copy()), v_scale=t(vs.copy()),
                  ks_new=t(ksn), vs_new=t(vsn))
    res = decode_insert_attention(t(q), t(kn), t(vn), t(cur), kc, vc, t(pos),
                                  read_end, ws, stats=stats, **kw)
    res = list(res) if stats else [res]
    caches = [kc, vc] + ([kw["k_scale"], kw["v_scale"]] if kw else [])
    return [r.numpy() for r in res], [c.numpy() for c in caches]


@pytest.mark.parametrize("mode", ["linear", "ring"])
def test_k7_kv8_plain_matches_pallas(mode):
    case = k7_case(mode, seed=len(mode), quant=True)
    want = run_jax(case, stats=False)
    (out,), caches = run_port(case, stats=False)
    np.testing.assert_allclose(out, want[0], atol=ATOL, rtol=0)
    for got, w, what in zip(caches, want[1:], ("k", "v", "k_scale",
                                               "v_scale")):
        assert got.dtype == w.dtype, what
        np.testing.assert_array_equal(got, w, err_msg=what)


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("mode", ["linear", "ring"])
def test_k7_stats_plain_matches_pallas(mode, quant):
    case = k7_case(mode, seed=7 + len(mode), quant=quant)
    want = run_jax(case, stats=True)
    (out, m, l), _ = run_port(case, stats=True)
    np.testing.assert_allclose(out, want[0], atol=ATOL, rtol=0)
    np.testing.assert_allclose(m, want[-2], atol=ATOL, rtol=1e-6)
    np.testing.assert_allclose(l, want[-1], atol=ATOL, rtol=1e-5)


def _softmax_ref(q, keys, vals):
    """One softmax over the given (n, H, D) keys per head: (H, D)."""
    lg = np.einsum("hd,nhd->hn", q.astype(np.float64), keys) / np.sqrt(D)
    w = np.exp(lg - lg.max(-1, keepdims=True))
    w /= w.sum(-1, keepdims=True)
    return np.einsum("hn,nhd->hd", w, vals)


def test_k7_stats_merge_equals_one_softmax():
    """Prefix partial + K7 stats (int8 caches) merged = one softmax over the
    prefix keys and the lane's own attended slots; lane 0's own slots are
    all masked (an idle lane), so it gets the prefix partial alone."""
    case = list(k7_case("ring", seed=11, quant=True))
    q, kn, vn, cur, k, v, pos, read_end, ws, ksn, vsn, ks, vs = case
    pos[0] = -1
    cur[0] = -1
    case[3], case[6] = cur, pos
    (out, m, l), _ = run_port(tuple(case), stats=True)
    assert np.isneginf(m[0]).all() and (l[0] == 0).all()
    rng = np.random.RandomState(3)
    p = 24
    pk = rng.randn(H, p, D).astype(np.float32)
    pv = rng.randn(H, p, D).astype(np.float32)
    ppos = np.tile(np.arange(p, dtype=np.int32), (B, 1))
    ppos[:, 20:] = -1
    ppos[1, :8] = -1
    o1, m1, l1 = tatt.prefix_attn_stats(t(q)[:, None], t(pk), t(pv),
                                        t(ppos))
    got = tatt.merge_attn_partials(o1[:, 0], m1[:, 0], l1[:, 0], t(out),
                                   t(m), t(l)).numpy()
    assert np.isfinite(got).all()
    kf = k.astype(np.float64) * ks[..., None]
    vf = v.astype(np.float64) * vs[..., None]
    kf[:, ws] = kn[:, 0] * ksn[:, None]
    vf[:, ws] = vn[:, 0] * vsn[:, None]
    for b in range(B):
        own = (pos[b] >= 0) & (np.arange(S) <= read_end)
        own[ws] = cur[b] >= 0
        keys = np.concatenate([pk[:, ppos[b] >= 0].transpose(1, 0, 2),
                               kf[b, own].reshape(-1, H, D)])
        vals = np.concatenate([pv[:, ppos[b] >= 0].transpose(1, 0, 2),
                               vf[b, own].reshape(-1, H, D)])
        np.testing.assert_allclose(got[b], _softmax_ref(q[b], keys, vals),
                                   atol=ATOL, rtol=0)


# ----------------------------------------------- shared-prefix partials --

def test_prefix_attn_stats_and_merge_match_jax():
    rng = np.random.RandomState(5)
    tq, p = 3, 40
    q = rng.randn(B, tq, H, D).astype(np.float32)
    pk = rng.randn(H, p, D).astype(np.float32)
    pv = rng.randn(H, p, D).astype(np.float32)
    ppos = np.tile(np.arange(p, dtype=np.int32), (B, 1))
    ppos[0, 30:] = -1
    ppos[2, :10] = -1
    want = jax.vmap(jatt.prefix_attn_stats, in_axes=(0, None, None, 0))(
        jnp.asarray(q), jnp.asarray(pk), jnp.asarray(pv), jnp.asarray(ppos))
    got = tatt.prefix_attn_stats(t(q), t(pk), t(pv), t(ppos))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL,
                                   rtol=1e-6)
    o2 = rng.randn(B, tq, H, D).astype(np.float32)
    m2 = rng.randn(B, tq, H).astype(np.float32)
    l2 = rng.rand(B, tq, H).astype(np.float32) * 5
    want = jatt.merge_attn_partials(*want, jnp.asarray(o2), jnp.asarray(m2),
                                    jnp.asarray(l2))
    got = tatt.merge_attn_partials(*got, t(o2), t(m2), t(l2))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)


@pytest.mark.parametrize("tq", [1, 5])
def test_seg_stats_match_jax(tq):
    rng = np.random.RandomState(tq)
    q = rng.randn(tq, H, D).astype(np.float32)
    k = rng.randn(S, H * D).astype(np.float32)
    v = rng.randn(S, H * D).astype(np.float32)
    pos = np.arange(S, dtype=np.int32)
    pos[150:] = -1
    bias = np.asarray(jatt.pos_cache_bias(jnp.arange(140, 140 + tq),
                                          jnp.asarray(pos)))
    jfn = jatt.sdpa_decode_seg_stats if tq == 1 else jatt.sdpa_seg_stats
    tfn = tatt.sdpa_decode_seg_stats if tq == 1 else tatt.sdpa_seg_stats
    want = jfn(*(jnp.asarray(a) for a in (q, k, v, bias)))
    got = tfn(t(q), t(k), t(v), t(bias))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL,
                                   rtol=1e-6)


def test_split_prefix_matches_jax_on_int8_kv_state():
    cfg0 = tiny_config(64)
    cfg0 = dataclasses.replace(cfg0, backbone=dataclasses.replace(
        cfg0.backbone, quantize_kv=True))
    pj, cfg = params_from_flat(random_flat(cfg0, seed=9), cfg0)
    pt = from_jax_numpy(jax.tree.map(np.asarray, pj))
    prompt = np.random.RandomState(2).randn(32, cfg.backbone.d_model) \
        .astype(np.float32)
    sj, _ = jbb.forward(pj, cfg.backbone, jbb.init_state(cfg.backbone),
                        jnp.asarray(prompt), 27)
    sj = jbb.advance(sj, 32, 27)
    st = tbb.init_state(cfg.backbone)
    tbb.forward(pt, cfg.backbone, st, t(prompt), 27)
    tbb.advance(st, 32, 27)
    assert st.k[0].dtype == torch.int8 and st.k_scale is not None
    hn = cfg.backbone.num_heads
    (pkj, pvj, pposj), rj = jbb.split_prefix(sj, 32, hn, jnp.float32)
    (pkt, pvt, ppost), rt = tbb.split_prefix(st, 32, hn, torch.float32)
    np.testing.assert_array_equal(ppost.numpy(), np.asarray(pposj))
    for l in range(cfg.backbone.num_layers):
        for a, b in ((pkt[l], pkj[l]), (pvt[l], pvj[l]),
                     (rt.k_scale[l], rj.k_scale[l])):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6,
                                       rtol=1e-6)
    assert rt.end == int(rj.end) == 0 and rt.next_pos == int(rj.next_pos)
    assert rt.k[0].shape == rj.k[0].shape
    np.testing.assert_array_equal(rt.pos.numpy(), np.asarray(rj.pos))


def test_kv8_wrappers_count_nothing_on_cpu_and_refuse_other_devices():
    case = k7_case("ring", seed=2, quant=True)
    n = (decode_insert_attention.launches_kv8,
         decode_insert_attention.launches_stats, decode_attention.launches_kv8)
    run_port(case, stats=True)
    q, k = case[0], case[4]
    decode_attention(t(q[0]), t(k[0]), t(k[0]), t(case[6][0]), 50,
                     t(case[11][0]), t(case[12][0]))
    assert n == (decode_insert_attention.launches_kv8,
                 decode_insert_attention.launches_stats,
                 decode_attention.launches_kv8)
    m = torch.empty(H, D, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        decode_attention(m, m, m, m, 0, m, m)
