"""K1 over lanes (the port's batched T = 1 decode attention without the
fused insert) against the JAX package, f32:

- `decode_attention_plain` with a lane axis vs `jax.vmap` of the JAX
  `decode_attention(..., interpret=True)` (the vmap rule runs the batched
  Pallas kernel `_decode_attention_batched`), with and without `stats`,
  caches of the working type and int8 caches with per-row scales: out, m
  and l within 1e-5 (both compute in f32 and differ in summation order
  only) on every lane that attends a slot. An all-masked lane gives out 0,
  m = -inf and l = 0 in the port (the JAX kernel's finite -1e9 mask gives a
  mean of masked rows there; merge_attn_partials drops the port's partial).
- `forward_lanes` with `fuse_insert=False` (row write + K1 over lanes)
  gives the numbers of `fuse_insert=True` (K7), 1e-5, both cache kinds,
  with and without a shared prefix.
- `ContinuousBatchingServer` with `fuse_insert=False` and `share_prefix=
  True` vs the JAX server on the same cfg, int8 weights and the int8 KV
  cache: 1e-3 relative to max |pcm| (a K/V value within an f32 ulp of an
  int8 rounding boundary quantizes one step apart when the two packages
  sum in another order, and the audio moves from that frame on).
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
from pocket_tts_tpu.ops.pallas_attn import decode_attention as jda
from pocket_tts_tpu.runtime.engine import TTSEngine as JEngine
from pocket_tts_tpu.runtime.server import ContinuousBatchingServer as JCBS
from pocket_tts_tpu_torch.io.params import from_jax_numpy, random_voice_prompt
from pocket_tts_tpu_torch.models import backbone as tbb
from pocket_tts_tpu_torch.ops import attention as tatt
from pocket_tts_tpu_torch.ops.decode_attn import (decode_attention,
                                                  decode_attention_plain)
from pocket_tts_tpu_torch.runtime.batched import stack_states
from pocket_tts_tpu_torch.runtime.engine import TTSEngine
from pocket_tts_tpu_torch.runtime.server import ContinuousBatchingServer
from pocket_tts_tpu_torch.text.tokenizer import MockTokenizer

torch.set_num_threads(1)
ATOL = 1e-5
KV8_REL = 1e-3
S, H, D, BS, B = 256, 4, 16, 64, 3


def t(a):
    return torch.from_numpy(np.array(a))


def quantized(rng, *shape):
    x = rng.randn(*shape).astype(np.float32)
    q, s = jbb.quantize_rows(jnp.asarray(x.reshape(-1, shape[-1])))
    return (np.array(q).reshape(shape), np.array(s).reshape(shape[:-1]))


def lanes_case(seed, quant, end):
    """q (B, H, D), caches (B, S, H*D), pos (B, S) with lanes of different
    live lengths and padding holes; lane 2 attends nothing."""
    r = np.random.RandomState(seed)
    q = r.randn(B, H, D).astype(np.float32)
    if quant:
        k, ks = quantized(r, B, S, H * D)
        v, vs = quantized(r, B, S, H * D)
    else:
        k, v = (r.randn(B, S, H * D).astype(np.float32) for _ in range(2))
        ks = vs = None
    pos = np.tile(np.arange(S, dtype=np.int32) + 7, (B, 1))
    pos[:, end + 1:] = -1
    pos[0, :13] = -1
    pos[1, 30:41] = -1
    pos[2] = -1
    return q, k, v, pos, ks, vs


def run_jax(case, end, stats):
    q, k, v, pos, ks, vs = case
    if ks is None:
        fn = jax.vmap(lambda q, k, v, p: jda(q, k, v, p, end, block_size=BS,
                                              interpret=True, stats=stats))
        outs = fn(*(jnp.asarray(a) for a in (q, k, v, pos)))
    else:
        fn = jax.vmap(lambda q, k, v, p, ks, vs: jda(
            q, k, v, p, end, block_size=BS, k_scale=ks, v_scale=vs,
            interpret=True, stats=stats))
        outs = fn(*(jnp.asarray(a) for a in (q, k, v, pos, ks, vs)))
    return [np.asarray(o) for o in (outs if stats else (outs,))]


@pytest.mark.parametrize("end", [100, S - 1])
@pytest.mark.parametrize("stats", [False, True])
@pytest.mark.parametrize("quant", [False, True])
def test_k1_lanes_plain_matches_pallas(quant, stats, end):
    case = lanes_case(3 + end, quant, end)
    q, k, v, pos, ks, vs = case
    want = run_jax(case, end, stats)
    kw = dict(k_scale=t(ks), v_scale=t(vs)) if quant else {}
    got = decode_attention_plain(t(q), t(k), t(v), t(pos), end, stats=stats,
                                 **kw)
    got = [g.numpy() for g in (got if stats else (got,))]
    live = [0, 1]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g[live], w[live], atol=ATOL, rtol=1e-5)
    assert (got[0][2] == 0).all()
    if stats:
        assert np.isneginf(got[1][2]).all() and (got[2][2] == 0).all()


def test_k1_lane_equals_solo_call():
    """Each lane of the lane call is the solo call on that lane's data
    (with statistics: the solo call's own (m, l)); on the CPU up to the
    summation order of a batched product (1e-6)."""
    q, k, v, pos, ks, vs = lanes_case(5, True, 180)
    got = decode_attention(t(q), t(k), t(v), t(pos), 180, t(ks), t(vs),
                           stats=True)
    for i in (0, 1):
        solo = decode_attention(t(q[i]), t(k[i]), t(v[i]), t(pos[i]), 180,
                                t(ks[i]), t(vs[i]), stats=True)
        for a, b in zip(got, solo):
            np.testing.assert_allclose(a[i].numpy(), b.numpy(), atol=1e-6,
                                       rtol=1e-6)


def test_k1_stats_merge_equals_one_softmax():
    """The K1-over-lanes partial merged with a prefix partial equals one
    softmax over both key sets; the idle lane gets the prefix alone."""
    q, k, v, pos, _, _ = lanes_case(9, False, 150)
    out, m, l = decode_attention(t(q), t(k), t(v), t(pos), 150, stats=True)
    rng = np.random.RandomState(4)
    p = 20
    pk = rng.randn(H, p, D).astype(np.float32)
    pv = rng.randn(H, p, D).astype(np.float32)
    ppos = np.tile(np.arange(p, dtype=np.int32), (B, 1))
    ppos[:, 15:] = -1
    o1, m1, l1 = tatt.prefix_attn_stats(t(q)[:, None], t(pk), t(pv),
                                        t(ppos))
    got = tatt.merge_attn_partials(o1[:, 0], m1[:, 0], l1[:, 0], out, m,
                                   l).numpy()
    for b in range(B):
        own = (pos[b] >= 0) & (np.arange(S) <= 150)
        keys = np.concatenate([pk[:, ppos[b] >= 0].transpose(1, 0, 2),
                               k[b, own].reshape(-1, H, D)])
        vals = np.concatenate([pv[:, ppos[b] >= 0].transpose(1, 0, 2),
                               v[b, own].reshape(-1, H, D)])
        lg = np.einsum("hd,nhd->hn", q[b].astype(np.float64), keys)
        w = np.exp(lg / np.sqrt(D) - (lg / np.sqrt(D)).max(-1,
                                                           keepdims=True))
        w /= w.sum(-1, keepdims=True)
        np.testing.assert_allclose(got[b], np.einsum("hn,nhd->hd", w, vals),
                                   atol=ATOL, rtol=0)


def test_k1_lanes_counts_nothing_on_cpu_and_refuses_other_devices():
    n = (decode_attention.launches_lanes, decode_attention.launches_stats)
    q, k, v, pos, _, _ = lanes_case(1, False, 50)
    decode_attention(t(q), t(k), t(v), t(pos), 50, stats=True)
    assert n == (decode_attention.launches_lanes,
                 decode_attention.launches_stats)
    m = torch.empty(B, H, D, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        decode_attention(m, m, m, m, 0, stats=True)


# ----------------------------------------------- forward_lanes, no K7 ----

CFG0 = tiny_config(64)
CFG0 = dataclasses.replace(CFG0, backbone=dataclasses.replace(
    CFG0.backbone, kv_capacity=256))
PJ, CFG = params_from_flat(random_flat(CFG0, seed=13, scale=0.05), CFG0)
PT = from_jax_numpy(jax.tree.map(np.asarray, PJ))


@pytest.mark.parametrize("share", [False, True])
@pytest.mark.parametrize("quantize_kv", [False, True])
def test_forward_lanes_without_fuse_insert_matches_k7(quantize_kv, share):
    """Three lanes primed with prompts of different lengths, four decode
    steps in ring mode: the row write + K1 over lanes route gives the
    numbers of the K7 route."""
    bcfg = dataclasses.replace(CFG.backbone, quantize_kv=quantize_kv)
    rng = np.random.RandomState(2)
    states = []
    for n in (9, 12, 5):
        st = tbb.init_state(bcfg)
        x = torch.from_numpy(rng.randn(16, bcfg.d_model).astype(np.float32)
                             * 0.3)
        st, _ = tbb.forward(PT, bcfg, st, x, n)
        states.append(tbb.advance(st, 16, n))
    if share:
        split = [tbb.split_prefix(s, 8, bcfg.num_heads, torch.float32)
                 for s in states]
        pk, pv = split[0][0][:2]
        states = [dataclasses.replace(r, pk=pk, pv=pv, ppos=tab[2])
                  for tab, r in split]
    steps = [torch.from_numpy(rng.randn(3, 1, bcfg.d_model).astype(
        np.float32) * 0.3) for _ in range(4)]
    ys = {}
    for fuse in (True, False):
        cfg = dataclasses.replace(bcfg, fuse_insert=fuse)
        lanes = stack_states([dataclasses.replace(
            s, k=[c.clone() for c in s.k], v=[c.clone() for c in s.v],
            pos=s.pos.clone()) for s in states])
        lanes.ring_start = lanes.end
        out = []
        for x in steps:
            lanes, y = tbb.forward_lanes(PT, cfg, lanes, x)
            tbb.advance_lanes(lanes, 1, 1)
            out.append(y)
        ys[fuse] = torch.stack(out)
    np.testing.assert_allclose(ys[False].numpy(), ys[True].numpy(),
                               atol=ATOL, rtol=0)


def test_server_without_fuse_insert_shared_prefix_matches_jax():
    cfg = dataclasses.replace(CFG, backbone=dataclasses.replace(
        CFG.backbone, fuse_insert=False))
    voices = {"va": random_voice_prompt(cfg, 12, seed=1),
              "vb": random_voice_prompt(cfg, 16, seed=2)}
    reqs = [("The first stream keeps the batch busy.", "va"),
            ("Joining mid decode.", "vb")]
    got = []
    for cls, eng in (
            (JCBS, JEngine(params=PJ, cfg=cfg, seed=0, quantize="int8",
                           quantize_kv=True,
                           tokenizer=MockTokenizer(cfg.lut.n_bins))),
            (ContinuousBatchingServer, TTSEngine(
                params=PT, cfg=cfg, seed=0, quantize="int8",
                quantize_kv=True, device="cpu",
                tokenizer=MockTokenizer(cfg.lut.n_bins)))):
        srv = cls(eng, lanes=2, chunk_frames=4, text_bucket=32,
                  share_prefix=True)
        assert srv.cfg.backbone.fuse_insert is False
        srv.register_voices({k: np.asarray(v) for k, v in voices.items()})
        out = [srv.submit(reqs[0][0], reqs[0][1], temp=0.0)]
        srv.step()
        out.append(srv.submit(reqs[1][0], reqs[1][1], temp=0.0))
        srv.run_pending()
        got.append(out)
    for rj, rt in zip(*got):
        want = np.asarray(rj.pcm)
        assert rt.pcm.shape == want.shape and want.size > 0
        scale = np.abs(want).max()
        np.testing.assert_allclose(rt.pcm / scale, want / scale,
                                   atol=KV8_REL, rtol=0)
    assert got[1][1].admit_step == 1
