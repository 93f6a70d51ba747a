"""The int8 mimi ring (`mimi.transformer.quantize_kv`, kernel K2's int8
variant K2-q) against the JAX package, f32:

- `ring_insert_attention_plain` over int8 rings vs the JAX
  `ring_insert_attention(..., ks_new=, vs_new=, k_scale=, v_scale=,
  interpret=True)`, solo and over 3 lanes with distinct starts (the vmap
  rule runs the batched Pallas kernel): attn within 1e-5 (both compute in
  f32 and differ in summation order only); the ring bytes and scale rows
  after the insert equal bit for bit. At capacity 64 (the JAX package
  takes its kernel route only at a capacity that is a multiple of 32).
- `mimi_transformer.forward` with `quantize_kv` vs the JAX one over six
  frames (the ring wraps): at capacity 64 the JAX kernel route
  (`use_pallas_attn=True`), at tiny_config's 48 its XLA route
  (`models/mimi_transformer.py:209-213`, dequantized rows); 1e-3 relative
  to max |y| (the 16 new rows come from f32 products summed in another
  order in each package, and a value within an ulp of an int8 rounding
  boundary quantizes one step apart).
- The scale rows ride with the lanes: stack/unstack keeps them, and a
  request admitted mid-decode into a running batch gives the solo
  engine's pcm (1e-3 relative, the same reason).
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
from pocket_tts_tpu.models import mimi_transformer as jmt
from pocket_tts_tpu.ops.pallas_mimi import ring_insert_attention as jring
from pocket_tts_tpu_torch.io.params import from_jax_numpy, random_voice_prompt
from pocket_tts_tpu_torch.models import mimi, mimi_transformer as tmt
from pocket_tts_tpu_torch.ops.ring_attn import (ring_insert_attention,
                                                ring_insert_attention_plain)
from pocket_tts_tpu_torch.runtime.batched import stack_states, unstack_states
from pocket_tts_tpu_torch.runtime.engine import TTSEngine
from pocket_tts_tpu_torch.runtime.server import ContinuousBatchingServer
from pocket_tts_tpu_torch.text.preprocess import prepare_text_prompt
from pocket_tts_tpu_torch.text.tokenizer import MockTokenizer

torch.set_num_threads(1)
ATOL = 1e-5
KV8_REL = 1e-3
H, D, T, CAP, CTX, B = 2, 16, 16, 64, 40, 3


def t(a):
    return torch.from_numpy(np.array(a))


def quantized(rng, *shape):
    x = rng.randn(*shape).astype(np.float32)
    q, s = jbb.quantize_rows(jnp.asarray(x.reshape(-1, shape[-1])))
    return (np.array(q).reshape(shape), np.array(s).reshape(shape[:-1]))


def ring_case(seed, lead=()):
    r = np.random.RandomState(seed)
    q = r.randn(*lead, T, H * D).astype(np.float32)
    kn, ksn = quantized(r, *lead, T, H * D)
    vn, vsn = quantized(r, *lead, T, H * D)
    k, ks = quantized(r, *lead, CAP, H * D)
    v, vs = quantized(r, *lead, CAP, H * D)
    return q, kn, vn, k, v, ksn, vsn, ks, vs


def run_jax(case, offset, start):
    q, kn, vn, k, v, ksn, vsn, ks, vs = (jnp.asarray(a) for a in case)

    def one(q, kn, vn, k, v, st, ksn, vsn, ks, vs):
        return jring(q, kn, vn, k, v, offset, st, num_heads=H, context=CTX,
                     interpret=True, ks_new=ksn, vs_new=vsn, k_scale=ks,
                     v_scale=vs)

    if q.ndim == 3:
        outs = jax.vmap(one)(q, kn, vn, k, v, jnp.asarray(start), ksn, vsn,
                             ks, vs)
    else:
        outs = one(q, kn, vn, k, v, jnp.asarray(start, jnp.int32), ksn, vsn,
                   ks, vs)
    return [np.asarray(o) for o in outs]


def run_port(case, offset, start, fn=ring_insert_attention):
    q, kn, vn, k, v, ksn, vsn, ks, vs = case
    caches = [t(k.copy()), t(v.copy()), t(ks.copy()), t(vs.copy())]
    out = fn(t(q), t(kn), t(vn), caches[0], caches[1], offset,
             t(start) if np.ndim(start) else start, H, CTX,
             k_scale=caches[2], v_scale=caches[3], ks_new=t(ksn),
             vs_new=t(vsn))
    return [out.numpy()] + [c.numpy() for c in caches]


@pytest.mark.parametrize("offset,start", [(0, 0), (48, 16), (112, 32),
                                          (400, 0)])
def test_k2q_plain_matches_pallas_solo(offset, start):
    case = ring_case(offset + 1)
    want = run_jax(case, offset, start)
    got = run_port(case, offset, start, ring_insert_attention_plain)
    np.testing.assert_allclose(got[0], want[0], atol=ATOL, rtol=0)
    for g, w, what in zip(got[1:], want[1:], ("k", "v", "k_scale",
                                              "v_scale")):
        assert g.dtype == w.dtype, what
        np.testing.assert_array_equal(g, w, err_msg=what)


@pytest.mark.parametrize("offset", [48, 400])
def test_k2q_plain_matches_pallas_lanes(offset):
    case = ring_case(offset + 7, (B,))
    starts = np.array([0, offset, 16 * (offset // 32)], np.int32)
    want = run_jax(case, offset, starts)
    got = run_port(case, offset, starts)
    np.testing.assert_allclose(got[0], want[0], atol=ATOL, rtol=0)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(g, w)
    # each lane is the solo call on its data
    for i in range(B):
        solo = run_port(tuple(a[i] for a in case), offset, int(starts[i]))
        np.testing.assert_allclose(got[0][i], solo[0], atol=1e-6, rtol=0)


def test_k2q_counts_nothing_on_cpu_and_refuses_other_devices():
    n = (ring_insert_attention.launches, ring_insert_attention.launches_kv8)
    run_port(ring_case(2), 32, 0)
    assert n == (ring_insert_attention.launches,
                 ring_insert_attention.launches_kv8)
    m = torch.empty(T, H * D, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        ring_insert_attention(m, m, m, m, m, 0, 0, H, CTX, k_scale=m,
                              v_scale=m, ks_new=m, vs_new=m)


# -------------------------------------------------- the mimi transformer --

CFG0 = tiny_config()
PJ, CFG = params_from_flat(random_flat(CFG0, seed=21), CFG0)
PT = from_jax_numpy(jax.tree.map(np.asarray, PJ))


@pytest.mark.parametrize("capacity", [64, 48])
def test_mimi_transformer_int8_ring_matches_jax(capacity):
    mcfg = dataclasses.replace(CFG.mimi.transformer, capacity=capacity,
                               quantize_kv=True,
                               use_pallas_attn=capacity % 32 == 0)
    pj = PJ["mimi"]["decoder_transformer"]
    pt = PT["mimi"]["decoder_transformer"]
    sj, st = jmt.init_state(mcfg), tmt.init_state(mcfg)
    assert st.k[0].dtype == torch.int8 and st.k_scale[0].shape == (capacity,)
    rng = np.random.RandomState(capacity)
    for _ in range(6):
        x = rng.randn(16, mcfg.d_model).astype(np.float32)
        sj, yj = jmt.forward(pj, mcfg, sj, jnp.asarray(x))
        st, yt = tmt.forward(pt, mcfg, st, t(x))
        yj = np.asarray(yj)
        scale = np.abs(yj).max()
        np.testing.assert_allclose(yt.numpy() / scale, yj / scale,
                                   atol=KV8_REL, rtol=0)
    assert st.offset == int(sj.offset) == 96


CFG64 = tiny_config(64)
CFG64 = dataclasses.replace(
    CFG64, backbone=dataclasses.replace(CFG64.backbone, kv_capacity=256),
    mimi=dataclasses.replace(CFG64.mimi, transformer=dataclasses.replace(
        CFG64.mimi.transformer, quantize_kv=True)))
P64J, CFG64 = params_from_flat(random_flat(CFG64, seed=13, scale=0.05),
                               CFG64)
P64 = from_jax_numpy(jax.tree.map(np.asarray, P64J))


def tengine():
    return TTSEngine(params=P64, cfg=CFG64, seed=0, device="cpu",
                     tokenizer=MockTokenizer(CFG64.lut.n_bins))


def test_stack_unstack_keep_the_ring_scale_rows():
    eng = tengine()
    a = mimi.init_state(CFG64.mimi)
    b = mimi.init_state(CFG64.mimi)
    for i, s in enumerate((a, b)):
        for c in s.transformer.k_scale + s.transformer.v_scale:
            c.uniform_(0.5 + i, 1.0 + i)
    vstate = eng.prime_voice(random_voice_prompt(CFG64, 12, seed=1))
    streams = []
    for s in (a, b):
        st, _ = eng._prefill_sentence(vstate, "Hello there.")
        st.mimi = s
        streams.append(st)
    lanes = stack_states(streams)
    assert lanes.mimi.transformer.k_scale[0].shape == (
        2, CFG64.mimi.transformer.capacity)
    back = unstack_states(lanes)
    for s, r in zip((a, b), back):
        for x, y in zip(s.transformer.k_scale + s.transformer.v_scale,
                        r.mimi.transformer.k_scale
                        + r.mimi.transformer.v_scale):
            assert torch.equal(x, y)


def test_admitted_mid_decode_matches_solo():
    """A running batch with the int8 mimi ring (and its lanes' scale rows):
    the request admitted into a lane mid-decode gives the solo engine's
    pcm."""
    voice = random_voice_prompt(CFG64, 12, seed=1)
    texts = ["The first stream keeps the batch busy for a while.",
             "Joining mid decode."]
    eng = tengine()
    srv = ContinuousBatchingServer(eng, lanes=2, chunk_frames=4,
                                   text_bucket=32)
    srv.register_voices({"v": voice})
    first = srv.submit(texts[0], "v", temp=0.0)
    srv.step()
    late = srv.submit(texts[1], "v", temp=0.0)
    srv.run_pending()
    assert late.admit_step == 1
    assert srv.batch.mimi.transformer.k_scale[0].shape == (
        2, CFG64.mimi.transformer.capacity)
    vstate = eng.prime_voice(voice)
    for r in (first, late):
        prepared, guess = prepare_text_prompt(r.text)
        want = eng.synthesize_sentence(vstate, prepared, 0.0, guess + 2)
        assert r.pcm.shape == want.shape and want.size > 0
        scale = np.abs(want).max()
        np.testing.assert_allclose(r.pcm / scale, want / scale,
                                   atol=KV8_REL, rtol=0)
