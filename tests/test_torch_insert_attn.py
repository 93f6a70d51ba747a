"""K7's plain version (the port's fused KV-row insert + decode attention
over B lanes) against the JAX package's `decode_insert_attention` in
interpret mode, as tests/test_pallas.py runs it, vmapped over the lanes
with the slot cursors shared. f32, atol 1e-5 on the output and on the
caches after the call: both sides compute in f32 and differ only in
summation order."""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pocket_tts_tpu.ops.pallas_attn import decode_insert_attention as jdia
from pocket_tts_tpu_torch.ops.insert_attn import (
    decode_insert_attention, decode_insert_attention_plain)

S, H, D, BS, B = 256, 4, 16, 64, 3
ATOL = 1e-5


def make_case(mode, seed, ws=None):
    """(q, k_new, v_new, cur_pos, k, v, pos, read_end, write_slot) as numpy.
    linear: the write slot is the read extent, lanes hold different live
    lengths with padding holes; ring: every slot is live and the write
    slot holds a stale row (garbage bytes, an overwritten position). Lane
    2 carries an invalid new row (cur_pos = -1) in the *_invalid modes."""
    r = np.random.RandomState(seed)
    q = r.randn(B, H, D).astype(np.float32)
    kn = r.randn(B, 1, H * D).astype(np.float32)
    vn = r.randn(B, 1, H * D).astype(np.float32)
    k = r.randn(B, S, H * D).astype(np.float32)
    v = r.randn(B, S, H * D).astype(np.float32)
    ring = mode.startswith("ring")
    if ws is None:
        ws = 100 if ring else 90
    read_end = S - 1 if ring else ws
    pos = np.tile(np.arange(S, dtype=np.int32) + 40, (B, 1))
    if not ring:
        pos[:, ws + 1:] = -1
        for i in range(B):
            pos[i, : 7 * i] = -1
    pos[1, 20:26] = -1                       # padding rows
    if ring:
        k[:, ws] = 1e3                       # stale bytes: never attended
        v[:, ws] = -1e3
    cur = pos[:, ws] + 1000
    if mode.endswith("invalid"):
        cur[2] = -1
    pos[:, ws] = cur                         # pos is post-insert
    return q, kn, vn, cur, k, v, pos, read_end, ws


def run_jax(case):
    q, kn, vn, cur, k, v, pos, read_end, ws = case
    fn = jax.vmap(lambda *a: jdia(*a[:6], a[6], jnp.int32(read_end),
                                  jnp.int32(ws), block_size=BS,
                                  interpret=True))
    out, kc, vc = fn(jnp.asarray(q), jnp.asarray(kn), jnp.asarray(vn),
                     jnp.asarray(cur), jnp.asarray(k), jnp.asarray(v),
                     jnp.asarray(pos))
    return np.asarray(out), np.asarray(kc), np.asarray(vc)


def run_port(case, fn=decode_insert_attention):
    q, kn, vn, cur, k, v, pos, read_end, ws = case
    kc, vc = torch.from_numpy(k.copy()), torch.from_numpy(v.copy())
    out = fn(torch.from_numpy(q), torch.from_numpy(kn), torch.from_numpy(vn),
             torch.from_numpy(cur), kc, vc, torch.from_numpy(pos), read_end,
             ws)
    return out.numpy(), kc.numpy(), vc.numpy()


@pytest.mark.parametrize("mode,ws", [("linear", None), ("linear", 0),
                                     ("linear_invalid", None),
                                     ("ring", None), ("ring", S - 1),
                                     ("ring_invalid", None)])
def test_plain_matches_jax_kernel(mode, ws):
    case = make_case(mode, seed=len(mode) + (ws or 0), ws=ws)
    want = run_jax(case)
    got = run_port(case)
    for g, w, what in zip(got, want, ("out", "k_cache", "v_cache")):
        np.testing.assert_allclose(g, w, atol=ATOL, rtol=0, err_msg=what)


def test_cache_row_written_and_stale_row_excluded():
    """The write slot receives the new row in every lane; the stale ring
    bytes there never reach the output (they are 1e3-sized)."""
    case = make_case("ring_invalid", seed=3)
    out, kc, vc = run_port(case)
    ws = case[-1]
    np.testing.assert_array_equal(kc[:, ws], case[1][:, 0])
    np.testing.assert_array_equal(vc[:, ws], case[2][:, 0])
    assert np.abs(out).max() < 10


def test_invalid_row_is_not_attended():
    """cur_pos = -1: the row lands in the cache but contributes nothing:
    the output equals attention over the other slots alone."""
    q, kn, vn, cur, k, v, pos, read_end, ws = make_case("linear_invalid", 4)
    out, _, _ = run_port((q, kn, vn, cur, k, v, pos, read_end, ws))
    lane = 2
    keep = (pos[lane] >= 0) & (np.arange(S) <= read_end)
    keep[ws] = False
    kk = k[lane, keep].reshape(-1, H, D)
    vv = v[lane, keep].reshape(-1, H, D)
    logits = np.einsum("hd,shd->hs", q[lane], kk) / np.sqrt(D)
    w = np.exp(logits - logits.max(-1, keepdims=True))
    w /= w.sum(-1, keepdims=True)
    np.testing.assert_allclose(out[lane], np.einsum("hs,shd->hd", w, vv),
                               atol=ATOL, rtol=0)


def test_wrapper_runs_plain_on_cpu_and_counts_nothing():
    case = make_case("ring", seed=5)
    before = decode_insert_attention.launches
    a = run_port(case)
    b = run_port(case, decode_insert_attention_plain)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    assert decode_insert_attention.launches == before


def test_wrapper_refuses_other_devices():
    q = torch.empty(B, H, D, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        decode_insert_attention(q, q, q, q, q, q, q, 0, 0)


def test_solo_backbone_fuse_insert_matches_k1_route():
    """The solo backbone with cfg.fuse_insert runs each decode step through
    K7 (B = 1); it gives the K1 route's output and caches."""
    from pocket_tts_tpu_torch.config import tiny_config
    from pocket_tts_tpu_torch.io.params import random_params
    from pocket_tts_tpu_torch.models import backbone
    p, cfg = random_params(tiny_config(), seed=3)
    dm = cfg.backbone.d_model
    r = np.random.RandomState(0)
    prompt = torch.from_numpy(r.randn(12, dm).astype(np.float32))
    xs = [torch.from_numpy(r.randn(1, dm).astype(np.float32))
          for _ in range(4)]

    def run(bcfg):
        st = backbone.init_state(bcfg)
        backbone.forward(p, bcfg, st, prompt, 10)
        backbone.advance(st, 12, 10)
        ys = []
        for x in xs:
            _, y = backbone.forward(p, bcfg, st, x, 1)
            backbone.advance(st, 1, 1)
            ys.append(y.numpy())
        return st, ys

    st_a, ys_a = run(cfg.backbone)
    st_b, ys_b = run(dataclasses.replace(cfg.backbone, fuse_insert=True))
    np.testing.assert_allclose(np.stack(ys_b), np.stack(ys_a), atol=ATOL,
                               rtol=0)
    for ka, kb in zip(st_a.k + st_a.v, st_b.k + st_b.v):
        np.testing.assert_array_equal(kb.numpy(), ka.numpy())
