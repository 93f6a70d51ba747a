"""The port's lane-axis runtime against the JAX package's vmapped one, on
one random checkpoint at tiny_config, f32: K2's plain version over lanes
with per-lane starts against the Pallas ring kernel under vmap
(interpret), K3's plain version over lanes against solo calls lane by
lane, `batched_frame_step` against the JAX `batched_frame_step` at temp 0
(atol 1e-4, the port's end-to-end tolerance), the ring cursor's wrap,
compaction, and the lane bookkeeping."""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pocket_tts_tpu.config import tiny_config
from pocket_tts_tpu.io.params import params_from_flat, random_flat
from pocket_tts_tpu.models import backbone as jbackbone
from pocket_tts_tpu.models import mimi as jmimi
from pocket_tts_tpu.ops.pallas_mimi import ring_insert_attention as j_ring
from pocket_tts_tpu.runtime import batched as jb
from pocket_tts_tpu_torch.io.params import from_jax_numpy
from pocket_tts_tpu_torch.models import backbone, mimi, seanet
from pocket_tts_tpu_torch.ops.ring_attn import ring_insert_attention
from pocket_tts_tpu_torch.ops.seanet_frame import seanet_frame
from pocket_tts_tpu_torch.runtime import batched as tb

torch.set_num_threads(1)
ATOL = 1e-4
CFG0 = tiny_config()
PJ, CFG = params_from_flat(random_flat(CFG0, seed=23), CFG0)
PT = from_jax_numpy(jax.tree.map(np.asarray, PJ))
JCFG = jb.mesh_cfg(CFG, None)
TCFG = tb.serving_cfg(CFG)


def rnd(rng, *shape, scale=1.0):
    return (rng.randn(*shape) * scale).astype(np.float32)


# ------------------------------------------------------------------ K2 ---

@pytest.mark.parametrize("offset,starts", [
    (0, (0, 0, 0)),
    (32, (0, 16, 32)),
    (48, (16, 48, 0)),          # first wrap, one lane joining now
    (96, (32, 80, 96)),
])
def test_k2_lanes_plain_matches_pallas_vmap(offset, starts):
    h, d, cap, ctx, t, b = 2, 16, 48, 40, 16, 3
    rng = np.random.RandomState(offset)
    kc, vc = rnd(rng, b, cap, h * d), rnd(rng, b, cap, h * d)
    q, kn, vn = (rnd(rng, b, t, h * d) for _ in range(3))
    st = np.asarray(starts, np.int32)
    fn = jax.vmap(lambda q_, kn_, vn_, k_, v_, s_: j_ring(
        q_, kn_, vn_, k_, v_, jnp.int32(offset), s_, num_heads=h,
        context=ctx, interpret=True))
    aj, kj, vj = fn(*(jnp.asarray(a) for a in (q, kn, vn, kc, vc, st)))
    kt, vt = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
    at = ring_insert_attention(torch.from_numpy(q), torch.from_numpy(kn),
                               torch.from_numpy(vn), kt, vt, offset,
                               torch.from_numpy(st), h, ctx)
    np.testing.assert_allclose(at.numpy(), np.asarray(aj), atol=1e-5,
                               rtol=0)
    np.testing.assert_array_equal(kt.numpy(), np.asarray(kj))
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))


# ------------------------------------------------------------------ K3 ---

@pytest.mark.parametrize("scale", [0.3, 2.0])
def test_k3_lanes_plain_matches_solo_per_lane(scale):
    """Lanes stacked on M give each lane's solo result (pcm and carries)
    over four frames, with lanes fed different inputs."""
    sc, tpf, b = CFG.mimi.seanet, CFG.mimi.upsample_stride, 3
    dec = PT["mimi"]["decoder"]
    rng = np.random.RandomState(int(scale * 10))
    lanes = mimi.init_state_lanes(CFG.mimi, b).seanet
    solo = [seanet.init_state(sc, tpf) for _ in range(b)]
    for f in range(4):
        x = rnd(rng, b, tpf, sc.in_ch, scale=scale)
        y = seanet_frame(dec, sc, lanes, torch.from_numpy(x))
        for i in range(b):
            yi = seanet_frame(dec, sc, solo[i], torch.from_numpy(x[i]))
            np.testing.assert_allclose(y[i].numpy(), yi.numpy(), atol=1e-5,
                                       rtol=0, err_msg=f"frame {f} lane {i}")
            for key in solo[i]:
                np.testing.assert_allclose(
                    lanes[key][i].numpy(), solo[i][key].numpy(), atol=1e-5,
                    rtol=0, err_msg=f"frame {f} lane {i} carry {key}")


# ------------------------------------------------------- frame step ---

PROMPT_LENS = (10, 14, 20)
TOKEN_LENS = (5, 9, 12)
MAX_STEPS = (40, 5, 40)
FAE = (3, 3, 2)


def _prompts_tokens():
    rng = np.random.RandomState(5)
    prompts = np.zeros((3, 32, CFG.backbone.d_model), np.float32)
    for i, n in enumerate(PROMPT_LENS):
        prompts[i, :n] = rnd(rng, n, CFG.backbone.d_model, scale=0.05)
    tokens = np.zeros((3, 16), np.int64)
    for i, n in enumerate(TOKEN_LENS):
        tokens[i, :n] = rng.randint(0, CFG.lut.n_bins, n)
    return prompts, tokens


def _jax_states():
    prompts, tokens = _prompts_tokens()
    st = jb.stack_states([jbackbone.init_state(JCFG.backbone)
                          for _ in range(3)])
    vs = jb.batched_prime_voice(PJ, JCFG, st, jnp.asarray(prompts),
                                jnp.asarray(PROMPT_LENS, jnp.int32))
    return jb.batched_sentence_prefill(
        PJ, JCFG, vs, jmimi.init_state(CFG.mimi), jnp.asarray(tokens,
                                                              jnp.int32),
        jnp.asarray(TOKEN_LENS, jnp.int32))


def _port_states():
    prompts, tokens = _prompts_tokens()
    st = tb.stack_states([backbone.init_state(TCFG.backbone)
                          for _ in range(3)])
    vs = tb.batched_prime_voice(PT, TCFG, st, torch.from_numpy(prompts),
                                torch.tensor(PROMPT_LENS, dtype=torch.int32))
    return tb.batched_sentence_prefill(
        PT, TCFG, vs, torch.from_numpy(tokens),
        torch.tensor(TOKEN_LENS, dtype=torch.int32))


def _run_both(n_frames):
    js, ts = _jax_states(), _port_states()
    rngs = jnp.stack([jax.random.PRNGKey(i) for i in range(3)])
    zero_t = jnp.zeros((3,), jnp.float32)
    fae_j, ms_j = (jnp.asarray(FAE, jnp.int32),
                   jnp.asarray(MAX_STEPS, jnp.int32))
    fae_t, ms_t = (torch.tensor(FAE, dtype=torch.int32),
                   torch.tensor(MAX_STEPS, dtype=torch.int32))
    noise = torch.zeros(3, CFG.latent_dim)
    frames = []
    for _ in range(n_frames):
        js, pj, vj = jb.batched_frame_step(PJ, JCFG, js, rngs, zero_t,
                                           fae_j, ms_j)
        pt, vt = tb.batched_frame_step(PT, TCFG, ts, noise, fae_t, ms_t)
        frames.append((np.asarray(pj), np.asarray(vj), pt.numpy(),
                       vt.numpy()))
    return js, ts, frames


def test_prime_and_prefill_match_jax():
    js, ts = _jax_states(), _port_states()
    assert ts.flow.end == int(js.flow.end)
    np.testing.assert_array_equal(ts.flow.pos.numpy(),
                                  np.asarray(js.flow.pos))
    np.testing.assert_array_equal(ts.flow.next_pos.numpy(),
                                  np.asarray(js.flow.next_pos))
    for l in range(CFG.backbone.num_layers):
        np.testing.assert_allclose(ts.flow.k[l].numpy(),
                                   np.asarray(js.flow.k[l]), atol=ATOL,
                                   rtol=0)
        np.testing.assert_allclose(ts.flow.v[l].numpy(),
                                   np.asarray(js.flow.v[l]), atol=ATOL,
                                   rtol=0)


def test_batched_frame_step_matches_jax_temp0():
    js, ts, frames = _run_both(8)
    for f, (pj, vj, pt, vt) in enumerate(frames):
        np.testing.assert_array_equal(vt, vj, err_msg=f"frame {f}")
        np.testing.assert_allclose(pt, pj, atol=ATOL, rtol=0,
                                   err_msg=f"frame {f}")
    # lane 1 (max_steps 5) stopped; the others run on
    assert [v[1] for *_, v in frames] == [True] * 5 + [False] * 3
    np.testing.assert_array_equal(ts.done.numpy(), np.asarray(js.done))
    np.testing.assert_array_equal(ts.step.numpy(), np.asarray(js.step))
    np.testing.assert_array_equal(ts.eos_step.numpy(),
                                  np.asarray(js.eos_step))
    assert ts.flow.end == int(js.flow.end)
    assert ts.mimi.transformer.offset == int(js.mimi.transformer.offset)
    for key in js.mimi.seanet:
        np.testing.assert_allclose(ts.mimi.seanet[key].numpy(),
                                   np.asarray(js.mimi.seanet[key]),
                                   atol=ATOL, rtol=0, err_msg=key)


def test_compact_batch_matches_jax():
    js, ts, _ = _run_both(6)
    live = np.asarray([True, False, True])
    jc = jb.compact_batch(js, jnp.asarray(live), 48)
    tc = tb.compact_batch(ts, torch.from_numpy(live), 48)
    assert tc.flow.end == int(jc.flow.end)
    np.testing.assert_array_equal(tc.flow.pos.numpy(),
                                  np.asarray(jc.flow.pos))
    for l in range(CFG.backbone.num_layers):
        np.testing.assert_allclose(tc.flow.k[l].numpy(),
                                   np.asarray(jc.flow.k[l]), atol=ATOL,
                                   rtol=0)


# ------------------------------------------------------------ cursors ---

@pytest.mark.parametrize("end,steps", [(15, 1), (12, 5), (10, 13)])
def test_ring_wrap_advance_matches_jax(end, steps):
    """The shared cursor wraps inside [ring_start, S) while positions keep
    counting, as the JAX package's advance does."""
    s, ring_start = 16, 10
    js = jbackbone.init_state(dataclasses.replace(CFG.backbone,
                                                  kv_capacity=s))
    js = js.replace(end=jnp.int32(end), ring_start=jnp.int32(ring_start),
                    next_pos=jnp.int32(100))
    ts = backbone.BatchedBackboneState(
        k=[], v=[], pos=torch.full((2, s), -1, dtype=torch.int32),
        next_pos=torch.tensor([100, 7], dtype=torch.int32), end=end,
        ring_start=ring_start)
    for _ in range(steps):
        js = jbackbone.advance(js, 1, 1)
        backbone.advance_lanes(ts, 1, 1)
        assert ts.end == int(js.end)
        assert ring_start <= ts.end < s
    assert ts.next_pos.tolist() == [100 + steps, 7 + steps]


def test_linear_cursor_at_capacity_clamps_and_stops():
    """A linear batch whose cursor reaches capacity stops every lane at
    that frame (done), and further unconditional steps write the last slot
    instead of overflowing, as the JAX dynamic_update_slice clamps."""
    ts = _port_states()
    room = ts.flow.pos.shape[1] - ts.flow.end
    big = torch.tensor([10 ** 6] * 3, dtype=torch.int32)
    noise = torch.zeros(3, CFG.latent_dim)
    valids = []
    for _ in range(room + 2):
        _, v = tb.batched_frame_step(PT, TCFG, ts, noise, big, big)
        valids.append(v.tolist())
    assert valids[room - 1] == [True] * 3 and valids[room] == [False] * 3
    assert ts.done.all()


# --------------------------------------------------------- bookkeeping ---

def test_stack_unstack_roundtrip():
    ts = _port_states()
    solo = tb.unstack_states(ts)
    again = tb.stack_states(solo)
    assert again.flow.end == ts.flow.end
    for a, b in zip(again.flow.k + [again.flow.pos, again.step],
                    ts.flow.k + [ts.flow.pos, ts.step]):
        assert torch.equal(a, b)
    assert solo[1].flow.next_pos == int(ts.flow.next_pos[1])


def test_admit_group_drops_padding_lanes_and_sets_start():
    ts = _port_states()
    batch = tb.empty_batch_state(PT, TCFG, 4, ts.flow.pos.shape[1],
                                 ts.flow.end)
    batch.mimi.transformer.offset = 64
    tb.admit_group(batch, [2, 0, 4], ts)      # lane 4 is padding
    assert batch.done.tolist() == [False, True, False, True]
    assert batch.mimi.transformer.start.tolist() == [64, 0, 64, 0]
    assert torch.equal(batch.flow.pos[2], ts.flow.pos[0])
    assert torch.equal(batch.flow.pos[0], ts.flow.pos[1])
    assert torch.equal(batch.flow.k[0][2], ts.flow.k[0][0])
    assert (batch.flow.pos[1] == -1).all() and (batch.flow.pos[3] == -1).all()


def test_draw_noise_depends_on_seed_only():
    a = tb.draw_noise(5, 10, 4, 0.7, torch.float32, "cpu")
    b = tb.draw_noise(5, 10, 4, 0.7, torch.float32, "cpu")
    c = tb.draw_noise(6, 10, 4, 0.7, torch.float32, "cpu")
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert not tb.draw_noise(5, 3, 4, 0.0, torch.float32, "cpu").any()


def test_serving_cfg_sets_fuse_insert_and_refuses_a_mesh():
    assert TCFG.backbone.fuse_insert is True
    assert CFG.backbone.fuse_insert is None       # the caller's is kept
    off = dataclasses.replace(CFG, backbone=dataclasses.replace(
        CFG.backbone, fuse_insert=False))
    assert tb.serving_cfg(off).backbone.fuse_insert is False
    with pytest.raises(NotImplementedError):
        tb.serving_cfg(CFG, mesh=object())
