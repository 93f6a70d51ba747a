"""The last names of `models.tts` and `runtime.batched` that the port
lacked, against the JAX package at tiny_config, f32, temp 0 (atol 1e-4,
the port's end-to-end tolerance): `tts.init_stream_state`,
`tts.decode_sentence` (the fixed-length decode, past the stop) and
`batched.admit_stream` (one prefilled stream into a lane of a running
batch, before and after the mimi ring has moved)."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pocket_tts_tpu.config import tiny_config
from pocket_tts_tpu.io.params import params_from_flat, random_flat
from pocket_tts_tpu.models import backbone as jbackbone
from pocket_tts_tpu.models import mimi as jmimi
from pocket_tts_tpu.models import tts as jtts
from pocket_tts_tpu.runtime import batched as jb
from pocket_tts_tpu_torch.io.params import from_jax_numpy, random_voice_prompt
from pocket_tts_tpu_torch.models import backbone, tts
from pocket_tts_tpu_torch.runtime import batched as tb

torch.set_num_threads(1)
ATOL = 1e-4
CFG0 = tiny_config()
PJ, CFG = params_from_flat(random_flat(CFG0, seed=29), CFG0)
PT = from_jax_numpy(jax.tree.map(np.asarray, PJ))
JCFG = jb.mesh_cfg(CFG, None)
TCFG = tb.mesh_cfg(CFG)
PROMPT = random_voice_prompt(CFG, 16, seed=4)


def _tokens(n, seed):
    tokens = np.zeros(16, np.int64)
    tokens[:n] = np.random.RandomState(seed).randint(0, CFG.lut.n_bins, n)
    return tokens


def _jax_stream(n, seed, capacity=None):
    st = jbackbone.init_state(CFG.backbone)
    st = jtts.jit_prime_voice(PJ, CFG, st, jnp.asarray(PROMPT), 16)
    if capacity is not None:
        st = jbackbone.shrink_state(st, capacity)
    return jtts.jit_sentence_prefill(PJ, CFG, st, jmimi.init_state(CFG.mimi),
                                     jnp.asarray(_tokens(n, seed), jnp.int32),
                                     n)


def _port_stream(n, seed, capacity=None):
    st = tts.prime_voice(PT, CFG, backbone.init_state(CFG.backbone),
                         torch.from_numpy(PROMPT), 16)
    if capacity is not None:
        st = backbone.shrink_state(st, capacity)
    return tts.sentence_prefill(PT, CFG, st, torch.from_numpy(
        _tokens(n, seed)), n)


def test_init_stream_state_matches_jax():
    js = jtts.init_stream_state(PJ, CFG)
    ts = tts.init_stream_state(PT, CFG)
    assert ts.flow.end == int(js.flow.end) == 0
    assert ts.flow.next_pos == int(js.flow.next_pos) == 0
    np.testing.assert_array_equal(ts.flow.pos.numpy(), np.asarray(js.flow.pos))
    for a, b in zip(ts.flow.k + ts.mimi.transformer.k,
                    list(js.flow.k) + list(js.mimi.transformer.k)):
        assert tuple(a.shape) == b.shape and not a.any()
    np.testing.assert_array_equal(ts.prev_latent.numpy(),
                                  np.asarray(js.prev_latent))
    assert (ts.eos_step, ts.step, ts.done) == (
        int(js.eos_step), int(js.step), bool(js.done))
    assert tuple(ts.mimi.upsample_prev.shape) == js.mimi.upsample_prev.shape
    assert sorted(ts.mimi.seanet) == sorted(js.mimi.seanet)
    assert ts.prev_latent.device == PT["bos_emb"].device


@pytest.mark.parametrize("max_steps,scan_len", [(5, 9), (30, 12)])
def test_decode_sentence_matches_jax_past_the_stop(max_steps, scan_len):
    """scan_len frames exactly: the frames after the stop (max_steps 5 of
    9) are zeros with valid False on both sides."""
    js, ts = _jax_stream(10, 1), _port_stream(10, 1)
    _, jpcm, jvalid = jtts.jit_decode_sentence(
        PJ, CFG, js, jax.random.PRNGKey(0), jnp.float32(0.0), jnp.int32(3),
        jnp.int32(max_steps), scan_len)
    _, pcm, valid = tts.decode_sentence(
        PT, CFG, ts, lambda i: torch.zeros(CFG.latent_dim), 3, max_steps,
        scan_len)
    assert pcm.shape == (scan_len, CFG.mimi.frame_size)
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
    np.testing.assert_allclose(pcm.numpy(), np.asarray(jpcm), atol=ATOL,
                               rtol=0)
    stop = int(valid.numpy().sum())
    assert stop < scan_len or max_steps >= scan_len
    assert not pcm[stop:].any()


def test_admit_stream_matches_jax():
    """Two lanes: a stream admitted into lane 0 of an idle batch, three
    frames, a second stream into lane 1 (its mimi start is the ring offset
    then), four more frames; every frame's pcm and valid as the JAX
    package's."""
    cap, prefix = 128, 32
    jbatch = jb.empty_batch_state(PJ, JCFG, 2, cap, prefix)
    tbatch = tb.empty_batch_state(PT, TCFG, 2, cap, prefix)
    rngs = jnp.stack([jax.random.PRNGKey(i) for i in range(2)])
    jargs = (jnp.zeros((2,), jnp.float32), jnp.asarray([3, 3], jnp.int32),
             jnp.asarray([40, 40], jnp.int32))
    targs = (torch.tensor([3, 3], dtype=torch.int32),
             torch.tensor([40, 40], dtype=torch.int32))
    noise = torch.zeros(2, CFG.latent_dim)
    frames = []
    for lane, (n, seed), steps in ((0, (10, 1), 3), (1, (7, 2), 4)):
        jbatch = jb.admit_stream(jbatch, lane, _jax_stream(n, seed, cap))
        tb.admit_stream(tbatch, lane, _port_stream(n, seed, cap))
        for _ in range(steps):
            jbatch, jp, jv = jb.batched_frame_step(PJ, JCFG, jbatch, rngs,
                                                   *jargs)
            tp, tv = tb.batched_frame_step(PT, TCFG, tbatch, noise, *targs)
            frames.append((np.asarray(jp), np.asarray(jv), tp.numpy(),
                           tv.numpy()))
    assert tbatch.mimi.transformer.start.tolist() == [0, 3 * 16]
    assert tbatch.mimi.transformer.start.tolist() == np.asarray(
        jbatch.mimi.transformer.start).tolist()
    for f, (jp, jv, tp, tv) in enumerate(frames):
        np.testing.assert_array_equal(tv, jv, err_msg=f"frame {f}")
        np.testing.assert_allclose(tp, jp, atol=ATOL, rtol=0,
                                   err_msg=f"frame {f}")
    assert tbatch.flow.end == int(jbatch.flow.end)
    np.testing.assert_array_equal(tbatch.step.numpy(),
                                  np.asarray(jbatch.step))
