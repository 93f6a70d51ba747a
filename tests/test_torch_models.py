"""Port models vs the JAX models on one random checkpoint (tiny_config,
f32, atol 1e-4 as the JAX model tests use): backbone prefill and decode
state, flow net, flow_lm decode step, mimi.decode_frame over several
frames. The JAX side runs both its XLA path and its Pallas kernels in
interpret mode."""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pocket_tts_tpu.config import tiny_config
from pocket_tts_tpu.io.params import params_from_flat, random_flat
from pocket_tts_tpu.models import backbone as jbb
from pocket_tts_tpu.models import flow_lm as jfl
from pocket_tts_tpu.models import flow_mlp as jfm
from pocket_tts_tpu.models import mimi as jmimi
from pocket_tts_tpu_torch.io.params import from_jax_numpy
from pocket_tts_tpu_torch.models import backbone as tbb
from pocket_tts_tpu_torch.models import flow_lm as tfl
from pocket_tts_tpu_torch.models import flow_mlp as tfm
from pocket_tts_tpu_torch.models import mimi as tmimi

torch.set_num_threads(1)
ATOL = 1e-4
CFG0 = tiny_config()
PJ, CFG = params_from_flat(random_flat(CFG0, seed=7), CFG0)
PT = from_jax_numpy(jax.tree.map(np.asarray, PJ))


def close(got, want, atol=ATOL, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol,
                               rtol=0, err_msg=msg)


def _with_pallas(cfg, on):
    return dataclasses.replace(
        cfg,
        backbone=dataclasses.replace(cfg.backbone, use_pallas_attn=on),
        mimi=dataclasses.replace(
            cfg.mimi,
            transformer=dataclasses.replace(cfg.mimi.transformer,
                                            use_pallas_attn=on),
            seanet=dataclasses.replace(cfg.mimi.seanet, use_pallas=on)))


def _assert_bb_state(st_t, st_j, msg=""):
    assert st_t.end == int(st_j.end), msg
    assert st_t.next_pos == int(st_j.next_pos), msg
    np.testing.assert_array_equal(st_t.pos.numpy(), np.asarray(st_j.pos))
    for l in range(len(st_j.k)):
        close(st_t.k[l], st_j.k[l], msg=f"{msg} k{l}")
        close(st_t.v[l], st_j.v[l], msg=f"{msg} v{l}")


@pytest.mark.parametrize("pallas", [False, True])
def test_backbone_prefill_then_decode(pallas):
    """Padded prefill (T=12, 10 valid) then 4 decode steps: y and the whole
    cache state (k, v, pos, end, next_pos) match, the T=1 steps through the
    JAX XLA path or its flash-decode kernel (interpret)."""
    cfg = _with_pallas(CFG, pallas).backbone
    rng = np.random.RandomState(1)
    x = rng.randn(12, cfg.d_model).astype(np.float32) * 0.5
    st_j = jbb.init_state(cfg)
    st_t = tbb.init_state(cfg)
    st_j, y_j = jbb.forward(PJ, cfg, st_j, jnp.asarray(x), 10)
    st_j = jbb.advance(st_j, 12, 10)
    st_t, y_t = tbb.forward(PT, cfg, st_t, torch.from_numpy(x), 10)
    tbb.advance(st_t, 12, 10)
    close(y_t, y_j, msg="prefill y")
    _assert_bb_state(st_t, st_j, "prefill")
    for i in range(4):
        xi = rng.randn(1, cfg.d_model).astype(np.float32) * 0.5
        st_j, y_j = jbb.forward(PJ, cfg, st_j, jnp.asarray(xi), 1)
        st_j = jbb.advance(st_j, 1, 1)
        st_t, y_t = tbb.forward(PT, cfg, st_t, torch.from_numpy(xi), 1)
        tbb.advance(st_t, 1, 1)
        close(y_t, y_j, msg=f"decode {i}")
        _assert_bb_state(st_t, st_j, f"decode {i}")


def test_shrink_state_copies():
    cfg = CFG.backbone
    st = tbb.init_state(cfg)
    tbb.forward(PT, cfg, st, torch.ones(5, cfg.d_model))
    tbb.advance(st, 5, 5)
    small = tbb.shrink_state(st, 64)
    assert small.k[0].shape[0] == 64 and small.end == 5
    small.k[0][0] += 1.0
    assert not torch.equal(small.k[0][0], st.k[0][0])
    jst = jbb.shrink_state(jbb.init_state(cfg), 64)
    assert jst.k[0].shape == tuple(small.k[0].shape)


@pytest.mark.parametrize("seed", [0, 1])
def test_flow_net(seed):
    rng = np.random.RandomState(seed)
    c = rng.randn(CFG.backbone.d_model).astype(np.float32)
    noise = rng.randn(CFG.latent_dim).astype(np.float32)
    close(tfm.time_cond(PT["flow_net"]), jfm.time_cond(PJ["flow_net"]),
          atol=1e-5)
    want = jfm.sample_latent(PJ["flow_net"], jnp.asarray(c),
                             jnp.asarray(noise), PJ["_time_cond"],
                             use_pallas=False)
    got = tfm.sample_latent(PT["flow_net"], torch.from_numpy(c),
                            torch.from_numpy(noise), PT["_time_cond"])
    close(got, want)


def test_flow_lm_decode_step():
    rng = np.random.RandomState(3)
    emb = rng.randn(8, CFG.backbone.d_model).astype(np.float32) * 0.3
    st_j = jfl.prefill(PJ, CFG, jbb.init_state(CFG.backbone),
                       jnp.asarray(emb), 8)
    st_t = tfl.prefill(PT, CFG, tbb.init_state(CFG.backbone),
                       torch.from_numpy(emb), 8)
    prev_j, prev_t = PJ["bos_emb"], PT["bos_emb"]
    for i in range(3):
        noise = rng.randn(CFG.latent_dim).astype(np.float32) * 0.5
        st_j, lat_j, eos_j = jfl.decode_step(PJ, CFG, st_j, prev_j,
                                             jnp.asarray(noise))
        st_t, lat_t, eos_t = tfl.decode_step(PT, CFG, st_t, prev_t,
                                             torch.from_numpy(noise))
        close(lat_t, lat_j, msg=f"step {i}")
        assert bool(eos_t) == bool(eos_j)
        close(tfl.denormalize(PT, lat_t), jfl.denormalize(PJ, lat_j))
        prev_j, prev_t = lat_j, lat_t


def test_embed_tokens_clamps_like_jax():
    ids = np.array([0, 5, 255, 263, 4000], np.int32)
    close(tfl.embed_tokens(PT, torch.from_numpy(ids).long()),
          jfl.embed_tokens(PJ, jnp.asarray(ids)), atol=0)


@pytest.mark.parametrize("pallas", [False, True])
def test_mimi_decode_frame_over_frames(pallas):
    """Five frames of mimi.decode_frame with every carry threaded: pcm and
    state (upsample carry, ring caches and offset, SEANet carries) match;
    the JAX side runs the XLA chain or its ring + SEANet kernels
    (interpret)."""
    mcfg = _with_pallas(CFG, pallas).mimi
    rng = np.random.RandomState(5)
    st_j = jmimi.init_state(mcfg)
    st_t = tmimi.init_state(mcfg)
    for f in range(5):
        lat = rng.randn(CFG.latent_dim).astype(np.float32)
        st_j, pcm_j = jmimi.decode_frame(PJ["mimi"], mcfg, st_j,
                                         jnp.asarray(lat))
        st_t, pcm_t = tmimi.decode_frame(PT["mimi"], mcfg, st_t,
                                         torch.from_numpy(lat))
        assert pcm_t.shape == (CFG.mimi.frame_size,)
        close(pcm_t, pcm_j, msg=f"frame {f} pcm")
        close(st_t.upsample_prev, st_j.upsample_prev)
        assert st_t.transformer.offset == int(st_j.transformer.offset)
        for l in range(len(st_j.transformer.k)):
            close(st_t.transformer.k[l], st_j.transformer.k[l])
            close(st_t.transformer.v[l], st_j.transformer.v[l])
        for key in st_j.seanet:
            close(st_t.seanet[key], st_j.seanet[key],
                  msg=f"frame {f} {key}")
