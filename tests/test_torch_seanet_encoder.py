"""The SEANet encoder of the port against the JAX package, on the CPU: the
loader's `mimi.encoder.model.N.*` tree (the JAX loader's, leaf for leaf),
one-shot encoding within 1e-5, streaming in 1920/total_stride-sample
chunks against one shot within 1e-5, and the quantized encoder
(convs=True: the JAX package's bytes, and its output within 1e-5 of the
largest magnitude) whose quantized convs run as one K4a / K4b call each."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pocket_tts_tpu.config import tiny_config
from pocket_tts_tpu.io import quant as jq
from pocket_tts_tpu.io.params import params_from_flat as jload
from pocket_tts_tpu.io.params import random_flat
from pocket_tts_tpu.models import seanet as jsn
from pocket_tts_tpu_torch.io import quant as tq
from pocket_tts_tpu_torch.io.params import params_from_flat as tload
from pocket_tts_tpu_torch.models import seanet as tsn

torch.set_num_threads(1)


def encoder_flat(cfg0, seed=5):
    """A flat checkpoint with `mimi.encoder.*` convs (the JAX package's
    tests/test_seanet_encoder.py layout)."""
    flat = random_flat(cfg0, seed=seed)
    sc = cfg0.mimi.seanet
    rng = np.random.RandomState(seed + 1)

    def put(name, cout, cin, k):
        flat[f"mimi.encoder.model.{name}.weight"] = (
            rng.randn(cout, cin, k) * (1.0 / np.sqrt(cin * k))).astype(
                np.float32)
        flat[f"mimi.encoder.model.{name}.bias"] = (
            rng.randn(cout) * 0.05).astype(np.float32)

    n = len(sc.stages)
    put("0.conv", sc.stages[-1].out_ch, sc.out_ch, sc.first_kernel)
    for gi, st in enumerate(reversed(sc.stages)):
        c = st.out_ch
        put(f"{3 * gi + 1}.block.1.conv", c // 2, c, sc.resnet_kernel)
        put(f"{3 * gi + 1}.block.3.conv", c, c // 2, 1)
        put(f"{3 * gi + 3}.conv", st.in_ch, st.out_ch, st.kernel)
    put(f"{3 * n + 2}.conv", sc.in_ch, sc.stages[0].in_ch, sc.last_kernel)
    return flat


def encoders(cfg0):
    flat = encoder_flat(cfg0)
    pj, cfg = jload(flat, cfg0)
    pt, _ = tload(flat, cfg0)
    return pj["mimi"]["encoder"], pt["mimi"]["encoder"], cfg.mimi.seanet


def _pcm(sc, frames, seed=2):
    return (np.random.RandomState(seed).randn(frames * sc.total_stride,
                                              sc.out_ch) * 0.5).astype(
                                                  np.float32)


def _rel(got, want, rel=1e-5):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= rel * max(np.abs(want).max(), 1e-30)


def test_loader_encoder_tree_equals_jax():
    ej, et, _ = encoders(tiny_config())
    for path, leaf in jax.tree_util.tree_flatten_with_path(ej)[0]:
        got = et
        for k in path:
            got = got[k.key]
        np.testing.assert_array_equal(got.numpy(), np.asarray(leaf))
    pt, _ = tload(random_flat(tiny_config(), seed=7), tiny_config())
    assert "encoder" not in pt["mimi"]


def test_encoder_oneshot_vs_jax():
    ej, et, sc = encoders(tiny_config())
    x = _pcm(sc, 2)
    _, yj = jsn.encoder_forward(ej, sc, jsn.encoder_init_state(sc),
                                jnp.asarray(x))
    _, yt = tsn.encoder_forward(et, sc, tsn.encoder_init_state(sc),
                                torch.from_numpy(x))
    assert yt.shape == (2, sc.in_ch)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), atol=1e-5,
                               rtol=0)


def test_encoder_streaming_equals_oneshot():
    """Chunks of total_stride samples carry exactly the causal context."""
    _, et, sc = encoders(tiny_config())
    frames = 4
    x = torch.from_numpy(_pcm(sc, frames, seed=4))
    _, once = tsn.encoder_forward(et, sc, tsn.encoder_init_state(sc), x)
    st = tsn.encoder_init_state(sc)
    outs = []
    for f in range(frames):
        st, y = tsn.encoder_forward(
            et, sc, st, x[f * sc.total_stride:(f + 1) * sc.total_stride])
        outs.append(y)
    np.testing.assert_allclose(torch.cat(outs).numpy(), once.numpy(),
                               atol=1e-5, rtol=0)


def test_encoder_refuses_partial_frames():
    _, et, sc = encoders(tiny_config())
    with pytest.raises(ValueError, match="multiple"):
        tsn.encoder_forward(et, sc, tsn.encoder_init_state(sc),
                            torch.zeros(sc.total_stride + 1, 1))


@pytest.mark.parametrize("bits", [8, 4])
def test_quantized_encoder_vs_jax(monkeypatch, bits):
    """tiny_config(128): block_1 of model_7 and the final model_11 reach
    the conv floor; quantize_params(convs=True) gives the JAX bytes, the
    streamed encoder matches JAX frame by frame, and each quantized conv
    is one K4a / K4b call a frame."""
    from pocket_tts_tpu_torch.ops import quant_matmul
    ej, et, sc = encoders(tiny_config(128))
    qj = jq.quantize_params(ej, bits=bits, convs=True)
    qt = tq.quantize_params(et, bits=bits, convs=True)
    key = "qc" if bits == 8 else "qc4"
    assert key in qt["model_7"]["block_1"] and key in qt["model_11"]
    fj = {jax.tree_util.keystr(k): np.asarray(v) for k, v in
          jax.tree_util.tree_flatten_with_path(qj)[0]}
    ft = dict(tq._flatten(qt))
    assert sorted(fj) == sorted(ft)
    for k, v in fj.items():
        assert ft[k].numpy().tobytes() == v.tobytes(), k
    fn = "int8_matmul" if bits == 8 else "int4_matmul"
    calls = []
    orig = getattr(quant_matmul, fn)
    monkeypatch.setattr(quant_matmul, fn,
                        lambda *a: calls.append(1) or orig(*a))
    x = _pcm(sc, 3, seed=6)
    sj, st = jsn.encoder_init_state(sc), tsn.encoder_init_state(sc)
    for f in range(3):
        chunk = x[f * sc.total_stride:(f + 1) * sc.total_stride]
        sj, yj = jsn.encoder_forward(qj, sc, sj, jnp.asarray(chunk))
        st, yt = tsn.encoder_forward(qt, sc, st, torch.from_numpy(chunk))
        _rel(yt, yj)
    assert len(calls) == 3 * 2
