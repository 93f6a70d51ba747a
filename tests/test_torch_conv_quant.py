"""Quantized SEANet convs in the port against the JAX package, on the CPU:

- `quantize_params(convs=True)` gives the JAX package's tree bit for bit
  for int8, int4 and q4_0 (the convs keep per-channel scales under q4_0);
- the conv ops on quantized layouts (conv1d, the streaming conv1d, the
  streaming transposed conv, flat and blocked) match the JAX ops at 1e-5
  of the output's largest magnitude (f32), and over a lane axis make ONE
  quantized product for all lanes;
- SEANet `forward` with quantized convs matches the JAX decoder frame
  after frame, runs no K3 (the route is the params' layout), and its lane
  axis matches solo;
- `synthesize` with quantize_convs matches the JAX engine at temp 0
  (atol 1e-4, as tests/test_torch_quant_e2e.py), and the serving mode
  with quantized convs serves the solo engine's audio;
- `quantization_error_report(convs=True)` equals the JAX report within
  1e-6, key for key.

tiny_config(64) is the width where model_0, model_2 and model_5 reach the
conv quantization floor (16384 elements); its weights are drawn at scale
0.05 so the quantized convs move the audio visibly."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pocket_tts_tpu.config import tiny_config
from pocket_tts_tpu.io import quant as jq
from pocket_tts_tpu.io.params import params_from_flat, random_flat
from pocket_tts_tpu.models import seanet as jseanet
from pocket_tts_tpu.ops import conv as jconv
from pocket_tts_tpu.runtime.engine import TTSEngine as JEngine
from pocket_tts_tpu.text.tokenizer import MockTokenizer
from pocket_tts_tpu_torch.io import quant as tq
from pocket_tts_tpu_torch.io.params import from_jax_numpy, random_voice_prompt
from pocket_tts_tpu_torch.models import seanet as tseanet
from pocket_tts_tpu_torch.ops import conv as tconv
from pocket_tts_tpu_torch.ops import quant_matmul
from pocket_tts_tpu_torch.runtime.engine import TTSEngine
from pocket_tts_tpu_torch.runtime.server import ContinuousBatchingServer

torch.set_num_threads(1)
ATOL = 1e-4
REL = 1e-5
CFG0 = tiny_config(64)
PJ, CFG = params_from_flat(random_flat(CFG0, seed=41, scale=0.05), CFG0)
VOICE = random_voice_prompt(CFG, 20)
TEXT = "Hello world. The quick brown fox jumps."
MODES = {"int8": dict(bits=8), "int4": dict(bits=4),
         "q4_0": dict(bits=4, group=32)}


def _np_tree(tree):
    """numpy leaves in the tree's own key order (jax.tree.map sorts)."""
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_np_tree(v) for v in tree)
    return np.asarray(tree)


PT = from_jax_numpy(_np_tree(PJ))


def _flat_j(tree):
    return {jax.tree_util.keystr(k): np.asarray(v) for k, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def _bits(t):
    return (t.view(torch.int16) if t.dtype == torch.bfloat16
            else t).numpy().tobytes()


def _close(got, want, rel=REL):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-30)
    assert float(np.abs(got - want).max()) <= rel * scale


@pytest.mark.parametrize("mode", sorted(MODES))
def test_quantize_params_convs_bit_for_bit(mode):
    want = _flat_j(jq.quantize_params(PJ, convs=True, **MODES[mode]))
    got = dict(tq._flatten(tq.quantize_params(PT, convs=True,
                                              **MODES[mode])))
    assert sorted(got) == sorted(want)
    for path, w in want.items():
        assert _bits(got[path]) == w.tobytes(), path
        assert got[path].is_contiguous(), path
    key = "qc" if mode == "int8" else "qc4"
    assert f"['mimi']['decoder']['model_0']['{key}']" in got
    # convs keep per-channel float32 scales under q4_0
    assert got["['mimi']['decoder']['model_0']['scale']"].dtype == \
        torch.float32
    assert got["['mimi']['decoder']['model_0']['scale']"].dim() == 1


def _conv_pair(kind, bits, seed):
    """(JAX params, port params) of one quantized conv: conv1d (Cout 128,
    Cin 64, K 3) or a K == 2*stride transposed conv (Cin 64, Cout 64,
    K 12)."""
    rng = np.random.RandomState(seed)
    if kind == "conv1d":
        name, w = "block_1", rng.randn(128, 64, 3) * 0.05
        b = rng.randn(128) * 0.01
    else:
        name, w = "model_2", rng.randn(64, 64, 12) * 0.05
        b = rng.randn(64) * 0.01
    tree = {name: {"w": jnp.asarray(w, jnp.float32),
                   "b": jnp.asarray(b, jnp.float32)}}
    pj = jq.quantize_params(tree, bits=bits, convs=True)[name]
    assert "w" not in pj
    return pj, from_jax_numpy(_np_tree(pj))


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("op", ["conv1d", "streaming_conv1d",
                                "streaming_convtr", "streaming_convtr_blocked"])
def test_quantized_conv_ops_match_jax(op, bits):
    rng = np.random.RandomState(3)
    if op.endswith("conv1d"):
        pj, pt = _conv_pair("conv1d", bits, 1)
        x = rng.randn(20, 64).astype(np.float32)
        if op == "conv1d":
            want = jconv.conv1d(pj, jnp.asarray(x))
            got = tconv.conv1d(pt, torch.from_numpy(x))
            _close(got, want)
            return
        prev = rng.randn(2, 64).astype(np.float32)
        wj = jconv.streaming_conv1d(pj, jnp.asarray(prev), jnp.asarray(x))
        wt = tconv.streaming_conv1d(pt, torch.from_numpy(prev),
                                    torch.from_numpy(x))
    else:
        pj, pt = _conv_pair("convtr", bits, 2)
        x = rng.randn(16, 64).astype(np.float32)
        s = 6
        if op == "streaming_convtr":
            prev = rng.randn(s, 64).astype(np.float32)
            wj = jconv.streaming_conv_transpose1d(
                pj, jnp.asarray(prev), jnp.asarray(x), s)
            wt = tconv.streaming_conv_transpose1d(
                pt, torch.from_numpy(prev), torch.from_numpy(x), s)
        else:
            prev = rng.randn(1, s * 64).astype(np.float32)
            wj = jconv.streaming_conv_transpose1d_blocked(
                pj, jnp.asarray(prev), jnp.asarray(x), s)
            wt = tconv.streaming_conv_transpose1d_blocked(
                pt, torch.from_numpy(prev), torch.from_numpy(x), s)
    for a, b in zip(wt, wj):
        _close(a, b)


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("kind", ["conv1d", "convtr"])
def test_lanes_make_one_quantized_product(kind, bits, monkeypatch):
    """x (B, T, C): every lane's rows go through ONE K4a / K4b call, and
    each lane equals the solo call."""
    _, pt = _conv_pair(kind, bits, 4)
    name = "int8_matmul" if bits == 8 else "int4_matmul"
    real, calls = getattr(quant_matmul, name), []

    def counted(x, *a):
        calls.append(x.shape)
        return real(x, *a)

    monkeypatch.setattr(quant_matmul, name, counted)
    rng = np.random.RandomState(5)
    x = torch.from_numpy(rng.randn(3, 16, 64).astype(np.float32))
    if kind == "conv1d":
        prev = torch.from_numpy(rng.randn(3, 2, 64).astype(np.float32))
        run = lambda xx, pp: tconv.streaming_conv1d(pt, pp, xx)  # noqa: E731
    else:
        prev = torch.from_numpy(rng.randn(3, 6, 64).astype(np.float32))
        run = lambda xx, pp: tconv.streaming_conv_transpose1d(  # noqa: E731
            pt, pp, xx, 6)
    lanes = run(x, prev)
    assert len(calls) == 1 and calls[0][0] == 3
    for i in range(3):
        solo = run(x[i], prev[i])
        for a, b in zip(lanes, solo):
            np.testing.assert_allclose(a[i].numpy(), b.numpy(), rtol=0,
                                       atol=1e-6)


def _decoders(mode):
    qj = jq.quantize_params(PJ, convs=True, **MODES[mode])
    return qj["mimi"]["decoder"], from_jax_numpy(_np_tree(qj))["mimi"][
        "decoder"]


@pytest.mark.parametrize("mode", sorted(MODES))
def test_seanet_forward_quantized_matches_jax(mode, monkeypatch):
    dj, dt = _decoders(mode)
    assert tseanet.quantized(dt)

    def no_k3(*a, **k):
        raise AssertionError("K3 called for a decoder with quantized convs")

    monkeypatch.setattr(tseanet, "seanet_frame", no_k3)
    sc = CFG.mimi.seanet
    sj, st = jseanet.init_state(sc, 16), tseanet.init_state(sc, 16)
    carries = {k: v for k, v in st.items()}
    rng = np.random.RandomState(6)
    for _ in range(3):
        x = rng.randn(16, sc.in_ch).astype(np.float32)
        sj, yj = jseanet.forward(dj, sc, sj, jnp.asarray(x))
        st2, yt = tseanet.forward(dt, sc, st, torch.from_numpy(x))
        assert st2 is st and all(st[k] is carries[k] for k in st)  # in place
        _close(yt, yj)
        for key in sj:
            _close(st[key], sj[key])


def test_seanet_quantized_lanes_match_solo():
    _, dt = _decoders("int8")
    sc = CFG.mimi.seanet
    rng = np.random.RandomState(7)
    xs = torch.from_numpy(rng.randn(2, 3, 16, sc.in_ch).astype(np.float32))
    lane_state = {k: v.expand(2, *v.shape).clone()
                  for k, v in tseanet.init_state(sc, 16).items()}
    solo_states = [tseanet.init_state(sc, 16) for _ in range(2)]
    for f in range(3):
        _, y = tseanet.forward(dt, sc, lane_state, xs[:, f])
        for i in range(2):
            _, yi = tseanet.forward(dt, sc, solo_states[i], xs[i, f])
            np.testing.assert_allclose(y[i].numpy(), yi.numpy(), rtol=0,
                                       atol=1e-6)


@pytest.mark.parametrize("mode", sorted(MODES))
def test_synthesize_quantize_convs_matches_jax(mode):
    quantize = {"int8": "int8", "int4": "int4", "q4_0": "q4_0"}[mode]
    want = JEngine(params=PJ, cfg=CFG, seed=0, quantize=quantize,
                   quantize_convs=True,
                   tokenizer=MockTokenizer(CFG.lut.n_bins)).synthesize(
                       TEXT, VOICE, temp=0.0)
    eng = TTSEngine(params=PT, cfg=CFG, seed=0, device="cpu",
                    quantize=quantize, quantize_convs=True,
                    tokenizer=MockTokenizer(CFG.lut.n_bins))
    assert tseanet.quantized(eng.params["mimi"]["decoder"])
    assert eng.seanet_weights is None
    got = eng.synthesize(TEXT, VOICE, temp=0.0)
    assert got.shape == want.shape and got.size > 0
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    # the quantized convs move the audio (the check above sees them)
    plain = TTSEngine(params=PT, cfg=CFG, seed=0, device="cpu",
                      quantize=quantize,
                      tokenizer=MockTokenizer(CFG.lut.n_bins)).synthesize(
                          TEXT, VOICE, temp=0.0)
    err = float(np.abs(got - want).max())
    assert float(np.abs(plain - want).max()) > 100 * max(err, 1e-7)


def test_serving_mode_with_quantized_convs_matches_solo():
    """int4 weights, int8 KV cache, shared prefix, quantized convs: each
    served request equals the solo engine's audio (the int8 KV cache
    rounds the same rows on both sides)."""
    import dataclasses
    cfg = dataclasses.replace(CFG, backbone=dataclasses.replace(
        CFG.backbone, kv_capacity=256))
    eng = TTSEngine(params=PT, cfg=cfg, seed=0, device="cpu",
                    quantize="int4", quantize_kv=True, quantize_convs=True,
                    tokenizer=MockTokenizer(cfg.lut.n_bins))
    srv = ContinuousBatchingServer(eng, lanes=2, chunk_frames=4,
                                   text_bucket=32, share_prefix=True)
    srv.register_voices({"v": VOICE})
    texts = ("Hello there.", "A second request here.")
    reqs = [srv.submit(t, "v", temp=0.0) for t in texts]
    srv.run_pending()
    from pocket_tts_tpu_torch.text.preprocess import prepare_text_prompt
    for r, text in zip(reqs, texts):
        prepared, guess = prepare_text_prompt(text)
        want = eng.synthesize_sentence(eng.prime_voice(VOICE), prepared, 0.0,
                                       guess + 2)
        assert r.pcm.shape == want.shape and want.size > 0
        np.testing.assert_allclose(r.pcm, want, atol=1e-3 * np.abs(
            want).max(), rtol=0)


@pytest.mark.parametrize("mode", sorted(MODES))
def test_quantization_error_report_matches_jax(mode):
    want = jq.quantization_error_report(PJ, convs=True, **MODES[mode])
    got = tq.quantization_error_report(PT, convs=True, **MODES[mode])
    assert sorted(got) == sorted(want)
    assert "['mimi']['decoder']['model_0']['w']" in got
    for key, v in want.items():
        assert abs(got[key] - v) <= 1e-6, key
        assert 0 <= got[key] < (0.2 if mode != "int8" else 0.01), key
