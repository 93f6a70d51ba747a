"""The port's GGUF container (pocket_tts_tpu_torch/io/gguf.py) against the
JAX package's (pocket_tts_tpu/io/gguf.py), case for case with the JAX
tests/test_gguf.py: every file written by either package reads in the
other with equal tensors and metadata, and the two writers give the same
bytes; the block codecs (Q8_0, Q4_0, Q8_K, Q4_K) give the same bytes and
the same dequantized values, within the JAX tests' error bounds; the
reference's name shortening, the long-name lookup, the divisibility and
alignment fallbacks; the params cache and the checkpoint in GGUF; and BF16
without ml_dtypes (raw 16-bit words as torch.bfloat16)."""
import os
import subprocess
import sys
import zlib

import ml_dtypes
import numpy as np
import pytest
import torch

from pocket_tts_tpu.io import gguf as jg
from pocket_tts_tpu_torch.io import gguf as tg

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = {"jax": jg, "port": tg}
PAIRS = [("jax", "port"), ("port", "jax"), ("port", "port")]


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(a, np.float32)


def _tensors(writer):
    """The JAX test's dtype set; bf16 as each writer takes it."""
    rng = np.random.RandomState(0)
    bf = rng.randn(4, 4).astype(np.float32)
    return {
        "a.f32": rng.randn(3, 5).astype(np.float32),
        "b.f16": rng.randn(8).astype(np.float16),
        "c.bf16": (bf.astype(ml_dtypes.bfloat16) if writer == "jax"
                   else torch.from_numpy(bf).to(torch.bfloat16)),
        "d.i8": rng.randint(-100, 100, (7,), dtype=np.int8),
        "e.i32": rng.randint(-5, 5, (2, 3), dtype=np.int32),
        "f.scalar": np.full((1,), 2.5, np.float32),
    }


@pytest.mark.parametrize("writer,reader", PAIRS)
def test_round_trip_dtypes_and_metadata(tmp_path, writer, reader):
    tensors = _tensors(writer)
    meta = {"general.name": "unit", "n": 7, "pi": 3.5, "flag": True,
            "tags": ["x", "y"]}
    path = str(tmp_path / "t.gguf")
    PKG[writer].write_gguf(path, tensors, metadata=meta)
    got, gmeta = PKG[reader].read_gguf(path)
    assert gmeta["general.name"] == "unit"
    assert gmeta["n"] == 7 and gmeta["pi"] == 3.5 and gmeta["flag"] is True
    assert gmeta["tags"] == ["x", "y"]
    for k, v in tensors.items():
        assert tuple(got[k].shape) == tuple(v.shape), k
        np.testing.assert_array_equal(_f32(got[k]), _f32(v), err_msg=k)
    if reader == "port":
        assert got["c.bf16"].dtype == torch.bfloat16
        assert got["b.f16"].dtype == np.float16


def test_writers_give_the_same_bytes(tmp_path):
    a, b = str(tmp_path / "j.gguf"), str(tmp_path / "t.gguf")
    meta = {"general.name": "unit", "tags": ["x"]}
    jg.write_gguf(a, _tensors("jax"), metadata=meta)
    tg.write_gguf(b, _tensors("port"), metadata=meta)
    assert open(a, "rb").read() == open(b, "rb").read()


@pytest.mark.parametrize("name", [
    "small", "x" * 63, "x" * 64,
    "pts.flow_lm.transformer.layers.0.self_attn.in_proj_weight"
    ".something_long", "['mimi']['decoder_transformer']['layers']"
    "['in_proj']['q4']"])
def test_shorten_name_matches_jax_and_reference(name):
    assert tg.shorten_name(name) == jg.shorten_name(name)
    if len(name) >= 64:
        crc = zlib.crc32(name.encode())
        assert tg.shorten_name(name) == "".join(
            "0123456789abcdef"[(crc >> (8 * i)) & 0xF]
            for i in range(4)) + "0000"
    else:
        assert tg.shorten_name(name) == name


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_long_names_load_by_original_key(tmp_path, writer):
    long_a = "block." + "a" * 70
    long_b = "block." + "b" * 70
    tensors = {long_a: np.arange(6, dtype=np.float32).reshape(2, 3),
               long_b: np.ones((4,), np.float32),
               "short": np.zeros((2,), np.float32)}
    path = str(tmp_path / "long.gguf")
    PKG[writer].write_gguf(path, tensors)
    f = tg.GGUFFile(path)
    assert tg.shorten_name(long_a) in f.infos
    np.testing.assert_array_equal(f.get(long_a), tensors[long_a])
    f._longnames.clear()
    np.testing.assert_array_equal(f.get(long_b), tensors[long_b])
    with pytest.raises(KeyError):
        f.get("missing")


def _codec_input(codec):
    rng = np.random.RandomState({"q8_0": 1, "q4_0": 2, "q8_k": 4,
                                 "q4_k": 5}[codec])
    if codec == "q8_0":
        return (rng.randn(8, 64) * 3).astype(np.float32)
    if codec == "q4_0":
        return rng.randn(4, 96).astype(np.float32)
    if codec == "q8_k":
        x = (rng.randn(4, 512) * 2).astype(np.float32)
        x[3, :256] = 0.0
        return x
    return (rng.randn(8, 256) + 3.0).astype(np.float32)


@pytest.mark.parametrize("codec", ["q8_0", "q4_0", "q8_k", "q4_k"])
def test_codec_matches_jax_and_its_bound(codec):
    x = _codec_input(codec)
    raw = getattr(tg, f"quantize_{codec}")(x)
    assert raw == getattr(jg, f"quantize_{codec}")(x)
    back = getattr(tg, f"dequantize_{codec}")(raw, x.size).reshape(x.shape)
    np.testing.assert_array_equal(
        back, getattr(jg, f"dequantize_{codec}")(raw, x.size).reshape(
            x.shape))
    err = np.abs(back - x)
    if codec == "q8_0":
        assert len(raw) == 8 * 64 // 32 * 34
        assert err.max() <= np.abs(x).max() / 127.0 + 1e-6
    elif codec == "q4_0":
        assert len(raw) == 4 * 96 // 32 * 18
        scales = np.abs(x.reshape(-1, 32)).max(axis=1) / 8.0
        assert err.reshape(-1, 32).max(axis=1).max() <= scales.max() + 1e-6
    elif codec == "q8_k":
        assert len(raw) == 4 * 512 // 256 * 292
        scales = np.abs(x.reshape(-1, 256)).max(axis=1) / 128.0
        assert err.reshape(-1, 256).max(axis=1).max() <= \
            scales.max() * 0.75 + 1e-7
        np.testing.assert_array_equal(back[3, :256], 0.0)
        blk = np.frombuffer(raw, np.uint8).reshape(-1, 292)
        q = blk[:, 4:260].copy().view(np.int8).astype(np.int32)
        bsums = blk[:, 260:].copy().view(np.int16)
        np.testing.assert_array_equal(q.reshape(-1, 16, 16).sum(axis=2),
                                      bsums)
    else:
        assert len(raw) == 8 * 144
        sub = x.reshape(-1, 32)
        step = (sub.max(axis=1) - np.minimum(sub.min(axis=1), 0)) / 15.0
        assert err.reshape(-1, 32).max(axis=1).max() <= \
            1.3 * step.max() + 1e-6


def test_q4_k_scale_packing_and_offset_data():
    rng = np.random.RandomState(5)
    ls = rng.randint(0, 64, (5, 8)).astype(np.uint8)
    lm = rng.randint(0, 64, (5, 8)).astype(np.uint8)
    packed = tg._pack_scale_min_k4(ls, lm)
    np.testing.assert_array_equal(packed, jg._pack_scale_min_k4(ls, lm))
    s, m = tg._unpack_scale_min_k4(packed)
    np.testing.assert_array_equal(s, ls)
    np.testing.assert_array_equal(m, lm)
    rng = np.random.RandomState(6)
    x = (rng.rand(16, 256) * 0.5 + 1.0).astype(np.float32)
    e_k = np.abs(tg.dequantize_q4_k(tg.quantize_q4_k(x), x.size).reshape(
        x.shape) - x).mean()
    e_0 = np.abs(tg.dequantize_q4_0(tg.quantize_q4_0(x), x.size).reshape(
        x.shape) - x).mean()
    assert e_k < e_0 * 0.6


@pytest.mark.parametrize("quantize", ["q4_k", "q8_k"])
def test_write_k_quant_with_divisibility_fallback(tmp_path, quantize):
    rng = np.random.RandomState(7)
    tensors = {"k": rng.randn(8, 256).astype(np.float32),
               "b32": rng.randn(8, 96).astype(np.float32),
               "odd": rng.randn(8, 33).astype(np.float32),
               "bf": torch.randn(8, 256).to(torch.bfloat16)}
    a, b = str(tmp_path / "j.gguf"), str(tmp_path / "t.gguf")
    jg.write_gguf(a, dict(tensors, bf=tensors["bf"].float().numpy().astype(
        ml_dtypes.bfloat16)), quantize=quantize, min_quant_size=1)
    tg.write_gguf(b, tensors, quantize=quantize, min_quant_size=1)
    assert open(a, "rb").read() == open(b, "rb").read()
    f = tg.GGUFFile(b)
    kq, bq = (tg.Q4_K, tg.Q4_0) if quantize == "q4_k" else (tg.Q8_K,
                                                             tg.Q8_0)
    assert [f.infos[n][0] for n in ("k", "b32", "odd", "bf")] == \
        [kq, bq, tg.F32, kq]
    for name in ("k", "b32"):
        rel = np.abs(f.get(name) - tensors[name]).max() / np.abs(
            tensors[name]).max()
        assert rel < 0.2, name
    np.testing.assert_array_equal(f.get("odd"), tensors["odd"])


def test_write_quantized_with_alignment_fallback(tmp_path):
    rng = np.random.RandomState(3)
    tensors = {"big": rng.randn(128, 64).astype(np.float32),
               "odd": rng.randn(128, 33).astype(np.float32),
               "tiny": rng.randn(4, 4).astype(np.float32),
               "ints": rng.randint(-9, 9, (128, 64)).astype(np.int8)}
    a, b = str(tmp_path / "j.gguf"), str(tmp_path / "t.gguf")
    jg.write_gguf(a, tensors, quantize="q8_0", min_quant_size=1024)
    tg.write_gguf(b, tensors, quantize="q8_0", min_quant_size=1024)
    assert open(a, "rb").read() == open(b, "rb").read()
    f = tg.GGUFFile(b)
    assert [f.infos[n][0] for n in ("big", "odd", "tiny", "ints")] == \
        [tg.Q8_0, tg.F32, tg.F32, tg.I8]
    rel = np.abs(f.get("big") - tensors["big"]).max() / np.abs(
        tensors["big"]).max()
    assert rel < 0.02
    np.testing.assert_array_equal(f.get("odd"), tensors["odd"])
    np.testing.assert_array_equal(f.get("ints"), tensors["ints"])


def test_bad_magic_rejected(tmp_path):
    p = tmp_path / "bad.gguf"
    p.write_bytes(b"NOPE" + b"\x00" * 64)
    with pytest.raises(ValueError, match="not a GGUF"):
        tg.GGUFFile(str(p))


def test_bf16_read_without_ml_dtypes(tmp_path):
    """In a fresh interpreter where `import ml_dtypes` fails, the port
    reads a JAX-written BF16 tensor as torch.bfloat16 with its bits."""
    path = str(tmp_path / "bf.gguf")
    x = np.random.RandomState(8).randn(5, 7).astype(np.float32)
    jg.write_gguf(path, {"w": x.astype(ml_dtypes.bfloat16)})
    words = x.astype(ml_dtypes.bfloat16).view(np.int16)
    code = (
        "import sys, numpy as np, torch\n"
        "sys.modules['ml_dtypes'] = None\n"
        "from pocket_tts_tpu_torch.io.gguf import read_gguf\n"
        f"t, _ = read_gguf({path!r})\n"
        "w = t['w']\n"
        "assert w.dtype == torch.bfloat16\n"
        f"assert w.view(torch.int16).numpy().tolist() == {words.tolist()}\n"
        "assert 'ml_dtypes' not in [m for m in sys.modules if sys.modules[m]]"
        "\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


# ------------------------------------------- params cache and checkpoint --

def _cfg_and_trees(seed=5):
    import jax
    from pocket_tts_tpu.config import tiny_config
    from pocket_tts_tpu.io.params import params_from_flat, random_flat
    from pocket_tts_tpu_torch.io.params import from_jax_numpy

    def np_tree(t):
        if isinstance(t, dict):
            return {k: np_tree(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(np_tree(v) for v in t)
        return np.asarray(t)

    cfg0 = tiny_config(64)
    pj, cfg = params_from_flat(random_flat(cfg0, seed=seed), cfg0)
    del jax
    return cfg, pj, from_jax_numpy(np_tree(pj))


@pytest.mark.parametrize("gguf_quantize", [None, "q8_0", "q4_0", "q8_k",
                                           "q4_k"])
@pytest.mark.parametrize("mode", ["float", "int8", "q4_0"])
def test_params_cache_same_bytes_and_cross_read(tmp_path, mode,
                                                gguf_quantize):
    """The same tree (a JAX tree and its port copy, quantized with convs by
    each package) written by each package's save_params_cache to a .gguf
    path gives the same bytes; each package reads the other's file with
    the same tensors."""
    import jax
    from pocket_tts_tpu.io import quant as jq
    from pocket_tts_tpu_torch.io import quant as tq
    _, pj, pt = _cfg_and_trees()
    if mode != "float":
        kw = dict(bits=8) if mode == "int8" else dict(bits=4, group=32)
        pj = jq.quantize_params(pj, convs=True, **kw)
        pt = tq.quantize_params(pt, convs=True, **kw)
    a, b = str(tmp_path / "j.gguf"), str(tmp_path / "t.gguf")
    jq.save_params_cache(pj, a, gguf_quantize=gguf_quantize)
    tq.save_params_cache(pt, b, gguf_quantize=gguf_quantize)
    assert open(a, "rb").read() == open(b, "rb").read()
    back_t = dict(tq._flatten(tq.load_params_cache(a)))
    back_j = {jax.tree_util.keystr(k): np.asarray(v) for k, v in
              jax.tree_util.tree_flatten_with_path(
                  jq.load_params_cache(b))[0]}
    assert sorted(back_t) == sorted(back_j)
    for key, v in back_j.items():
        assert tuple(back_t[key].shape) == v.shape, key
        np.testing.assert_array_equal(_f32(back_t[key]), _f32(v),
                                      err_msg=key)


def test_engine_from_gguf_cache_casts_to_its_dtype(tmp_path):
    """A q8_0 GGUF cache reads its block-quantized float leaves back in
    float32, q4_0's grouped bf16 scales included (as the JAX package
    does); the engine casts its float leaves to the engine dtype and each
    quantized scale to its storage type, and synthesizes."""
    from pocket_tts_tpu_torch.io.quant import load_params_cache, \
        quantize_params, save_params_cache
    from pocket_tts_tpu_torch.io.params import random_voice_prompt
    from pocket_tts_tpu_torch.runtime.engine import TTSEngine
    from pocket_tts_tpu_torch.text.tokenizer import MockTokenizer
    cfg, _, pt = _cfg_and_trees()
    tree = quantize_params(pt, bits=4, group=32, convs=True)
    path = str(tmp_path / "c.gguf")
    save_params_cache(tree, path, gguf_quantize="q8_0")
    raw = load_params_cache(path)
    assert raw["layers"]["in_proj"]["scale"].dtype == torch.float32
    eng = TTSEngine.from_params_cache(path, cfg, device="cpu",
                                      dtype=torch.float32, seed=0,
                                      tokenizer=MockTokenizer(cfg.lut.n_bins))
    assert eng.params["layers"]["in_proj"]["scale"].dtype == torch.bfloat16
    assert eng.params["mimi"]["decoder"]["model_0"]["scale"].dtype == \
        torch.float32
    assert eng.params["bos_emb"].dtype == torch.float32
    pcm = eng.synthesize("Hi.", random_voice_prompt(cfg, 12), temp=0.0)
    assert pcm.size > 0 and np.isfinite(pcm).all()


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoint_load_from_gguf(tmp_path, writer):
    """load_checkpoint on a .gguf checkpoint (written by either package,
    f32) gives the tree of the same flat dict from safetensors."""
    from pocket_tts_tpu.config import tiny_config
    from pocket_tts_tpu_torch.io.params import load_checkpoint, random_flat
    from pocket_tts_tpu_torch.io.quant import _flatten
    from pocket_tts_tpu_torch.io.safetensors_io import save_safetensors
    cfg0 = tiny_config()
    flat = random_flat(cfg0, seed=7)
    g, s = str(tmp_path / "tts_b6369a24.gguf"), str(tmp_path / "a.safetensors")
    PKG[writer].write_gguf(g, flat)
    save_safetensors(flat, s)
    pg, cg = load_checkpoint(g, cfg0)
    ps, cs = load_checkpoint(s, cfg0)
    assert cg == cs
    fg, fs = dict(_flatten(pg)), dict(_flatten(ps))
    assert sorted(fg) == sorted(fs)
    for key in fs:
        assert torch.equal(fg[key], fs[key]), key


def test_engine_falls_back_to_the_gguf_checkpoint(tmp_path):
    """TTSEngine(model_path) with tts_b6369a24.gguf and no .safetensors
    loads the GGUF checkpoint and gives the audio of the safetensors
    directory."""
    from pocket_tts_tpu.config import tiny_config
    from pocket_tts_tpu_torch.io.params import random_flat, \
        random_voice_prompt
    from pocket_tts_tpu_torch.io.safetensors_io import save_safetensors
    from pocket_tts_tpu_torch.runtime.engine import TTSEngine
    from pocket_tts_tpu_torch.text.tokenizer import MockTokenizer
    cfg0 = tiny_config()
    flat = random_flat(cfg0, seed=9)
    pcms = []
    for ext in ("gguf", "safetensors"):
        d = tmp_path / ext
        d.mkdir()
        path = str(d / f"tts_b6369a24.{ext}")
        (tg.write_gguf if ext == "gguf" else
         lambda p, t: save_safetensors(t, p))(path, flat)
        eng = TTSEngine(model_path=str(d), cfg=cfg0, device="cpu", seed=0,
                        tokenizer=MockTokenizer(cfg0.lut.n_bins))
        pcms.append(eng.synthesize("Hello there.",
                                   random_voice_prompt(eng.cfg, 12),
                                   temp=0.0))
    assert pcms[0].size > 0 and np.array_equal(pcms[0], pcms[1])
