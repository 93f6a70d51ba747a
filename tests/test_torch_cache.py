"""The params cache (safetensors container, layout stamp) shared by the
port and the JAX package, on a q4_0 tree at tiny_config(64), where every
backbone, mimi and flow linear has K-grouped bf16 scales:

- a JAX-written cache loads in the port with equal tensors (bits and
  dtypes), and its engine gives the audio of an engine on the same tree;
- a port-written cache loads in the JAX package with equal tensors, and
  the JAX engine on it matches the port's audio (f32, temp 0, atol 1e-4 as
  the other end-to-end tests);
- a cache with another layout stamp, or none, is refused;
- the port reads bf16 scales without ml_dtypes (absent on the card's
  machine);
- the CLI writes a cache and starts from one."""
import json
import os
import subprocess
import sys

import numpy as np
import jax
import pytest
import torch

from pocket_tts_tpu.config import tiny_config
from pocket_tts_tpu.io import quant as j_quant
from pocket_tts_tpu.io.params import params_from_flat, random_flat
from pocket_tts_tpu.io.safetensors_io import save_safetensors
from pocket_tts_tpu.runtime.engine import TTSEngine as JEngine
from pocket_tts_tpu.text.tokenizer import MockTokenizer
from pocket_tts_tpu_torch.io.params import from_jax_numpy
from pocket_tts_tpu_torch.io.params import params_from_flat as \
    t_params_from_flat
from pocket_tts_tpu_torch.io.params import random_voice_prompt
from pocket_tts_tpu_torch.io.quant import (load_params_cache,
                                           quantize_params,
                                           save_params_cache)
from pocket_tts_tpu_torch.runtime.engine import TTSEngine

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL = 1e-4
CFG0 = tiny_config(64)
FLAT = random_flat(CFG0, seed=17, scale=0.05)
PJ, CFG = params_from_flat(FLAT, CFG0)
QJ = j_quant.quantize_params(PJ, bits=4, group=32)
VOICE = random_voice_prompt(CFG, 20)
TEXT = "Hello world."


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        return {p: t for k, v in tree.items()
                for p, t in _leaves(v, f"{prefix}/{k}").items()}
    if isinstance(tree, (tuple, list)):
        return {p: t for i, v in enumerate(tree)
                for p, t in _leaves(v, f"{prefix}/{i}").items()}
    return {prefix: tree}


def _assert_same_tensors(got, want):
    got, want = _leaves(got), _leaves(want)
    assert sorted(got) == sorted(want)
    for path, t in want.items():
        u = got[path]
        assert u.dtype == t.dtype and u.shape == t.shape, path
        if t.dtype == torch.bfloat16:
            t, u = t.view(torch.int16), u.view(torch.int16)
        assert torch.equal(u, t), path


def _engine(params):
    return TTSEngine(params=params, cfg=CFG, seed=0, device="cpu",
                     tokenizer=MockTokenizer(CFG.lut.n_bins))


def test_jax_written_cache_loads_in_port(tmp_path):
    path = str(tmp_path / "jax.safetensors")
    j_quant.save_params_cache(QJ, path)
    got = load_params_cache(path)
    want = from_jax_numpy(jax.tree.map(np.asarray, QJ))
    _assert_same_tensors(got, want)
    assert got["layers"]["in_proj"]["scale"].dtype == torch.bfloat16
    assert got["layers"]["in_proj"]["q4"].dtype == torch.int8
    a = _engine(got).synthesize(TEXT, VOICE, temp=0.0)
    b = _engine(want).synthesize(TEXT, VOICE, temp=0.0)
    assert a.size > 0 and np.array_equal(a, b)


def test_port_written_cache_loads_in_jax(tmp_path):
    pt, _ = t_params_from_flat(FLAT, CFG0)
    qt = quantize_params(pt, bits=4, group=32)
    path = str(tmp_path / "port.safetensors")
    save_params_cache(qt, path)
    back = j_quant.load_params_cache(path)
    _assert_same_tensors(from_jax_numpy(jax.tree.map(np.asarray, back)), qt)
    jeng = JEngine.from_params_cache(path, CFG, seed=0,
                                     tokenizer=MockTokenizer(CFG.lut.n_bins))
    want = jeng.synthesize(TEXT, VOICE, temp=0.0)
    got = TTSEngine.from_params_cache(
        path, CFG, seed=0, device="cpu",
        tokenizer=MockTokenizer(CFG.lut.n_bins)).synthesize(
            TEXT, VOICE, temp=0.0)
    assert got.shape == want.shape and got.size > 0
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("layout", ["rope-halves-v0", None])
def test_cache_with_another_stamp_is_refused(tmp_path, layout):
    path = str(tmp_path / "old.safetensors")
    meta = {"pocket_tts_tree": json.dumps(
        {"__kind__": "dict", "items": {"a": {"__kind__": "leaf"}}})}
    if layout is not None:
        meta["pocket_tts_layout"] = layout
    save_safetensors({"['a']": np.zeros(3, np.float32)}, path, metadata=meta)
    with pytest.raises(ValueError, match="layout"):
        load_params_cache(path)
    with pytest.raises(NotImplementedError):
        load_params_cache(str(tmp_path / "x.gguf"))
    with pytest.raises(NotImplementedError):
        save_params_cache({"a": torch.zeros(3)}, str(tmp_path / "x.gguf"))


def test_port_reads_bf16_without_ml_dtypes(tmp_path):
    """In a fresh interpreter where `import ml_dtypes` fails, the port
    still reads a q4_0 cache: bf16 scales come back as torch.bfloat16 with
    the same bits."""
    path = str(tmp_path / "q40.safetensors")
    j_quant.save_params_cache(QJ, path)
    s = np.asarray(QJ["layers"]["in_proj"]["scale"]).view(np.int16)
    code = (
        "import sys; sys.modules['ml_dtypes'] = None\n"
        "import torch\n"
        "from pocket_tts_tpu_torch.io.quant import load_params_cache\n"
        f"t = load_params_cache({path!r})['layers']['in_proj']['scale']\n"
        "assert 'jax' not in sys.modules\n"
        "print(t.dtype, int(t.view(torch.int16).long().sum()))\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    assert res.stdout.split() == ["torch.bfloat16",
                                  str(int(s.astype(np.int64).sum()))]


def test_cli_saves_and_loads_cache(tmp_path, monkeypatch):
    from pocket_tts_tpu.io.wav import load_wav
    from pocket_tts_tpu_torch import cli, config
    from pocket_tts_tpu_torch.io import params as tparams
    real = tparams.random_params
    monkeypatch.setattr(tparams, "random_params",
                        lambda cfg, **kw: real(CFG0, **kw))
    path = str(tmp_path / "cli.safetensors")
    assert cli.main(["--random-weights", "--device", "cpu", "--quantize",
                     "q4_0", "--save-cache", path]) == 0
    saved = load_params_cache(path)
    assert saved["layers"]["in_proj"]["scale"].dtype == torch.bfloat16
    # a cache is loaded under DEFAULT_CONFIG, as the JAX CLI does
    monkeypatch.setattr(config, "DEFAULT_CONFIG", CFG)
    out = str(tmp_path / "out.wav")
    assert cli.main(["--load-cache", path, "--random-weights", "--device",
                     "cpu", "-t", "0", "-o", out, "Hello world."]) == 0
    pcm, sr = load_wav(out)
    assert sr == 24000 and pcm.size > 0 and pcm.size % 1920 == 0
