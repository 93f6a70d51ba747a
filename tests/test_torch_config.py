"""The port's own copies of the JAX package's JAX-free modules: the config
dataclasses equal the JAX package's field by field, the text front end
gives the same ids, prompts and chunks, and the safetensors reader loads
BF16 checkpoints and voice files without ml_dtypes (which the machine with
the card lacks)."""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from pocket_tts_tpu import config as jconfig
from pocket_tts_tpu.text import preprocess as jpre
from pocket_tts_tpu.text.tokenizer import MockTokenizer as JMock
from pocket_tts_tpu.text.tokenizer import load_tokenizer as jload
from pocket_tts_tpu_torch import config as tconfig
from pocket_tts_tpu_torch.io import params as tparams
from pocket_tts_tpu_torch.io.safetensors_io import (load_safetensors,
                                                    save_safetensors)
from pocket_tts_tpu_torch.text import preprocess as tpre
from pocket_tts_tpu_torch.text.tokenizer import MockTokenizer as TMock
from pocket_tts_tpu_torch.text.tokenizer import load_tokenizer as tload

from _spm_fixture import write_ascii_model

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SENTENCES = [
    "Hello world.",
    "  the quick brown fox   jumps over the lazy dog  ",
    "Check the stream! Is it fine? Yes... it is; mostly: (fine).",
    "one two three four five six seven eight nine ten eleven twelve "
    "thirteen fourteen fifteen sixteen seventeen eighteen nineteen twenty "
    "and then some more words to force a split into chunks.",
    "x",
]


@pytest.mark.parametrize("name,args", [("DEFAULT_CONFIG", None),
                                       ("tiny_config", ()),
                                       ("tiny_config", (64,)),
                                       ("reference_exact_config", ())])
def test_config_equals_jax_field_by_field(name, args):
    j, t = getattr(jconfig, name), getattr(tconfig, name)
    if args is not None:
        j, t = j(*args), t(*args)
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    assert t.backbone.head_dim == j.backbone.head_dim
    assert t.mimi.frame_size == j.mimi.frame_size


def test_check_supported_takes_fuse_insert():
    cfg = tconfig.tiny_config()
    tconfig.check_supported(dataclasses.replace(
        cfg, backbone=dataclasses.replace(cfg.backbone, fuse_insert=True)))


def _tokenizers(tmp_path):
    path = str(tmp_path / "tokenizer.model")
    write_ascii_model(path)
    return [(JMock(256), TMock(256)), (jload(path), tload(path))]


@pytest.mark.parametrize("text", SENTENCES)
def test_tokenizer_and_preprocess_match_jax(text, tmp_path):
    assert tpre.prepare_text_prompt(text) == jpre.prepare_text_prompt(text)
    assert tpre.count_words(text) == jpre.count_words(text)
    for jt, tt in _tokenizers(tmp_path):
        prepared, _ = tpre.prepare_text_prompt(text)
        assert tt.encode(prepared) == jt.encode(prepared)
        for budget in (8, 50):
            assert (tpre.split_into_best_sentences(tt, text, budget)
                    == jpre.split_into_best_sentences(jt, text, budget))


def test_str_processor_matches_jax():
    jp, tp = jpre.StrProcessor(), tpre.StrProcessor()
    text = " ".join(SENTENCES)
    for i in range(0, len(text), 7):
        jp.ingest(text[i:i + 7])
        tp.ingest(text[i:i + 7])
    jp.flush()
    tp.flush()
    assert list(tp.sentences) == list(jp.sentences)


def test_bf16_voice_and_checkpoint_load_without_ml_dtypes(tmp_path):
    """BF16 files are written with the port's writer; a fresh interpreter
    with ml_dtypes blocked loads them, and the values are the file's bits
    exactly."""
    cfg = tconfig.tiny_config()
    flat = tparams.random_flat(cfg, seed=9)
    ckpt = str(tmp_path / "ckpt.safetensors")
    save_safetensors({k: torch.from_numpy(v).to(torch.bfloat16)
                      for k, v in flat.items()}, ckpt)
    prompt = tparams.random_voice_prompt(cfg, 9)
    voice = str(tmp_path / "voice.safetensors")
    save_safetensors({"voice.audio_prompt":
                      torch.from_numpy(prompt[None]).to(torch.bfloat16)},
                     voice)
    code = f"""
import sys
sys.modules["ml_dtypes"] = None   # any import of it now fails
import numpy as np, torch
from pocket_tts_tpu_torch.config import tiny_config
from pocket_tts_tpu_torch.io import params
v = params.load_voice({voice!r}, torch.bfloat16)
p, _ = params.load_checkpoint({ckpt!r}, tiny_config(), torch.bfloat16)
torch.save({{"voice": v, "in_proj": p["layers"]["in_proj"]["w"],
            "emb": p["conditioner"]["embed"]}}, {str(tmp_path / "o.pt")!r})
assert "ml_dtypes" not in [m for m in sys.modules if sys.modules[m]]
"""
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    got = torch.load(str(tmp_path / "o.pt"))
    want_v = torch.from_numpy(prompt).to(torch.bfloat16)
    assert torch.equal(got["voice"], want_v)
    rounded = {k: torch.from_numpy(v).to(torch.bfloat16).float().numpy()
               for k, v in flat.items()}
    want, _ = tparams.params_from_flat(rounded, cfg, torch.bfloat16)
    assert torch.equal(got["in_proj"], want["layers"]["in_proj"]["w"])
    assert torch.equal(got["emb"], want["conditioner"]["embed"])


def test_safetensors_roundtrip_types(tmp_path):
    path = str(tmp_path / "t.safetensors")
    arrs = {"f32": np.arange(6, dtype=np.float32).reshape(2, 3),
            "i8": np.arange(-3, 3, dtype=np.int8),
            "bf16": torch.tensor([1.5, -2.25, 3e-3], dtype=torch.bfloat16)}
    save_safetensors(arrs, path, metadata={"k": "v"})
    out, meta = load_safetensors(path, with_metadata=True)
    assert meta == {"k": "v"}
    np.testing.assert_array_equal(out["f32"], arrs["f32"])
    np.testing.assert_array_equal(out["i8"], arrs["i8"])
    assert out["bf16"].dtype == np.float32
    np.testing.assert_array_equal(out["bf16"], arrs["bf16"].float().numpy())
