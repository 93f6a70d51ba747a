"""The CLI finds a model laid out as the JAX package's CLI expects it:
`<root>/kyutai/pocket-tts-without-voice-cloning/` under `-r/--model-root`
or `$MODEL_CACHE`, or the directory given with `-m`; the voice
embeddings come from the same directory, for solo synthesis and for
`--serve`. With no checkpoint there it notes so on stderr and runs random
weights and a random voice, as the JAX package's CLI does
(`pocket_tts_tpu/cli.py`). The checkpoint is written by `random_flat` at a
tiny config, which the test patches in as DEFAULT_CONFIG."""
import dataclasses
import os

import numpy as np
import pytest
import torch

from pocket_tts_tpu_torch import cli, config
from pocket_tts_tpu_torch.io import params as tparams
from pocket_tts_tpu_torch.io.safetensors_io import save_safetensors
from pocket_tts_tpu_torch.io.wav import load_wav

from _spm_fixture import write_ascii_model

torch.set_num_threads(1)
CFG = config.tiny_config()
CFG = dataclasses.replace(CFG, backbone=dataclasses.replace(
    CFG.backbone, kv_capacity=256))
SUB = os.path.join("kyutai", "pocket-tts-without-voice-cloning")


def model_tree(root):
    """A checkpoint, tokenizer and one default voice under root/SUB."""
    d = os.path.join(str(root), SUB)
    os.makedirs(os.path.join(d, "embeddings"))
    flat = tparams.random_flat(CFG, seed=4)
    save_safetensors({k: torch.from_numpy(v) for k, v in flat.items()},
                     os.path.join(d, "tts_b6369a24.safetensors"))
    write_ascii_model(os.path.join(d, "tokenizer.model"))
    prompt = tparams.random_voice_prompt(CFG, 9)
    save_safetensors({"voice.audio_prompt": torch.from_numpy(prompt[None])},
                     os.path.join(d, "embeddings", "cosette.safetensors"))
    return d


@pytest.mark.parametrize("how", ["-r", "MODEL_CACHE", "-m"])
def test_cli_finds_the_model_directory(how, tmp_path, monkeypatch):
    monkeypatch.setattr(config, "DEFAULT_CONFIG", CFG)
    root = tmp_path / "models"
    d = model_tree(root)
    monkeypatch.delenv("MODEL_CACHE", raising=False)
    where = {"-r": ["-r", str(root)], "-m": ["-m", d], "MODEL_CACHE": []}
    if how == "MODEL_CACHE":
        monkeypatch.setenv("MODEL_CACHE", str(root))
    out = str(tmp_path / "o.wav")
    assert cli.main(where[how] + ["--device", "cpu", "-t", "0", "-o", out,
                                  "Hello there."]) == 0
    pcm, sr = load_wav(out)
    assert sr == CFG.mimi.sample_rate and pcm.size > 0
    assert pcm.size % CFG.mimi.frame_size == 0


def test_cli_serve_reads_voices_from_the_model_root(tmp_path, monkeypatch):
    monkeypatch.setattr(config, "DEFAULT_CONFIG", CFG)
    root = tmp_path / "models"
    model_tree(root)
    reqs = tmp_path / "reqs.txt"
    reqs.write_text('{"text": "Hello there.", "voice": "cosette"}\n')
    out = tmp_path / "wavs"
    assert cli.main(["-r", str(root), "--device", "cpu", "-t", "0",
                     "--lanes", "2", "--serve", str(reqs), "--serve-out",
                     str(out)]) == 0
    assert os.listdir(out) == ["req_0000.wav"]


def test_cli_without_a_checkpoint_notes_and_uses_random_weights(
        tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(config, "DEFAULT_CONFIG", CFG)
    monkeypatch.setenv("MODEL_CACHE", str(tmp_path / "empty"))
    out = str(tmp_path / "o.wav")
    assert cli.main(["--device", "cpu", "-t", "0", "-o", out,
                     "Hello."]) == 0
    err = capsys.readouterr().err
    d = os.path.join(str(tmp_path / "empty"), SUB)
    assert f"note: no checkpoint under {d}; using random weights" in err
    # random weights never fire EOS: the sentence runs its whole budget,
    # (words + 2) frames a second of audio (runtime/engine.py), one
    # frame_size of samples a frame
    pcm, sr = load_wav(out)
    frames = int((1 + 2.0) * CFG.mimi.frame_rate)
    assert sr == CFG.mimi.sample_rate
    assert pcm.size == frames * CFG.mimi.frame_size
    assert np.isfinite(pcm).all()


def test_cli_megalayer_implies_fuse_insert(tmp_path, monkeypatch):
    """--megalayer sets use_megalayer and fuse_insert; with q4_0 weights
    the engine refuses it, with int8 it synthesizes."""
    monkeypatch.setattr(config, "DEFAULT_CONFIG", config.tiny_config(64))
    seen = {}
    from pocket_tts_tpu_torch.runtime import engine as teng
    real = teng.TTSEngine.__init__

    def init(self, *a, **k):
        real(self, *a, **k)
        seen["cfg"] = self.cfg

    monkeypatch.setattr(teng.TTSEngine, "__init__", init)
    out = str(tmp_path / "o.wav")
    assert cli.main(["--random-weights", "--device", "cpu", "-t", "0",
                     "--quantize", "int8", "--megalayer", "-o", out,
                     "Hi."]) == 0
    assert seen["cfg"].backbone.use_megalayer
    assert seen["cfg"].backbone.fuse_insert
    with pytest.raises(NotImplementedError, match="K-grouped"):
        cli.main(["--random-weights", "--device", "cpu", "--quantize",
                  "q4_0", "--megalayer", "Hi."])
    assert np.isfinite(load_wav(out)[0]).all()
