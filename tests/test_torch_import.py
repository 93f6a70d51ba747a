"""The PyTorch port imports no JAX, no flax, no ml_dtypes and nothing of
the JAX package `pocket_tts_tpu`, even transitively: the machine with the
card has none of the first three, and the port keeps its own copies of the
JAX package's JAX-free modules (config, text, io.wav, io.safetensors_io,
io.audio, io.audio_in, io.gguf, the manifest half of io.fetch, native
with its own copy of the C++ source, runtime.player) and runs ab without
them; the mesh modules (parallel.*) and Moshi's (models.moshi,
runtime.moshi, io.moshi_params) included.
Checked in a fresh interpreter, since this test process has JAX loaded
already."""
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

MODULES = [
    "pocket_tts_tpu_torch",
    "pocket_tts_tpu_torch.runtime.engine",
    "pocket_tts_tpu_torch.cli",
    "pocket_tts_tpu_torch.io.params",
    "pocket_tts_tpu_torch.ops.decode_attn",
    "pocket_tts_tpu_torch.ops.ring_attn",
    "pocket_tts_tpu_torch.ops.seanet_frame",
    "pocket_tts_tpu_torch.ops.quant_matmul",
    "pocket_tts_tpu_torch.ops.fused_layer",
    "pocket_tts_tpu_torch.ops.fused_flow",
    "pocket_tts_tpu_torch.io.quant",
    "pocket_tts_tpu_torch.models.tts",
    "pocket_tts_tpu_torch.config",
    "pocket_tts_tpu_torch.ops.insert_attn",
    "pocket_tts_tpu_torch.ops.fused_step",
    "pocket_tts_tpu_torch.models.backbone",
    "pocket_tts_tpu_torch.models.mimi_transformer",
    "pocket_tts_tpu_torch.models.mimi",
    "pocket_tts_tpu_torch.runtime.batched",
    "pocket_tts_tpu_torch.runtime.server",
    "pocket_tts_tpu_torch.text.tokenizer",
    "pocket_tts_tpu_torch.text.preprocess",
    "pocket_tts_tpu_torch.io.wav",
    "pocket_tts_tpu_torch.io.safetensors_io",
    "pocket_tts_tpu_torch.utils.profiling",
    "pocket_tts_tpu_torch.utils.roofline",
    "pocket_tts_tpu_torch.io.audio",
    "pocket_tts_tpu_torch.io.audio_in",
    "pocket_tts_tpu_torch.native",
    "pocket_tts_tpu_torch.runtime.player",
    "pocket_tts_tpu_torch.ab",
    "pocket_tts_tpu_torch.io.gguf",
    "pocket_tts_tpu_torch.io.fetch",
    "pocket_tts_tpu_torch.ops.gating",
    "pocket_tts_tpu_torch.ops.attention",
    "pocket_tts_tpu_torch.models.seanet",
    "pocket_tts_tpu_torch.parallel",
    "pocket_tts_tpu_torch.parallel.sharding",
    "pocket_tts_tpu_torch.parallel.launch",
    "pocket_tts_tpu_torch.parallel.dryrun",
    "pocket_tts_tpu_torch.models.moshi",
    "pocket_tts_tpu_torch.runtime.moshi",
    "pocket_tts_tpu_torch.io.moshi_params",
    "chip_smoke",
]

# modules outside the port that it must never load
_BAD = ("sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'ml_dtypes', 'pocket_tts_tpu'))")


@pytest.mark.parametrize("module", MODULES)
def test_import_leaves_jax_out(module):
    code = (f"import sys, importlib; importlib.import_module({module!r}); "
            f"bad = {_BAD}; print(bad); sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_every_module_and_chip_smoke_together():
    """Every module file of the port, found by walking the package, and
    chip_smoke.py, imported into one interpreter."""
    code = ("import sys, importlib, pkgutil, pocket_tts_tpu_torch as p; "
            "mods = [m.name for m in pkgutil.walk_packages(p.__path__, "
            "'pocket_tts_tpu_torch.')]; "
            "[importlib.import_module(m) for m in mods + ['chip_smoke']]; "
            f"bad = {_BAD}; print(len(mods), bad); "
            "sys.exit(1 if bad or len(mods) < 30 else 0)")
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_import_builds_nothing():
    """Importing the kernel modules (K4b's int4_matmul and K8's fused_step
    among them) neither compiles nor loads the CUDA library (the build
    happens at first launch, on the card), and importing native, the
    engine and the player does not build the native library."""
    code = ("import pocket_tts_tpu_torch.ops.seanet_frame, "
            "pocket_tts_tpu_torch.ops.decode_attn, "
            "pocket_tts_tpu_torch.ops.ring_attn, "
            "pocket_tts_tpu_torch.ops.quant_matmul, "
            "pocket_tts_tpu_torch.ops.fused_layer, "
            "pocket_tts_tpu_torch.ops.fused_flow, "
            "pocket_tts_tpu_torch.ops.insert_attn, "
            "pocket_tts_tpu_torch.ops.fused_step; "
            "from pocket_tts_tpu_torch.ops import cuda_lib; "
            "from pocket_tts_tpu_torch import native; "
            "import pocket_tts_tpu_torch.runtime.engine, "
            "pocket_tts_tpu_torch.runtime.player; "
            "import sys; sys.exit(0 if cuda_lib._state['lib'] is None "
            "and native._state['lib'] is None "
            "and 'triton' not in sys.modules else 1)")
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
