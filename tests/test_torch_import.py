"""The PyTorch port imports no JAX and no flax, even transitively: the
machine with the card has neither. Checked in a fresh interpreter, since
this test process has JAX loaded already."""
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
]


@pytest.mark.parametrize("module", MODULES)
def test_import_leaves_jax_out(module):
    code = (f"import sys, importlib; importlib.import_module({module!r}); "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax')); print(bad); "
            "sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_import_builds_nothing():
    """Importing the kernel modules neither compiles nor loads the CUDA
    library (the build happens at first launch, on the card)."""
    code = ("import pocket_tts_tpu_torch.ops.seanet_frame, "
            "pocket_tts_tpu_torch.ops.decode_attn, "
            "pocket_tts_tpu_torch.ops.ring_attn, "
            "pocket_tts_tpu_torch.ops.quant_matmul, "
            "pocket_tts_tpu_torch.ops.fused_layer, "
            "pocket_tts_tpu_torch.ops.fused_flow; "
            "from pocket_tts_tpu_torch.ops import cuda_lib; "
            "import sys; sys.exit(0 if cuda_lib._state['lib'] is None "
            "and 'triton' not in sys.modules else 1)")
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
