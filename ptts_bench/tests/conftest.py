import sys
from pathlib import Path

import pytest
import torch

torch.set_num_threads(2)
sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
sys.path.insert(0, str(Path(__file__).resolve().parent))


@pytest.fixture
def card():
    """The CUDA device; skips the test where there is none (decided when
    the test runs, never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is "
                    "False)")
    return torch.device("cuda", 0)
