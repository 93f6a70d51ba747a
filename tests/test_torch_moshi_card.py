"""Moshi's kernels on the card, each against its plain version
(chip_smoke.py phase [14] runs the same and logs their times):

- K7 at D = 128: bf16, 32 heads, 32 lanes, a 3,072-slot ring with a
  3,000-slot window (and at D = 64, Pocket TTS's shapes, unchanged);
- K2 at 2 new rows a frame over 8 layers' rings, the rings after the
  insert equal to the plain insert's (and at 16 rows);
- K3 at four stages behind a first conv that widens 512 -> 1024 over 2
  rows a frame, over three frames of carries (and at three stages);
- Moshi's lane frame at full width from CUDA graphs, bit for bit the
  eager frame.

Skipped without a card. On the chip:
    python -m pytest tests/test_torch_moshi_card.py -m card -q
"""
import pytest
import torch

import chip_smoke as cs

pytestmark = pytest.mark.card


@pytest.fixture(scope="module")
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA)")
    return torch.device("cuda")


@pytest.mark.parametrize("d", [128, 64])
def test_k7_against_plain(d, device):
    row = cs.check_k7_moshi(device, d)
    assert row["err"] <= 3.2e-2


@pytest.mark.parametrize("t", [2, 16])
def test_k2_against_plain(t, device):
    row = cs.check_k2_moshi(device, t, layers=8 if t == 2 else 2)
    assert row["err"] <= 3.2e-2


@pytest.mark.parametrize("moshi_shape", [True, False])
def test_k3_against_plain(moshi_shape, device):
    row = cs.check_k3_moshi(device, moshi_shape)
    assert row["err"] <= 5e-2


def test_moshi_frames_from_graphs_equal_eager(device):
    row = cs.check_moshi_frames(device)
    assert row["frames_equal"]
