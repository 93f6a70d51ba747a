"""Moshi's kernels on the card, each against its plain version
(chip_smoke.py phase [14] runs the same and logs their times):

- K7 at D = 128: bf16, 32 heads, 32 lanes, a 3,072-slot ring with a
  3,000-slot window (and at D = 64, Pocket TTS's shapes, unchanged); the
  long-ring path (more than 2,048 slots) at D = 128 and D = 64 with bf16,
  float32 and int8 caches, with and without the statistics, an idle lane
  and lanes past the window, and at the duplex32 cell's ages; each lane
  and head within two ulps of its plain output's scale, m and l within
  1e-4, the caches after the insert equal to the plain insert's, one
  attended row dropped from the plain version failing the same
  comparison, each launch counted in `launches_long` (none at 1,024
  slots);
- K2 at 2 new rows a frame over 8 layers' rings, the rings after the
  insert equal to the plain insert's (and at 16 rows);
- K3 at four stages behind a first conv that widens 512 -> 1024 over 2
  rows a frame, over three frames of carries (and at three stages);
- Moshi's lane frame at full width from CUDA graphs, bit for bit the
  eager frame (a 256-slot ring, and a 2,304-slot one on K7's long-ring
  path, each of its 32 K7 launches a frame counted in `launches_long`).

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
    assert row["err"] <= 3.2e-2 and row["out_x"] <= 1.0


@pytest.mark.parametrize("d,kv8,stats", [
    (128, True, False), (128, False, True), (128, True, True),
    (64, False, False), (64, True, False), (64, False, True),
    (64, True, True)])
def test_k7_long_ring_variants_against_plain(d, kv8, stats, device):
    """At 3,072 slots (the long-ring path at either width), check_k7_moshi
    raises on an output, m or l outside its limit, a cache or scale row
    that differs from the plain insert, an idle lane that is not (0, -inf,
    0), a dropped row that passes the comparison, or a `launches_long`
    count other than 1."""
    row = cs.check_k7_moshi(device, d, kv8=kv8, stats=stats, s=3072)
    assert row["out_x"] <= 1.0 and row["drop_out_x"] > 1.0
    if stats:
        assert row["m_err"] <= 1e-4 and row["l_err"] <= 1e-4
        assert row["drop_l_err"] > 1e-4


@pytest.mark.parametrize("d", [128, 64])
def test_k7_long_ring_float32_against_plain(d, device):
    """The float32 working type on the long-ring path, with the
    statistics."""
    row = cs.check_k7_moshi(device, d, stats=True, s=3072,
                            dtype=torch.float32)
    assert row["out_x"] <= 1.0 and row["l_err"] <= 1e-4


@pytest.mark.parametrize("stats", [False, True])
def test_k7_at_the_cells_ages_against_plain(stats, device):
    """The lanes at the moshi7b.duplex32 cell's ages (chip_smoke.py times
    this case beside its bound)."""
    row = cs.check_k7_moshi(device, 128, stats=stats,
                            fills=cs.duplex_ages())
    assert row["out_x"] <= 1.0 and row["drop_out_x"] > 1.0


@pytest.mark.parametrize("t", [2, 16])
def test_k2_against_plain(t, device):
    row = cs.check_k2_moshi(device, t, layers=8 if t == 2 else 2)
    assert row["err"] <= 3.2e-2


@pytest.mark.parametrize("moshi_shape", [True, False])
def test_k3_against_plain(moshi_shape, device):
    row = cs.check_k3_moshi(device, moshi_shape)
    assert row["err"] <= 5e-2


@pytest.mark.parametrize("capacity", [256, 2304])
def test_moshi_frames_from_graphs_equal_eager(capacity, device):
    row = cs.check_moshi_frames(device, capacity=capacity)
    assert row["frames_equal"]
