"""The lane frame from CUDA graphs on the card, at 256 lanes on both of the
benchmark's configurations (int4 weights with int8 KV and Mimi ring and
the shared prefix; bf16), over 50 frames with a backbone ring wrap, Mimi
ring wraps and admissions mid-run (chip_smoke.py phase [13] runs the same
and logs its times):

- the frames replayed from graphs equal the eager frames bit for bit
  (every frame's latents, every finished request's PCM);
- the `ptt.frame` spans read "capture" for the first frame and "replay"
  after it;
- K7 and K2 still count one launch a call: 6 and 2 a frame.

Skipped without a card. On the chip:
    python -m pytest tests/test_torch_frame_graph_card.py -m card -q
"""
import numpy as np
import pytest
import torch

import chip_smoke as cs

pytestmark = pytest.mark.card


@pytest.fixture(scope="module")
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA)")
    return torch.device("cuda")


@pytest.mark.parametrize("kind", ["int4kv8", "bf16"])
def test_graphed_frames_equal_eager_frames(kind, device):
    from pocket_tts_tpu_torch.config import DEFAULT_CONFIG
    from pocket_tts_tpu_torch.io.params import random_voice_prompt
    voice = random_voice_prompt(DEFAULT_CONFIG, 120)
    eng = cs.frame_graph_engine(kind, device)
    share = kind == "int4kv8"
    eager = cs.frame_graph_serve(eng, voice, share, graphs=False)
    graphed = cs.frame_graph_serve(eng, voice, share, graphs=True)
    frames = 5 * cs.FG_CHUNKS
    assert frames > cs.FG_RING and graphed["offset"] > 256  # both wrapped
    assert torch.equal(graphed["latents"], eager["latents"])
    assert len(graphed["pcm"]) == len(eager["pcm"]) > 0
    assert all(np.array_equal(a, b)
               for a, b in zip(graphed["pcm"], eager["pcm"]))
    assert set(eager["modes"]) == {"eager"}
    assert graphed["modes"] == ["capture"] + ["replay"] * (frames - 1)
    assert (eager["k7"], eager["k2"]) == (graphed["k7"], graphed["k2"]) \
        == (6, 2)
    assert graphed["segments"] > 9
