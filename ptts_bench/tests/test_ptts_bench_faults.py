"""A run with the timed path broken underneath comes out not correct: a
step that leaves the decode state where it was, half the lanes' outputs
replaced by the other half's, and a latent altered where it is produced.
(The exchange between chips is not a fault these one-card cells can
have.) Tiny sizes, float32, on the CPU; the harness's look for a card is
skipped by calling `run_cell` directly."""
import pytest
import torch

import _tiny
from ptts_bench import run, serve


def _state_unchanged(monkeypatch):
    from pocket_tts_tpu_torch.models import backbone
    orig = backbone.advance_lanes

    def advance_lanes(state, t, n_valid):
        return state if t == 1 else orig(state, t, n_valid)
    serve.patch_everywhere(orig, advance_lanes)
    return lambda: serve.unpatch([(backbone, "advance_lanes", orig)])


def _frame_fault(change):
    from pocket_tts_tpu_torch.models import tts
    orig = tts.frame_step_lanes

    def frame_step_lanes(p, cfg, state, *a, **k):
        out = orig(p, cfg, state, *a, **k)
        change(state)
        return out
    hits = serve.patch_everywhere(orig, frame_step_lanes)
    return lambda: serve.unpatch(hits)


def _half_the_lanes(state):
    b = state.prev_latent.shape[0]
    state.prev_latent = torch.cat([state.prev_latent[: b // 2]] * 2)


def _altered(state):
    state.prev_latent = state.prev_latent.clone()
    state.prev_latent[:, 0] += 0.5


@pytest.mark.parametrize("fault", ["state_unchanged", "half_the_lanes",
                                   "altered"])
def test_a_broken_path_is_not_correct(fault, monkeypatch):
    undo = (_state_unchanged(monkeypatch) if fault == "state_unchanged"
            else _frame_fault(_half_the_lanes if fault == "half_the_lanes"
                              else _altered))
    try:
        out, _ = run.run_cell(_tiny.cell(), _tiny.conf(), _tiny.mix(),
                              _tiny.bench(), 123, 6.0, False, False,
                              torch.device("cpu"), torch.float32)
    finally:
        undo()
    assert out["sampled"] > 0
    assert not out["correct"], out["checks"]
