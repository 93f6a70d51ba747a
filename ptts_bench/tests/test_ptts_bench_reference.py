"""The plain reference against the port's CPU path on tiny random weights:
whole runs of the harness at tiny sizes, in float32 on both sides, where
the two must agree to rounding."""
import pytest
import torch

import _tiny
from ptts_bench import reference, run


@pytest.mark.parametrize("name", ["pocket-tts.int4-kv8", "pocket-tts.bf16"])
def test_reference_agrees_with_the_port_on_the_cpu(name):
    out, rec = run.run_cell(_tiny.cell(), _tiny.conf(name), _tiny.mix(),
                            _tiny.bench(), 2 ** 31 + 3, 6.0, False, True,
                            torch.device("cpu"), torch.float32)
    assert out["correct"] and out["sampled"] >= 3
    # relative errors to float32 rounding; the PCM's distance, in units of
    # bfloat16's, to float32 rounding in those units
    most = {"latent_rel": 1e-5, "pcm_vs_bf16": 1e-3, "eos_miss": 0}
    assert set(out["checks"]) == set(most)
    for name_, c in out["checks"].items():
        assert c["value"] <= most[name_], name_
    # the control, one precision step down, reads far above the port
    assert out["control"]["latent_rel"] > 100 * max(
        out["checks"]["latent_rel"]["value"], 1e-7)
    assert out["control"]["pcm_vs_bf16"] > 100 * max(
        out["checks"]["pcm_vs_bf16"]["value"], 1e-3)


def test_int4_channels_match_the_rule():
    w = torch.randn(5, 8)
    q = reference.int4_channels(w)
    scale = w.abs().amax(-1, keepdim=True) / 7
    ints = q / scale
    assert torch.allclose(ints, ints.round(), atol=1e-4)
    assert ints.abs().max() <= 7 + 1e-4


def test_prepare_text():
    assert reference.prepare_text("hi there") == ("        Hi there.", 5,
                                                  50)
    assert reference.prepare_text("one two three four five six")[1:] == (
        3, 100)
