"""On the card: each cell at its own size and load, a short window, with
the control computed on the same sample. The program's numbers stay within
the limits and the control's (the reference one precision step down in
the program's place) do not. Run on the chip with
`python -m pytest ptts_bench/tests -m card`."""
import pytest
import torch

from ptts_bench import run, serve


@pytest.mark.card
@pytest.mark.parametrize("workload", ["int4kv8.sessions256",
                                      "bf16.sessions256"])
def test_control_fails_where_the_program_passes(workload, card):
    cell, conf, mix, bench = serve.load_cell(workload)
    serve.set_cache_env()
    out, _ = run.run_cell(cell, conf, mix, bench, 2 ** 31 + 11, 8.0, False,
                          True, card, torch.bfloat16)
    assert out["correct"], out["checks"]
    assert out["control_fails"], out["control"]
