"""The readers of the program's spans and admission stamps: the tiny
cell's traced run on the CPU reads each as a number; each reads nothing
(None, no error) from a program that records no spans or stamps no
admission; the `turns128` mix plans 1-4-word turns whose tokens fit the
text bucket."""
import math
from collections import Counter
from types import SimpleNamespace

import pytest
import torch

import _tiny
from ptts_bench import run, serve, traffic

NEW = ("queue_wait_p95_ms", "prefill_pad_pct", "host_read_ms",
       "server_host_ms")


def test_tiny_traced_run_reads_each_metric():
    # enough traced chunks that a lane finishes and one is admitted
    mix = dict(_tiny.mix(), trace_chunks=12)
    out, rec = run.run_cell(_tiny.cell(), _tiny.conf(), mix,
                            _tiny.bench(), 2 ** 31 + 5, 2.0, True, False,
                            torch.device("cpu"), torch.float32)
    assert out["correct"], out["checks"]
    got = {m: run.load_reader("metrics", m).read(rec) for m in NEW}
    assert all(isinstance(v, float) and math.isfinite(v)
               for v in got.values()), got
    assert 0 <= got["queue_wait_p95_ms"]
    assert 0 < got["prefill_pad_pct"] < 100
    assert got["host_read_ms"] > 0 and got["server_host_ms"] > 0


@pytest.mark.parametrize("program", ["no spans", "no recorder"])
def test_readers_read_nothing_from_a_program_without_spans(program,
                                                           monkeypatch):
    from pocket_tts_tpu_torch.utils import profiling
    if program == "no spans":
        monkeypatch.setattr(profiling, "recorded_spans", lambda: [])
    else:
        monkeypatch.delattr(profiling, "recorded_spans")
    rec = serve.Run(t0=0.0, t_open=1.0, t_close=2.0)
    rec.notes["traced_steps"] = (0, 10)
    # a request as the parent's server makes it: no admission stamp
    rec.sent.append(SimpleNamespace(req=SimpleNamespace(submitted_at=1.5)))
    for m in NEW:
        assert run.load_reader("metrics", m).read(rec) is None, m


def test_turns128_plans_short_turns_that_fit_the_bucket():
    mix = traffic.load("turns128", _tiny.ROOT)
    assert mix["lanes"] == mix["arrivals"]["sessions"] == 128
    plan = traffic.plan(mix, 2 ** 31 + 17)
    words = Counter(p.words for p in plan)
    assert set(words) == {1, 2, 3, 4} and words.most_common(1)[0][0] == 2
    tok = traffic.WordTokenizer(4000)
    from pocket_tts_tpu_torch.text.preprocess import prepare_text_prompt
    for p in plan:
        text, _ = prepare_text_prompt(p.text)
        assert 1 <= len(tok.encode(text)) <= mix["text_bucket"]
    # requests of 37-75 frames: 8-15 chunks of 5
    frames = {int((w + 2) * 12.5) for w in words}
    assert min(frames) == 37 and max(frames) == 75


def test_new_cell_and_metrics_are_declared():
    bench = _tiny.bench()
    cells = {w["name"]: w for w in bench["workloads"]}
    assert cells["int4kv8.turns128"]["traffic"] == "turns128"
    per_layer = {m["name"]: m for m in bench["per_layer"]}
    # each is read in every cell: under its name, or as its `.frames`
    # namesake where the cell holds no end-to-end tail
    for m in NEW:
        frames = per_layer.get(f"{m}.frames", {}).get("workloads", [])
        assert set(per_layer[m]["workloads"]) | set(frames) == set(cells)
        assert (_tiny.ROOT / "metrics" / f"{m}.py").is_file()
