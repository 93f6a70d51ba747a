"""Which metrics each cell reports (BENCHMARK.json): every per-layer metric
moves an end-to-end metric that each of its cells reports; every cell
reports `setup_s`, another end-to-end metric and a per-layer metric; every
metric has its reader. The `.frames` metrics carry their namesakes'
readings as per-layer metrics in the cells that hold no end-to-end tail:
the same reader, unit, source and layer, and on one run the same value."""
import json

import pytest
import torch

import _tiny
from ptts_bench import run

BENCH = _tiny.bench()
CELLS = [w["name"] for w in BENCH["workloads"]]
FRAMES = [m["name"] for m in BENCH["per_layer"]
          if m["name"].endswith(".frames")]


def cells_of(metric: dict) -> list:
    return metric.get("workloads", CELLS)


def end_to_end_of(cell: str) -> set:
    return {m["name"] for m in BENCH["end_to_end"] if cell in cells_of(m)}


@pytest.mark.parametrize("metric", BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_a_per_layer_metric_moves_what_each_of_its_cells_reports(metric):
    assert set(cells_of(metric)) <= set(CELLS)
    for cell in cells_of(metric):
        assert metric["moves"] in end_to_end_of(cell), cell


@pytest.mark.parametrize("cell", CELLS)
def test_a_cell_reports_setup_another_end_to_end_and_a_per_layer_metric(
        cell):
    e2e = end_to_end_of(cell)
    assert "setup_s" in e2e and len(e2e) >= 2
    assert any(cell in cells_of(m) for m in BENCH["per_layer"])


@pytest.mark.parametrize("name", [m["name"] for m in BENCH["end_to_end"]
                                  + BENCH["per_layer"]])
def test_a_metric_has_its_reader(name):
    assert callable(run.load_reader("metrics", name).read)


@pytest.mark.parametrize("name", FRAMES)
def test_a_frames_metric_is_its_namesake_where_the_namesake_is_not(name):
    base = name[:-len(".frames")]
    entries = {m["name"]: m for m in BENCH["per_layer"]
               + BENCH["end_to_end"]}
    mine, theirs = entries[name], entries[base]
    for key in ("unit", "better", "source"):
        assert mine[key] == theirs[key], key
    assert mine["moves"] == "audio_frames_per_s"
    assert not set(cells_of(mine)) & set(cells_of(theirs))
    read = run.load_reader("metrics", name).read
    assert (read.__module__, read.__name__) == (
        f"ptts_bench.metrics.{base}", "read")


@pytest.fixture(scope="module")
def traced_sessions_run():
    """A tiny traced run as the `int4kv8.sessions256` cell: enough traced
    chunks that a lane finishes and one is admitted."""
    mix = dict(_tiny.mix(), trace_chunks=12)
    return run.run_cell(_tiny.cell("int4kv8.sessions256"), _tiny.conf(),
                        mix, BENCH, 2 ** 31 + 5, 2.0, True, False,
                        torch.device("cpu"), torch.float32)


def test_a_sessions_cell_reads_the_frames_metrics_as_their_namesakes(
        traced_sessions_run):
    out, rec = traced_sessions_run
    assert out["correct"], out["checks"]
    line = json.loads(json.dumps(out))
    for name in FRAMES:
        base = name[:-len(".frames")]
        assert base not in line["metrics"]
        got = line["metrics"][name]["value"]
        assert isinstance(got, float)
        assert got == run.load_reader("metrics", base).read(rec), name


def test_a_sessions_cell_holds_frames_per_second_and_set_up_time_alone():
    out, _ = run.run_cell(_tiny.cell("int4kv8.sessions256"), _tiny.conf(),
                          _tiny.mix(), BENCH, 2 ** 31 + 6, 1.0, False,
                          False, torch.device("cpu"), torch.float32)
    assert set(out["metrics"]) == {"audio_frames_per_s", "setup_s"}
