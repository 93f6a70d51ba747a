"""The model-family seam (`families/`): the Pocket TTS family gives the
result line that the harness gave when it called Pocket TTS's modules
itself; a second family written outside the harness runs a whole cell; an
unknown family fails where the cell is loaded, before anything is built.
Tiny sizes, on the CPU, the harness's look for a card skipped."""
import collections
import json
import re
import sys

import pytest
import torch

import _tiny
from ptts_bench import run, serve, trace, weights

CONTRACT = ["correct", "attempted", "failed", "metrics", "device"]
SEED = 2 ** 31 + 41


class Clock:
    """The harness's clock, moved 10 ms at each reading: a window of a
    fixed number of steps whatever the CPU's speed, and host-clock metrics
    that repeat exactly."""

    def __init__(self):
        self.t = 0.0

    def perf_counter(self):
        self.t += 0.01
        return self.t


@pytest.fixture
def fixed_clock(monkeypatch):
    monkeypatch.setattr(serve, "time", Clock())


# Recorded at commit 844cd37 (the harness calling Pocket TTS directly) with
# this module's clock, seed and tiny cell: the untraced runs with the
# control, the traced run without. Values on the host clock's readings
# are exact; the comparison's are float32 rounding on this CPU. The PCM's
# check is `pcm_vs_bf16`, which replaced the parent's `pcm_rel`, on a
# checkpoint whose last SEANet conv has no DC offset (`weights.py`): its
# values, the program's and the control's, and its limit are recorded
# anew; every other value is the parent's.
E2E = {"audio_frames_per_s": "frames/s", "ttfa_p95_ms": "ms",
       "chunk_gap_p95_ms": "ms", "setup_s": "s"}
PER_LAYER = {"lane_fill_pct": "%", "prefill_ms": "ms",
             "decode_chunk_ms": "ms", "prefill_pad_pct": "%",
             "host_read_ms": "ms", "server_host_ms": "ms",
             "frame_graph_pct": "%"}
UNTRACED_CLOCK = {"audio_frames_per_s": 626.4705882352937,
                  "ttfa_p95_ms": 20.000000000000018,
                  "chunk_gap_p95_ms": 30.00000000000003}
PARENT = {
    ("pocket-tts.int4-kv8", False): {
        "attempted": 9, "sampled": 8, "steps": [3, 37], "flops": 0.0,
        "units": E2E, "values": UNTRACED_CLOCK,
        "checks": {"latent_rel": (2.1541506704216438e-07, 1e-4),
                   "pcm_vs_bf16": (4.892872372051682e-05, 0.01),
                   "eos_miss": (0, 0)},
        "control": {"latent_rel": 0.13963055994935844,
                    "pcm_vs_bf16": 19.30045961089488, "eos_miss": 0}},
    ("pocket-tts.bf16", False): {
        "attempted": 9, "sampled": 8, "steps": [3, 37], "flops": 0.0,
        "units": E2E, "values": UNTRACED_CLOCK,
        "checks": {"latent_rel": (1.9285538982934205e-07, 1e-4),
                   "pcm_vs_bf16": (4.9024731462660546e-05, 0.01),
                   "eos_miss": (0, 0)},
        "control": {"latent_rel": 0.1424151404504671,
                    "pcm_vs_bf16": 22.417487723050254, "eos_miss": 0}},
    ("pocket-tts.int4-kv8", True): {
        "attempted": 4, "sampled": 6, "steps": [3, 23],
        "flops": 88228352.0, "units": PER_LAYER,
        "values": {"lane_fill_pct": 92.5, "prefill_ms": 10.000000000000009,
                   "decode_chunk_ms": 10.000000000000009,
                   "prefill_pad_pct": 85.9375, "frame_graph_pct": 0.0},
        "checks": {"latent_rel": (3.837596258618624e-07, 1e-4),
                   "pcm_vs_bf16": (4.892229967040579e-05, 0.01),
                   "eos_miss": (0, 0)},
        "ranges": {"batched::continuous_decode_chunk", "bench::client",
                   "bench::probe", "bench::step", "bench::window",
                   "kernel::k2", "kernel::k3", "kernel::k4b", "kernel::k7",
                   "ptt.admit", "ptt.bookkeep", "ptt.chunk", "ptt.frame",
                   "ptt.lane_write", "ptt.prefill", "ptt.read", "ptt.step",
                   "server::admit", "tts::frame"}},
}


@pytest.mark.parametrize("name,traced", list(PARENT))
def test_pocket_family_gives_the_parents_result_line(name, traced,
                                                     fixed_clock,
                                                     monkeypatch):
    from pocket_tts_tpu_torch.utils import profiling
    # only this run's spans feed the span readers
    monkeypatch.setattr(profiling, "_spans", collections.deque(
        maxlen=profiling.SPAN_BUFFER))
    ranges = set()
    reduce = trace.reduce

    def reduce_and_name(path):
        with open(path) as f:
            events = json.load(f)["traceEvents"]
        ranges.update(re.sub(r"#\d+$", "", e["name"]) for e in events
                      if e.get("cat") == "user_annotation")
        return reduce(path)
    monkeypatch.setattr(trace, "reduce", reduce_and_name)
    want = PARENT[(name, traced)]
    # a cell that reports every metric the parent's cells reported
    out, rec = run.run_cell(_tiny.cell("int4kv8.turns128"),
                            _tiny.conf(name), _tiny.mix(), _tiny.bench(),
                            SEED, 1.0, traced, not traced,
                            torch.device("cpu"), torch.float32)
    assert list(out)[:5] == CONTRACT and list(out)[-1] == "checks"
    assert out["correct"]
    assert (out["attempted"], out["sampled"]) == (want["attempted"],
                                                  want["sampled"])
    assert [rec.open_step, rec.close_step] == want["steps"]
    assert rec.flops_traced == want["flops"]
    assert {k: v["unit"] for k, v in out["metrics"].items()} == want["units"]
    for k, v in want["values"].items():
        assert out["metrics"][k]["value"] == pytest.approx(v, rel=1e-12), k
    assert set(out["checks"]) == set(want["checks"])
    for k, (v, limit) in want["checks"].items():
        assert out["checks"][k]["limit"] == limit
        assert out["checks"][k]["value"] == pytest.approx(v, rel=1e-6), k
    if traced:
        assert ranges == want["ranges"]
    else:
        assert out["control"] == pytest.approx(want["control"], rel=1e-6)
        assert out["control_fails"]


# A second family: an echo server whose requests each ask for `frames`
# frames of one value; its judge counts sampled streams that came back
# with another value or length.
STUB = '''
import numpy as np

from ptts_bench import serve

TIMED = {}
PHASES = {}


def frame_size(conf):
    return conf["frame"]


class Request:
    def __init__(self, value, frames):
        self.value, self.frames, self.out = value, frames, 0
        self.admit_step = self.first_audio_step = self.pcm = None
        self.submitted_at = serve.time.perf_counter()


class Server:
    def __init__(self, lanes, chunk, frame):
        self.chunk, self.frame = chunk, frame
        self.steps, self.completed = 0, []
        self._live, self._queue = [None] * lanes, []
        self.on_chunk = lambda: None

    def submit(self, value, frames):
        self._queue.append(Request(value, frames))
        return self._queue[-1]

    def _admit(self):
        for i, r in enumerate(self._live):
            if r is None and self._queue:
                r = self._live[i] = self._queue.pop(0)
                r.admit_step, r.first_audio_step = self.steps, self.steps + 1

    def step(self):
        self._admit()
        self.on_chunk()
        emitted = 0
        for i, r in enumerate(self._live):
            if r is None:
                continue
            n = min(self.chunk, r.frames - r.out)
            r.out += n
            emitted += n
            if r.out == r.frames:
                r.pcm = np.full(r.frames * self.frame, r.value, np.float32)
                self.completed.append(r)
                self._live[i] = None
        self.steps += 1
        return emitted


def build(conf, mix, seed, device, dtype):
    return Server(mix["lanes"], mix["chunk_frames"], conf["frame"])


class Planned:
    def __init__(self, value, frames):
        self.value, self.frames, self.due_s = value, frames, 0.0


def plan(mix, seed):
    rng = np.random.default_rng(seed)
    return [Planned(float(v), mix["frames"])
            for v in rng.integers(1, 100, mix["pool"])]


def submit(srv, p):
    return srv.submit(p.value, p.frames)


def warm(srv, mix, planned):
    pass


class Capture:
    def __init__(self, srv, chunk_frames):
        self.lanes, self.annotate = {}, False
        srv.on_chunk = lambda: self.lanes.__setitem__(srv.steps,
                                                      list(srv._live))

    def close(self):
        pass


def model_flops(run, cap, conf, mix):
    return 0.0


def sample(run, cap, mix, seed):
    return [s for s in run.sent if s.done_step is not None
            and run.open_step < s.done_step <= run.close_step][:mix["sample"]]


def judge(conf, mix, cases, seed, device, control=False):
    wrong = sum(not (s.req.pcm.size == s.plan.frames * conf["frame"]
                     and (s.req.pcm == s.plan.value).all()) for s in cases)
    return {"checks": {"wrong": (wrong, 0)}, "sampled": len(cases),
            "rows": [], "correct": bool(cases) and wrong == 0}
'''


def _bench_dir(tmp_path, family: str, source: str = None):
    """A benchmark's root in tmp_path: BENCHMARK.json naming one cell of a
    configuration of `family`, its mix, and the family's file."""
    root = tmp_path / "bench"
    for d in ("configs", "traffic", "families"):
        (root / d).mkdir(parents=True)
    real = _tiny.bench()
    bench = {"configs": [{"name": "stub", "file": "bench/configs/stub.json",
                          "reduced": []}],
             "workloads": [{"name": "stub.echo", "config": "stub",
                            "traffic": "echo", "chips": 1}],
             "end_to_end": [dict(m, workloads=["stub.echo"])
                            for m in real["end_to_end"]],
             "per_layer": [m for m in real["per_layer"]
                           if m["name"] in ("lane_fill_pct",
                                            "device_idle_pct")]}
    for m in bench["per_layer"]:
        m["workloads"] = ["stub.echo"]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    (root / "configs" / "stub.json").write_text(json.dumps(
        {"family": family, "frame": 4}))
    (root / "traffic" / "echo.json").write_text(json.dumps(
        {"lanes": 3, "chunk_frames": 2, "capacity": 8, "frames": 5,
         "pool": 200, "sample": 4, "trace_chunks": 2,
         "arrivals": {"kind": "closed", "sessions": 3, "ramp_chunks": 2,
                      "think_chunks": 1}}))
    if source is not None:
        (root / "families" / f"{family}.py").write_text(source)
    return root


@pytest.mark.parametrize("traced", [False, True])
def test_a_second_family_runs_from_its_own_files(traced, tmp_path,
                                                 fixed_clock):
    root = _bench_dir(tmp_path, "stub", STUB)
    cell, conf, mix, bench = serve.load_cell("stub.echo", root)
    out, rec = run.run_cell(cell, conf, mix, bench, SEED, 0.5, traced,
                            False, torch.device("cpu"), torch.float32,
                            root=root)
    assert sys.modules["ptts_bench.families.stub"].__file__ == str(
        root / "families" / "stub.py")
    assert list(out)[:5] == CONTRACT and list(out)[-1] == "checks"
    assert out["correct"] and out["sampled"] == 4
    assert out["checks"] == {"wrong": {"value": 0, "limit": 0}}
    if traced:
        # the device reads nothing on the CPU
        assert set(out["metrics"]) == {"lane_fill_pct"}
        assert out["breakdown"]["idle_gaps"]
    else:
        assert set(out["metrics"]) == set(E2E)
        assert out["metrics"]["audio_frames_per_s"]["value"] > 0


def test_an_unknown_family_fails_before_anything_is_built(tmp_path,
                                                          monkeypatch):
    built = []
    monkeypatch.setattr(weights, "checkpoint",
                        lambda *a, **k: built.append(a))
    root = _bench_dir(tmp_path, "no_such_family")
    with pytest.raises(SystemExit) as err:
        serve.load_cell("stub.echo", root)
    assert str(root / "families" / "no_such_family.py") in str(err.value)
    conf = json.loads((root / "configs" / "stub.json").read_text())
    with pytest.raises(SystemExit):
        run.run_cell(_tiny.cell(), conf, _tiny.mix(), _tiny.bench(), SEED,
                     1.0, False, False, torch.device("cpu"), torch.float32,
                     root=root)
    assert not built
