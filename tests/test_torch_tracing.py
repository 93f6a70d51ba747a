"""The program's spans (utils/profiling.span) on the serving path, on one
random checkpoint at tiny_config (f32, CPU): off, nothing is recorded and
no profiler range opens; on, each ContinuousBatchingServer.step records
the tree ptt.step > {ptt.admit > {ptt.prefill, ptt.lane_write}, ptt.chunk
> ptt.frame x chunk_frames, ptt.read, ptt.bookkeep} with the request ids
that caused it; the admission stamp lies between submission and first
audio; the prefill's padding attributes are the power-of-two padding
`_prefill_many` applies; PCM is the same bit for bit with recording on
and off; a torch.profiler trace holds every span as a range."""
import dataclasses
import json
import threading

import numpy as np
import pytest
import torch

from pocket_tts_tpu_torch.config import tiny_config
from pocket_tts_tpu_torch.io.params import random_params, random_voice_prompt
from pocket_tts_tpu_torch.runtime.engine import TTSEngine
from pocket_tts_tpu_torch.runtime.server import (ContinuousBatchingServer,
                                                 MultiStreamServer)
from pocket_tts_tpu_torch.text.tokenizer import MockTokenizer
from pocket_tts_tpu_torch.utils import profiling

torch.set_num_threads(1)
CFG0 = dataclasses.replace(
    tiny_config(),
    backbone=dataclasses.replace(tiny_config().backbone, kv_capacity=256))
P, CFG = random_params(CFG0, seed=71)
VOICES = {"va": random_voice_prompt(CFG, 12, seed=1),
          "vb": random_voice_prompt(CFG, 16, seed=2)}
TEXTS = ["The first stream keeps the batch busy for a while.",
         "Joining mid decode.", "A third one, short.", "Four.",
         "And a fifth request joins late."]
CHUNK = 4
STEP_CHILDREN = ["ptt.admit", "ptt.chunk", "ptt.read", "ptt.bookkeep"]


def engine():
    return TTSEngine(params=P, cfg=CFG, seed=0, device="cpu",
                     tokenizer=MockTokenizer(CFG.lut.n_bins))


def server(ring=True, lanes=2):
    srv = ContinuousBatchingServer(engine(), lanes=lanes,
                                   chunk_frames=CHUNK, text_bucket=32,
                                   ring=ring)
    srv.register_voices(VOICES)
    return srv


def serve(srv):
    """Two requests at once, the rest mid-decode, until drained; returns
    the requests."""
    reqs = [srv.submit(t, "va" if i % 2 else "vb", temp=0.7, seed=10 + i)
            for i, t in enumerate(TEXTS[:2])]
    srv.step()
    reqs += [srv.submit(t, "va", temp=0.7, seed=20 + i)
             for i, t in enumerate(TEXTS[2:])]
    srv.run_pending()
    return reqs


def since(first):
    return [s for s in profiling.recorded_spans() if s.i >= first]


def next_index():
    with profiling.recording(), profiling.span("mark") as sp:
        pass
    return sp.i + 1


def run_recorded(ring=True):
    srv = server(ring)
    first = next_index()
    with profiling.recording():
        reqs = serve(srv)
    return srv, reqs, since(first)


@pytest.fixture(scope="module", params=[True, False], ids=["ring", "linear"])
def recorded(request):
    return run_recorded(request.param)


def children(spans, parent):
    return [s for s in spans if s.parent == parent.i]


def test_off_records_nothing_and_opens_no_range(monkeypatch):
    calls = []
    orig = torch.profiler.record_function

    def counted(*a, **k):
        calls.append(a)
        return orig(*a, **k)
    monkeypatch.setattr(torch.profiler, "record_function", counted)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", counted)
    assert not profiling.span("ptt.step", step=0)
    before = profiling.recorded_spans()
    srv = server()
    reqs = serve(srv)
    assert all(r.pcm is not None for r in reqs)
    after = profiling.recorded_spans()
    assert len(after) == len(before) and all(
        a is b for a, b in zip(after, before))
    assert calls == []


def test_each_step_records_the_span_tree(recorded):
    srv, reqs, spans = recorded
    steps = [s for s in spans if s.name == "ptt.step"]
    assert [s.attrs["step"] for s in steps] == list(range(srv.steps))
    assert all(s.parent is None for s in steps)
    admitted = 0
    for st in steps:
        kids = children(spans, st)
        assert [k.name for k in kids] == STEP_CHILDREN
        admit, chunk = kids[0], kids[1]
        sub = [k.name for k in children(spans, admit)]
        assert sub in ([], ["ptt.prefill", "ptt.lane_write"])
        admitted += bool(sub)
        frames = children(spans, chunk)
        assert [f.name for f in frames] == ["ptt.frame"] * CHUNK
        assert [f.attrs["i"] for f in frames] == list(range(CHUNK))
        assert chunk.attrs["frames"] == CHUNK
    assert admitted >= 2
    # every span closed, inside its parent, and nothing left unparented
    # but the steps
    by = {s.i: s for s in spans}
    for s in spans:
        assert s.end_ns is not None and s.start_ns <= s.end_ns
        if s.name == "ptt.step":
            continue
        p = by[s.parent]
        assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns
    # children in start order do not overlap
    for s in spans:
        kids = children(spans, s)
        assert all(a.end_ns <= b.start_ns for a, b in zip(kids, kids[1:]))


def test_span_ids_join_the_requests(recorded):
    srv, reqs, spans = recorded
    assert sorted(r.id for r in reqs) == list(range(len(reqs)))
    by_step = {s.attrs["step"]: s for s in spans if s.name == "ptt.step"}
    taken, done = {}, {}
    for st in by_step.values():
        admit, _, _, book = children(spans, st)
        for rid, lane in zip(admit.attrs.get("ids", []),
                             admit.attrs.get("lanes", [])):
            taken[rid] = (st.attrs["step"], lane)
        for rid in book.attrs["ids"]:
            done[rid] = st.attrs["step"]
    assert set(taken) == set(done) == {r.id for r in reqs}
    for r in reqs:
        assert taken[r.id][0] == r.admit_step <= done[r.id]
    lanes = {lane for _, lane in taken.values()}
    assert lanes <= set(range(srv.lanes))


def test_admission_lies_between_submission_and_first_audio(recorded):
    srv, reqs, _ = recorded
    for r in reqs:
        assert r.submitted_at <= r.admitted_at
        assert r.admitted_at <= r.submitted_at + r.ttfa_s
        assert r.queue_wait_s == r.admitted_at - r.submitted_at
    st = srv.stats()
    assert 0 <= st["p50_queue_wait_s"] <= st["p95_queue_wait_s"]


@pytest.mark.parametrize("n", [1, 2, 3, 5])
def test_prefill_attributes_are_its_padding(n):
    srv = server(lanes=8)
    reqs = [srv.submit(TEXTS[i % len(TEXTS)], "va") for i in range(n)]
    for r in reqs:
        srv._validate(r)
    first = next_index()
    with profiling.recording():
        fresh = srv._prefill_many(reqs)
    (sp,) = [s for s in since(first) if s.name == "ptt.prefill"]
    padded = 1 << (n - 1).bit_length()
    assert fresh.lanes == padded
    assert sp.attrs == {"lanes": n, "lanes_padded": padded,
                        "tokens": sum(len(r._prep[2]) for r in reqs),
                        "token_slots": padded * srv.text_bucket}


def test_pcm_is_bit_identical_with_recording_on_and_off(recorded):
    srv, reqs, _ = recorded
    plain = serve(server(srv.ring))
    for a, b in zip(reqs, plain):
        assert a.pcm.size and np.array_equal(a.pcm, b.pcm)


def test_profiler_trace_holds_every_span_in_order(tmp_path):
    srv = server()
    first = next_index()
    with profiling.device_trace(str(tmp_path), "cpu") as path:
        serve(srv)
    spans = [s for s in since(first) if s.name.startswith("ptt.")]
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    ranges = sorted((e for e in events if e.get("ph") == "X"
                     and str(e.get("name", "")).startswith("ptt.")
                     and e.get("cat") == "user_annotation"),
                    key=lambda e: (e["ts"], -e["dur"]))
    assert [e["name"] for e in ranges] == [s.name for s in spans]
    # the same nesting: each range lies inside its parent span's range
    at = {s.i: e for s, e in zip(spans, ranges)}
    for s in spans:
        if s.parent in at:
            p, e = at[s.parent], at[s.i]
            assert p["ts"] <= e["ts"]
            assert e["ts"] + e["dur"] <= p["ts"] + p["dur"]
    assert sum(s.name == "ptt.step" for s in spans) == srv.steps


def test_multistream_cohort_stamps_admission():
    srv = MultiStreamServer(engine(), max_batch=2, chunk_frames=CHUNK)
    srv.register_voices(VOICES)
    reqs = [srv.submit(t, "va", temp=0.0) for t in TEXTS[:3]]
    first = next_index()
    with profiling.recording():
        srv.run_pending()
    assert [r.id for r in reqs] == [0, 1, 2]
    assert reqs[0].admitted_at == reqs[1].admitted_at < reqs[2].admitted_at
    for r in reqs:
        assert r.submitted_at <= r.admitted_at <= r.submitted_at + r.ttfa_s
    frames = [s for s in since(first) if s.name == "ptt.frame"]
    assert frames and all(s.parent is None for s in frames)
    assert srv.stats()["p95_queue_wait_s"] >= 0


def test_span_nesting_exceptions_and_threads():
    first = next_index()
    with profiling.recording():
        with profiling.span("outer", k=1) as outer:
            with pytest.raises(ValueError):
                with profiling.span("inner"):
                    raise ValueError("x")
            outer.set(k=2, more=True)
            t = threading.Thread(target=lambda: profiling.span(
                "other").__enter__().__exit__(None, None, None))
            t.start()
            t.join()
        with profiling.recording():   # nests
            with profiling.span("after"):
                pass
        with profiling.span("last"):
            pass
    assert not profiling.span("off")
    spans = {s.name: s for s in since(first)}
    assert spans["inner"].parent == outer.i and spans["inner"].end_ns
    assert spans["outer"].attrs == {"k": 2, "more": True}
    assert spans["other"].parent is None   # its own thread's stack
    assert spans["after"].parent is None and spans["last"].parent is None
    assert [s.i for s in since(first)] == sorted(s.i for s in since(first))


def test_buffer_keeps_the_newest(monkeypatch):
    import collections
    monkeypatch.setattr(profiling, "_spans", collections.deque(maxlen=4))
    with profiling.recording():
        for i in range(10):
            with profiling.span("s", n=i):
                pass
    assert [s.attrs["n"] for s in profiling.recorded_spans()] == [6, 7, 8, 9]
