"""The lane frame step from CUDA graphs (models/frame_graph.py), on the CPU.

The graphs here are a stand-in for `torch.cuda.CUDAGraph` (`ReplayGraph`):
a segment records its aten ops while the capture runs them, and each
replay runs them again on the recorded tensors, writing every result back
into the tensor the capture made, so that tensors keep their storage as a
graph's do; a host read inside a segment raises, as it cannot happen
inside a capture on the card. With it the tests check:

- the batch's cursors on the device: the served latents and PCM equal
  the host-int path's bit for bit, over backbone and Mimi ring wraps,
  with requests admitted mid-run, int8 KV and bf16 KV, and agree with
  the JAX package's server;
- the same with the frame captured once and replayed after it;
- the runner: segments between the kernels' entries, the replay order,
  the entries called through their module attribute, host steps,
  re-capture on another key, counters, a failed capture;
- the `frame_graph_pct` reader of the benchmark.
"""
import dataclasses
import sys

import numpy as np
import jax
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from pocket_tts_tpu.config import tiny_config
from pocket_tts_tpu.io.params import params_from_flat, random_flat
from pocket_tts_tpu.runtime.engine import TTSEngine as JEngine
from pocket_tts_tpu.runtime.server import ContinuousBatchingServer as JCBS
from pocket_tts_tpu_torch.io.params import (from_jax_numpy,
                                            params_from_flat as
                                            tparams_from_flat,
                                            random_voice_prompt)
from pocket_tts_tpu_torch.models import frame_graph, tts
from pocket_tts_tpu_torch.ops import cuda_lib
from pocket_tts_tpu_torch.runtime import server as tserver
from pocket_tts_tpu_torch.runtime.engine import TTSEngine
from pocket_tts_tpu_torch.runtime.server import ContinuousBatchingServer
from pocket_tts_tpu_torch.text.tokenizer import MockTokenizer
from pocket_tts_tpu_torch.utils import profiling

torch.set_num_threads(1)
KV8_REL = 1e-3
REL = 1e-4
CFG0 = tiny_config(64)
CFG0 = dataclasses.replace(CFG0, backbone=dataclasses.replace(
    CFG0.backbone, kv_capacity=128))
PJ, CFG = params_from_flat(random_flat(CFG0, seed=13, scale=0.05), CFG0)
PT = from_jax_numpy(jax.tree.map(np.asarray, PJ))
PT16, _ = tparams_from_flat(random_flat(CFG0, seed=13, scale=0.05), CFG0,
                            dtype=torch.bfloat16, device="cpu")
VOICES = {"va": random_voice_prompt(CFG, 12, seed=1),
          "vb": random_voice_prompt(CFG, 16, seed=2)}
# one-word turns (37 frames, 45 with the margin) through two lanes: the
# 64-slot backbone ring wraps, the 48-slot Mimi ring every 3 frames
TEXTS = ["Hello.", "Again.", "Three.", "Four.", "Five."]


# ---------------------------------------------------------------------------
# the stand-in graph
# ---------------------------------------------------------------------------

class _Recorder(TorchDispatchMode):
    """Records a segment's ops. Ops on host values alone (tensors made from
    Python numbers, and what is computed from them: the constants a frame
    computes on the host) are left out, as a capture on the card leaves
    out CPU work; a read of any other tensor's value raises."""

    READS = (torch.ops.aten._local_scalar_dense.default,
             torch.ops.aten.is_nonzero.default)

    def __init__(self, ops):
        super().__init__()
        self.ops = ops
        self.host = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        tensors = [t for t in tree_flatten((args, kwargs))[0]
                   if isinstance(t, torch.Tensor)]
        on_host = (func is torch.ops.aten.lift_fresh.default
                   or (tensors and all(id(t) in self.host
                                       for t in tensors)))
        if func in self.READS and not on_host:
            raise RuntimeError(f"{func} of a device value inside a "
                               "captured segment")
        out = func(*args, **kwargs)
        if on_host:
            for t in tree_flatten(out)[0]:
                if isinstance(t, torch.Tensor):
                    self.host[id(t)] = t
        else:
            self.ops.append((func, args, kwargs, out))
        return out


def _storages(tree):
    return {t.untyped_storage().data_ptr() for t in tree_flatten(tree)[0]
            if isinstance(t, torch.Tensor)}


class ReplayGraph:
    """torch.cuda.CUDAGraph's capture interface on the CPU. The capture
    runs the ops (a graph's capture runs none and the runner's first
    replay runs them: that first replay is skipped here instead)."""

    def __init__(self):
        self.ops, self.mode, self.fresh = [], None, False
        self.resets = 0

    def capture_begin(self, pool=None, capture_error_mode="global"):
        self.mode = _Recorder(self.ops)
        self.mode.__enter__()

    def capture_end(self):
        self.mode.__exit__(None, None, None)
        self.mode, self.fresh = None, True

    def replay(self):
        if self.fresh:
            self.fresh = False
            return
        for func, args, kwargs, out in self.ops:
            new = func(*args, **kwargs)
            inputs = _storages((args, kwargs))
            for o, n in zip(tree_flatten(out)[0], tree_flatten(new)[0]):
                if (isinstance(o, torch.Tensor)
                        and o.untyped_storage().data_ptr() not in inputs):
                    o.copy_(n)

    def reset(self):
        self.ops = []
        self.resets += 1


# ---------------------------------------------------------------------------
# served audio: host cursors, device cursors, graphs, JAX
# ---------------------------------------------------------------------------

def _engine(kind: str):
    tok = MockTokenizer(CFG.lut.n_bins)
    if kind == "int8-kv":
        return TTSEngine(params=PT, cfg=CFG, seed=0, quantize="int4",
                         quantize_kv=True, device="cpu", tokenizer=tok)
    if kind == "bf16-kv":
        return TTSEngine(params=PT16, cfg=CFG, seed=0, dtype=torch.bfloat16,
                         device="cpu", tokenizer=tok)
    return TTSEngine(params=PT, cfg=CFG, seed=0, device="cpu", tokenizer=tok)


def _serve(kind: str, path: str, monkeypatch, temp=0.6):
    """Serve TEXTS through two lanes, two at first and the rest joining
    mid-run, on the engine of `kind` ("int8-kv": int4 weights, int8 KV,
    shared prefix; "bf16-kv" or "f32-kv": float weights and KV); path
    "host" (cursors as host ints), "device" (kept on the device too) or
    "graphs" (frames replayed from ReplayGraph segments). Returns
    (requests, every frame's latents, the server)."""
    made = tserver.empty_batch_state

    def batch(*a, **k):
        st = made(*a, **k)
        if path == "device":
            frame_graph.attach_cursors(st)
        elif path == "graphs":
            st.graphs = frame_graph.FrameGraphs(graph=ReplayGraph)
        return st

    monkeypatch.setattr(tserver, "empty_batch_state", batch)
    latents = []
    step = tts.frame_step_lanes

    def frame(p, cfg, state, *a, **k):
        out = step(p, cfg, state, *a, **k)
        latents.append(state.prev_latent.clone())
        return out

    monkeypatch.setattr(tts, "frame_step_lanes", frame)
    eng = _engine(kind)
    srv = ContinuousBatchingServer(eng, lanes=2, chunk_frames=4,
                                   text_bucket=32,
                                   share_prefix=kind == "int8-kv")
    srv.register_voices({k: np.asarray(v) for k, v in VOICES.items()})
    reqs = [srv.submit(t, "va" if i % 2 else "vb", temp=temp, seed=100 + i)
            for i, t in enumerate(TEXTS[:2])]
    srv.step()
    reqs += [srv.submit(t, "va", temp=temp, seed=100 + i)
             for i, t in enumerate(TEXTS[2:], 2)]
    srv.run_pending()
    monkeypatch.undo()
    return reqs, torch.stack(latents), srv


@pytest.mark.parametrize("kind", ["int8-kv", "bf16-kv"])
def test_device_cursors_and_graphs_equal_the_host_path(kind, monkeypatch):
    host_reqs, host_lat, host_srv = _serve(kind, "host", monkeypatch)
    # the rings wrapped: 5 requests of 37+ frames through a 64-slot
    # backbone ring and a 48-slot Mimi ring (16 rows a frame)
    ring = host_srv.capacity - host_srv.prefix_slots
    assert ring == 64
    assert host_srv.steps * 4 > ring
    assert host_srv.batch.mimi.transformer.offset > 3 * 48
    assert all(r.admit_step > 0 for r in host_reqs[2:])
    for path in ("device", "graphs"):
        captures = frame_graph.run_frame.captures
        replays = frame_graph.run_frame.replays
        reqs, lat, srv = _serve(kind, path, monkeypatch)
        assert torch.equal(lat, host_lat), path
        for a, b in zip(reqs, host_reqs):
            assert a.pcm.size > 0 and np.array_equal(a.pcm, b.pcm), path
            assert a.admit_step == b.admit_step
        flow, tr = srv.batch.flow, srv.batch.mimi.transformer
        hf, ht = host_srv.batch.flow, host_srv.batch.mimi.transformer
        # the host mirrors moved as the host path's cursors, and the
        # device copies with them
        assert (flow.end, tr.offset) == (hf.end, ht.offset)
        assert flow.end_dev.tolist() == [flow.end]
        assert tr.offset_dev.tolist() == [tr.offset]
        assert hf.end_dev is None and ht.offset_dev is None
        # one capture, then every frame a replay
        graphed = path == "graphs"
        assert frame_graph.run_frame.captures - captures == int(graphed)
        assert (frame_graph.run_frame.replays - replays
                == (len(lat) - 1 if graphed else 0))


def _jax_serve(kind):
    jeng = JEngine(params=PJ, cfg=CFG, seed=0,
                   quantize="int4" if kind == "int8-kv" else None,
                   quantize_kv=kind == "int8-kv",
                   tokenizer=MockTokenizer(CFG.lut.n_bins))
    srv = JCBS(jeng, lanes=2, chunk_frames=4, text_bucket=32,
               share_prefix=kind == "int8-kv")
    srv.register_voices({k: np.asarray(v) for k, v in VOICES.items()})
    reqs = [srv.submit(t, "va" if i % 2 else "vb", temp=0.0)
            for i, t in enumerate(TEXTS[:2])]
    srv.step()
    reqs += [srv.submit(t, "va", temp=0.0) for t in TEXTS[2:]]
    srv.run_pending()
    return reqs


@pytest.mark.parametrize("kind,rel", [("int8-kv", KV8_REL),
                                      ("f32-kv", REL)])
def test_graphed_serving_agrees_with_jax(kind, rel, monkeypatch):
    reqs, _, _ = _serve(kind, "graphs", monkeypatch, temp=0.0)
    for rt, rj in zip(reqs, _jax_serve(kind)):
        want = np.asarray(rj.pcm)
        assert rt.pcm.shape == want.shape and want.size > 0
        scale = np.abs(want).max()
        np.testing.assert_allclose(rt.pcm / scale, want / scale, atol=rel,
                                   rtol=0)
        assert rt.admit_step == rj.admit_step


# ---------------------------------------------------------------------------
# the runner
# ---------------------------------------------------------------------------

@cuda_lib.entry
def scale_kernel(x, scale: float, out=None):
    """A hand-written kernel's entry, as the runner sees one: y = x *
    scale."""
    return cuda_lib.into(out, x * scale)


def _toy_body(host_log, acc):
    """glue | entry | glue | entry | a host step, glue in place."""
    def body(x, y):
        a = x + 1
        b = scale_kernel(a, 2.0)
        c = b * y
        d = scale_kernel(c, 3.0)
        frame_graph.host(lambda: host_log.append(len(host_log)))
        acc.add_(d.sum())
        return d - 1, c
    return body


def _toy_eager(x, y):
    c = (x + 1) * 2.0 * y
    return c * 3.0 - 1, c


def test_runner_segments_replays_in_order_and_calls_entries(monkeypatch):
    host_log, acc = [], torch.zeros(())
    g = frame_graph.FrameGraphs(graph=ReplayGraph)
    x, y = torch.arange(4.0), torch.full((4,), 0.5)
    out, mode = g.run(_toy_body(host_log, acc), "k", (x, y))
    assert mode == "capture" and g.segments == 3
    assert [it[0] for it in g.items] == [
        frame_graph.GRAPH, frame_graph.ENTRY, frame_graph.GRAPH,
        frame_graph.ENTRY, frame_graph.HOST, frame_graph.GRAPH]
    for got, want in zip(out, _toy_eager(x, y)):
        assert torch.equal(got, want)
    assert host_log == [0] and cuda_lib._entry_hook is None
    # replays: the entries through their module attribute, into the
    # result of the capture; new inputs copied into the capture's
    calls, kernel = [], scale_kernel

    def spy(*a, **k):
        calls.append(k["out"])
        return kernel(*a, **k)

    monkeypatch.setattr(sys.modules[__name__], "scale_kernel", spy)
    entries = [it for it in g.items if it[0] == frame_graph.ENTRY]
    total = float(acc)
    for i in range(3):
        x2, y2 = torch.randn(4), torch.randn(4)
        out, mode = g.run(None, "k", (x2, y2))
        assert mode == "replay"
        want = _toy_eager(x2, y2)
        for got, w in zip(out, want):
            torch.testing.assert_close(got, w, rtol=0, atol=1e-6)
        total += float(want[0].sum() + 1 * 4)
        torch.testing.assert_close(float(acc), total, rtol=1e-6, atol=1e-5)
        # the returned tensors are the caller's: the next replay keeps them
        assert out[0].data_ptr() != g.outputs[0].data_ptr()
    assert host_log == [0, 1, 2, 3]
    assert len(calls) == 6
    assert all(c is e[4]["out"] for c, e in zip(calls, entries * 3))
    # the capture kept the caller's first inputs and copies new ones in
    assert g.inputs[0] is x and torch.equal(x, x2)


def test_runner_captures_again_on_another_key_and_frees_the_old():
    host_log, acc = [], torch.zeros(())
    g = frame_graph.FrameGraphs(graph=ReplayGraph)
    body = _toy_body(host_log, acc)
    x, y = torch.ones(3), torch.ones(3)
    g.run(body, ("a",), (x, y))
    old = [it[1] for it in g.items if it[0] == frame_graph.GRAPH]
    assert g.run(body, ("a",), (x, y))[1] == "replay"
    assert g.run(body, ("b",), (x, y))[1] == "capture"
    assert all(o.resets == 1 for o in old) and g.key == ("b",)
    g.reset()
    assert g.items == [] and g.key is None and g.segments == 0


def test_a_failed_capture_leaves_nothing_behind():
    g = frame_graph.FrameGraphs(graph=ReplayGraph)

    def body(x):
        scale_kernel(x + 1, 2.0)
        raise RuntimeError("boom")

    with pytest.raises(RuntimeError, match="boom"):
        g.run(body, 1, (torch.ones(2),))
    assert g.key is None and g.items == []
    assert cuda_lib._entry_hook is None and frame_graph._capturing is None


def test_a_host_read_inside_a_segment_raises():
    g = frame_graph.FrameGraphs(graph=ReplayGraph)

    def body(x):
        if bool((x > 0).all()):
            return (x,)
        return (-x,)

    with pytest.raises(RuntimeError, match="captured segment"):
        g.run(body, 1, (torch.ones(2),))


def test_graphable_needs_cuda_ring_and_no_mesh():
    from types import SimpleNamespace as NS
    st = tserver.empty_batch_state(PT, CFG, 2, 96, 32, ring=True)
    assert not frame_graph.graphable(CFG, st)      # the CPU

    def batch(device, ring_start):
        return NS(step=NS(device=torch.device(device)),
                  flow=NS(ring_start=ring_start))

    assert frame_graph.graphable(CFG, batch("cuda", 32))
    assert not frame_graph.graphable(CFG, batch("cuda", None))  # linear
    assert not frame_graph.graphable(
        dataclasses.replace(CFG, on_mesh=True), batch("cuda", 32))


# ---------------------------------------------------------------------------
# the ptt.frame span's attribute and the benchmark's reader
# ---------------------------------------------------------------------------

def _frame_graph_pct(t_close):
    from types import SimpleNamespace
    from ptts_bench.metrics import frame_graph_pct
    return frame_graph_pct.read(SimpleNamespace(
        notes={"traced_steps": (0, 10 ** 6)}, t_close=t_close))


@pytest.mark.parametrize("path", ["host", "graphs"])
def test_frame_spans_say_how_the_frame_ran(path, monkeypatch):
    import time
    t = time.perf_counter()
    with profiling.recording():
        _serve("int8-kv", path, monkeypatch)
    spans = [s for s in profiling.recorded_spans()
             if s.name == "ptt.frame" and s.start_ns * 1e-9 > t]
    modes = [s.attrs["graph"] for s in spans]
    if path == "host":
        assert set(modes) == {"eager"} and _frame_graph_pct(t) == 0.0
    else:
        assert modes[0] == "capture" and set(modes[1:]) == {"replay"}
        assert _frame_graph_pct(t) == pytest.approx(
            100.0 * (len(modes) - 1) / len(modes))


def test_frame_graph_pct_reads_nothing_without_the_attribute():
    import time
    t = time.perf_counter()
    with profiling.recording():
        with profiling.span("ptt.step", step=0):
            for i in range(3):
                with profiling.span("ptt.frame", i=i):
                    pass
    assert _frame_graph_pct(t) is None
