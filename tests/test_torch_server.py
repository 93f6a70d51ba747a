"""The port's servers on one random checkpoint at tiny_config (f32):
continuous batching against the port's solo engine (atol 2e-5, the JAX
package's test_continuous.py tolerance) in ring mode, across a ring wrap
and through eager compaction; the same requests through the JAX
package's ContinuousBatchingServer and MultiStreamServer at temp 0 (atol
1e-4, the port's end-to-end tolerance); seeded noise at temp 0.7
independent of admission order; the serving options (what is refused,
quantized convs, quantized weights on a mesh); CLI --serve; and the lane
scheduler's seam (runtime/lanes.py) under a minimal stand-in model."""
import dataclasses
import json
import os
from types import SimpleNamespace

import numpy as np
import jax
import pytest
import torch

from pocket_tts_tpu.config import tiny_config
from pocket_tts_tpu.io.params import params_from_flat, random_flat
from pocket_tts_tpu.runtime.engine import TTSEngine as JEngine
from pocket_tts_tpu.runtime.server import (
    ContinuousBatchingServer as JCBS, MultiStreamServer as JMSS)
from pocket_tts_tpu_torch.io.params import from_jax_numpy, random_voice_prompt
from pocket_tts_tpu_torch.runtime.engine import TTSEngine
from pocket_tts_tpu_torch.runtime.lanes import Job, LaneScheduler
from pocket_tts_tpu_torch.runtime.server import (ContinuousBatchingServer,
                                                 MultiStreamServer)
from pocket_tts_tpu_torch.text.preprocess import prepare_text_prompt
from pocket_tts_tpu_torch.text.tokenizer import MockTokenizer

torch.set_num_threads(1)
SOLO_ATOL = 2e-5
JAX_ATOL = 1e-4
CFG0 = dataclasses.replace(
    tiny_config(),
    backbone=dataclasses.replace(tiny_config().backbone, kv_capacity=256))
PJ, CFG = params_from_flat(random_flat(CFG0, seed=71), CFG0)
PT = from_jax_numpy(jax.tree.map(np.asarray, PJ))
VOICES = {"va": random_voice_prompt(CFG, 12, seed=1),
          "vb": random_voice_prompt(CFG, 16, seed=2)}
TEXT_A = "The first stream keeps the batch busy for quite a while longer."
TEXT_B = "Joining mid decode."
TEXT_C = "A third one, short."


def engine(seed=0, **kw):
    return TTSEngine(params=PT, cfg=CFG, seed=seed, device="cpu",
                     tokenizer=MockTokenizer(CFG.lut.n_bins), **kw)


def server(eng, lanes=2, chunk_frames=4, **kw):
    srv = ContinuousBatchingServer(eng, lanes=lanes,
                                   chunk_frames=chunk_frames,
                                   text_bucket=32, **kw)
    srv.register_voices(VOICES)
    return srv


def solo(eng, text, voice):
    prepared, guess = prepare_text_prompt(text)
    return eng.synthesize_sentence(eng.prime_voice(VOICES[voice]), prepared,
                                   0.0, guess + 2)


def test_mid_decode_admission_matches_solo():
    eng = engine()
    srv = server(eng)
    ra = srv.submit(TEXT_A, "va", temp=0.0)
    srv.step()
    srv.step()                          # A is mid-decode
    assert ra.ttfa_s is not None and srv._live.count(None) == 1
    rb = srv.submit(TEXT_B, "vb", temp=0.0)
    assert srv.step() > 0               # B admitted here, audio at once
    assert rb.ttfa_s is not None and rb.admit_step == 2
    srv.run_pending()
    for r, text, voice in ((ra, TEXT_A, "va"), (rb, TEXT_B, "vb")):
        want = solo(eng, text, voice)
        assert r.pcm.shape == want.shape
        np.testing.assert_allclose(r.pcm, want, atol=SOLO_ATOL, rtol=0)
    st = srv.stats()
    assert st["requests"] == 2 and st["p50_ttfa_s"] is not None


def test_ring_wrap_matches_solo():
    """B is admitted late enough that the shared cursor wraps inside the
    ring while B decodes: its rows land in recycled slots."""
    eng = engine()
    srv = server(eng)
    ring = srv.capacity - srv.prefix_slots
    ra = srv.submit(TEXT_A, "va", temp=0.0)
    for _ in range(40):
        srv.step()
    rb = srv.submit(TEXT_B, "vb", temp=0.0)
    wrapped = False
    while srv._queue or any(srv._live):
        before = srv.batch.flow.end
        srv.step()
        wrapped |= srv.batch is not None and srv.batch.flow.end < before
    assert wrapped, f"no wrap in a ring of {ring} slots"
    for r, text, voice in ((ra, TEXT_A, "va"), (rb, TEXT_B, "vb")):
        np.testing.assert_allclose(r.pcm, solo(eng, text, voice),
                                   atol=SOLO_ATOL, rtol=0)


def test_eager_compaction_matches_solo():
    eng = engine()
    srv = server(eng, ring=False, compact_margin=16)
    ra = srv.submit(TEXT_A, "va", temp=0.0)
    srv.step()
    rb = srv.submit(TEXT_B, "vb", temp=0.0)
    srv.run_pending()
    assert srv.compactions >= 1
    for r, text, voice in ((ra, TEXT_A, "va"), (rb, TEXT_B, "vb")):
        np.testing.assert_allclose(r.pcm, solo(eng, text, voice),
                                   atol=SOLO_ATOL, rtol=0)


def test_oversized_request_rejected_siblings_kept():
    eng = engine()
    srv = server(eng, lanes=3)
    r1 = srv.submit(TEXT_B, "va", temp=0.0)
    srv.submit(" ".join(["word"] * 60) + ".", "va", temp=0.0)
    r3 = srv.submit(TEXT_C, "vb", temp=0.0)
    with pytest.raises(ValueError, match="text_bucket"):
        srv.run_pending()
    srv.run_pending()
    assert [r.pcm is not None for r in (r1, r3)] == [True, True]
    np.testing.assert_allclose(r1.pcm, solo(eng, TEXT_B, "va"),
                               atol=SOLO_ATOL, rtol=0)
    np.testing.assert_allclose(r3.pcm, solo(eng, TEXT_C, "vb"),
                               atol=SOLO_ATOL, rtol=0)


def _jax_engine():
    return JEngine(params=PJ, cfg=CFG, seed=0,
                   tokenizer=MockTokenizer(CFG.lut.n_bins))


@pytest.mark.parametrize("ring", [True, False])
def test_continuous_server_matches_jax(ring):
    jsrv = JCBS(_jax_engine(), lanes=2, chunk_frames=4, text_bucket=32,
                ring=ring)
    jsrv.register_voices({k: np.asarray(v) for k, v in VOICES.items()})
    tsrv = server(engine(), ring=ring)
    reqs = []
    for srv in (jsrv, tsrv):
        a = srv.submit(TEXT_A, "va", temp=0.0)
        srv.step()
        b = srv.submit(TEXT_B, "vb", temp=0.0)
        c = srv.submit(TEXT_C, "va", temp=0.0)
        srv.run_pending()
        reqs.append((a, b, c))
    for rj, rt in zip(*reqs):
        assert rt.pcm.shape == rj.pcm.shape
        np.testing.assert_allclose(rt.pcm, rj.pcm, atol=JAX_ATOL, rtol=0)
        assert rt.admit_step == rj.admit_step


def test_multistream_server_matches_jax():
    jsrv = JMSS(_jax_engine(), max_batch=3, chunk_frames=10)
    tsrv = MultiStreamServer(engine(), max_batch=3, chunk_frames=10)
    reqs = []
    for srv in (jsrv, tsrv):
        srv.register_voices({k: np.asarray(v) for k, v in VOICES.items()})
        rs = [srv.submit(t, v, temp=0.0) for t, v in
              ((TEXT_A, "va"), (TEXT_B, "vb"), (TEXT_C, "vb"),
               (TEXT_B, "va"))]
        srv.run_pending()
        reqs.append(rs)
    for rj, rt in zip(*reqs):
        assert rt.pcm.shape == rj.pcm.shape
        np.testing.assert_allclose(rt.pcm, rj.pcm, atol=JAX_ATOL, rtol=0)
    assert tsrv.stats()["requests"] == 4


def test_seeded_noise_independent_of_admission_order():
    """temp 0.7: a request's audio depends on its seed, not on its lane or
    on when it was admitted."""
    eng = engine()
    out = []
    for order in ((0, 1, 2), (2, 1, 0)):
        srv = server(eng, lanes=2)
        reqs = {}
        for i, k in enumerate(order):
            reqs[k] = srv.submit((TEXT_A, TEXT_B, TEXT_C)[k],
                                 ("va", "vb", "va")[k], temp=0.7,
                                 seed=100 + k)
            if i == 0:
                srv.step()
        srv.run_pending()
        out.append(reqs)
    for k in range(3):
        np.testing.assert_allclose(out[0][k].pcm, out[1][k].pcm, atol=1e-5,
                                   rtol=0)
    assert not np.allclose(out[0][1].pcm, solo(eng, TEXT_B, "vb"))


def test_unseeded_requests_draw_engine_seeds():
    eng = engine(seed=3)
    srv = server(eng)
    r1 = srv.submit(TEXT_B, "va", temp=0.5)
    r2 = srv.submit(TEXT_B, "va", temp=0.5)
    srv.run_pending()
    assert r1.seed != r2.seed
    assert not np.allclose(r1.pcm, r2.pcm)
    assert engine(seed=3).request_seed() == r1.seed


@pytest.mark.parametrize("what", ["share_prefix", "quantize", "mesh"])
def test_unported_serving_options_raise(what):
    """What serving refuses: shared-prefix tables outside the prefix+ring
    mode (as the JAX server does). Quantized convs and quantized weights
    on a device mesh, once refused, serve: with int8 weights and quantized
    convs both servers give the solo engine's audio
    (tests/test_torch_conv_quant.py serves a decoder whose convs quantize,
    in the serving mode), and with int8 weights on a 1 x 2 mesh of gloo
    ranks both give the unsharded servers' audio
    (tests/test_torch_sharding_quant.py holds the mesh to the JAX
    package)."""
    if what == "quantize":
        eng = engine(quantize="int8", quantize_convs=True)
        want = solo(eng, TEXT_B, "vb")
        for srv in (server(eng),
                    MultiStreamServer(eng, max_batch=2, chunk_frames=10)):
            srv.register_voices(VOICES)
            r = srv.submit(TEXT_B, "vb", temp=0.0)
            srv.run_pending()
            assert r.pcm.shape == want.shape
            np.testing.assert_allclose(r.pcm, want, atol=SOLO_ATOL, rtol=0)
        return
    if what == "share_prefix":
        with pytest.raises(ValueError, match="ring"):
            ContinuousBatchingServer(engine(), share_prefix=True,
                                     ring=False)
        return
    import _torch_mesh_ranks as ranks
    from pocket_tts_tpu_torch.parallel import launch
    reqs = [(TEXT_B, "va"), (TEXT_C, "vb")]
    eng = engine(quantize="int8")
    srv = server(eng)
    want = [srv.submit(TEXT_B, "va", temp=0.0)]
    srv.step()
    want.append(srv.submit(TEXT_C, "vb", temp=0.0))
    srv.run_pending()
    mss = MultiStreamServer(eng, max_batch=2, chunk_frames=5)
    mss.register_voices(VOICES)
    want_mss = [mss.submit(t, v, temp=0.0) for t, v in reqs]
    mss.run_pending()
    kw = dict(quantize="int8")
    pnp = ranks.to_numpy(PT)
    with launch.RankGroup(1, 2, device="cpu", timeout=300) as group:
        cbs = group.run(ranks.server_job, pnp, CFG, VOICES, reqs, 1, 2, {},
                        kw)
        multi = group.run(ranks.multistream_job, pnp, CFG, VOICES, reqs, 2,
                          kw)
    assert all(o["calls"]["K4a"] > 0 and o["calls"]["K5a"] == 0
               for o in cbs)
    for got, ref in ([(o["pcm"], want) for o in cbs]
                     + [(o, want_mss) for o in multi]):
        for a, r in zip(got, ref):
            assert a.shape == r.pcm.shape and a.size
            np.testing.assert_allclose(a, r.pcm, atol=JAX_ATOL, rtol=0)


def test_cli_serve_writes_one_wav_per_request(tmp_path, monkeypatch,
                                              capsys):
    from pocket_tts_tpu_torch import cli, config
    from pocket_tts_tpu_torch.io.wav import load_wav
    monkeypatch.setattr(config, "DEFAULT_CONFIG", CFG)
    reqs = tmp_path / "reqs.txt"
    reqs.write_text("Hello world.\n\n"
                    + json.dumps({"text": "Second one here. And more.",
                                  "id": "two", "temp": 0}) + "\n")
    out = tmp_path / "out"
    assert cli.main(["--random-weights", "--device", "cpu", "-t", "0",
                     "--lanes", "2", "--serve", str(reqs), "--serve-out",
                     str(out)]) == 0
    assert sorted(os.listdir(out)) == ["req_0000.wav", "two.wav"]
    for name in os.listdir(out):
        pcm, sr = load_wav(str(out / name))
        assert sr == 24000 and pcm.size > 0 and pcm.size % 1920 == 0
    stats = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert stats["requests"] == 2 and stats["chunks"] >= 2


def test_cli_without_card_needs_device_cpu(capsys, tmp_path, monkeypatch):
    """Without a card the CLI needs --device cpu; with it --serve runs
    --quantize int8 --quantize-convs (once refused), one wav per
    request."""
    from pocket_tts_tpu_torch import cli, config
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert cli.main(["--random-weights", "--serve", "-"]) == 1
    assert "--device cpu" in capsys.readouterr().err
    monkeypatch.setattr(config, "DEFAULT_CONFIG", CFG)
    reqs = tmp_path / "reqs.txt"
    reqs.write_text("Hello world.\n")
    out = tmp_path / "out"
    assert cli.main(["--random-weights", "--device", "cpu", "-t", "0",
                     "--lanes", "2", "--serve", str(reqs), "--serve-out",
                     str(out), "--quantize", "int8",
                     "--quantize-convs"]) == 0
    assert os.listdir(out) == ["req_0000.wav"]


# ---------------------------------------------------------------------------
# the lane scheduler's seam, under a stand-in model
# ---------------------------------------------------------------------------

FRAME = 3   # samples a frame of the stand-in model


@dataclasses.dataclass
class _Ask(Job):
    frames: int


class _Seeds:
    """The engine as the scheduler sees one: seeds 101, 102, ... in turn."""
    frame_size = FRAME

    def __init__(self):
        self.drawn = 0

    def request_seed(self):
        self.drawn += 1
        return 100 + self.drawn


class _Echo(LaneScheduler):
    """The smallest lane model: a request asks for `frames` frames, each of
    FRAME samples equal to its seed; a lane holds `capacity` frames;
    `fail` ("write" or "chunk") makes that call raise."""

    def __init__(self, lanes=2, capacity=8, chunk_frames=2):
        super().__init__(_Seeds(), lanes, capacity, chunk_frames)
        self.fail = None
        self.writes = []     # (lane, id, seed) of each lane write

    @property
    def lane_frames(self):
        return self.capacity

    def submit(self, frames, seed=None):
        return self._submit(_Ask(frames=frames, seed=seed))

    def _validate(self, req):
        return req.frames

    def _reset_epoch(self):
        self._free_batch()
        b = self.lanes
        self.batch = SimpleNamespace(done=torch.ones(b, dtype=torch.bool),
                                     graphs=None, left=[0] * b,
                                     value=[0.0] * b)

    def _write_lanes(self, group):
        if self.fail == "write":
            raise RuntimeError("lane write")
        for lane, req in group:
            self.writes.append((lane, req.id, req.seed))
            self.batch.left[lane] = req.frames
            self.batch.value[lane] = float(req.seed)
            self.batch.done[lane] = False

    def _decode_chunk(self):
        if self.fail == "chunk":
            raise RuntimeError("chunk")
        b, c, st = self.lanes, self.chunk_frames, self.batch
        valid = torch.zeros(b, c, dtype=torch.bool)
        for lane in range(b):
            n = min(c, st.left[lane])
            valid[lane, :n] = True
            st.left[lane] -= n
            st.done[lane] = st.left[lane] == 0
        pcm = torch.tensor(st.value)[:, None, None].expand(b, c, FRAME)
        return pcm.clone(), valid


def _cleared(req):
    return (req.ttfa_s, req.first_audio_step, req.admit_step,
            req.admitted_at) == (None,) * 4


@pytest.mark.parametrize("case", ["ring", "oversized", "seeds", "stamps",
                                  "done", "chunk_raises", "write_raises"])
def test_lane_scheduler_seam(case):
    """Two lanes of 8 frames, chunks of 2: a (3 frames, seed 11), b (5),
    c (2, or 9 where `oversized`) and d (4, seed 7) in that order. Ring
    admission fills idle lanes in queue order; a request larger than a
    lane is refused and evicted; seeds are drawn in order; time to first
    audio and its step are stamped; a finished request has its chunks
    joined; a lane write or a chunk that raises puts every request the
    scheduler held back at the queue front, stamps cleared (live lanes
    last lane first, then the group in its order), and the queue then
    drains to the same audio."""
    srv = _Echo()
    a, b, c, d = (srv.submit(f, seed=s) for f, s in (
        (3, 11), (5, None), (9 if case == "oversized" else 2, None),
        (4, 7)))
    assert srv.step() == 4                       # a and b, 2 frames each
    assert srv._live == [a, b] and srv._queue == [c, d]
    if case == "chunk_raises":
        srv.fail = "chunk"
        with pytest.raises(RuntimeError, match="chunk"):
            srv.step()
        assert srv._queue == [b, a, c, d] and srv._live == [None, None]
        assert _cleared(a) and _cleared(b) and srv.batch is None
        assert srv._chunks == [[], []]
        srv.fail = None
    srv.step()                                   # a completes
    if case == "oversized":
        with pytest.raises(ValueError, match="lane holds"):
            srv.step()
        assert c not in srv._queue and c.admit_step is None
    if case == "write_raises":
        srv.fail = "write"
        with pytest.raises(RuntimeError, match="lane write"):
            srv.step()
        assert srv._queue == [b, c, d] and _cleared(b) and _cleared(c)
        assert srv._live == [None, None] and srv.batch is None
    srv.fail = None
    srv.run_pending()
    done = [r for r in (a, b, c, d) if r.pcm is not None]
    assert done == ([a, b, d] if case == "oversized" else [a, b, c, d])
    for r in done:
        assert np.array_equal(r.pcm, np.full(r.frames * FRAME,
                                             float(r.seed), np.float32))
    if case == "ring":
        assert [(lane, rid) for lane, rid, _ in srv.writes] == [
            (0, a.id), (1, b.id), (0, c.id), (0, d.id)]
        assert [r.admit_step for r in done] == [0, 0, 2, 3]
        assert srv.steps == 5 and srv.completed == [a, c, b, d]
    elif case == "seeds":
        # drawn in queue order, once each; a seeded request keeps its own
        assert [r.seed for r in done] == [11, 101, 102, 7]
        assert srv.engine.drawn == 2
    elif case == "stamps":
        for r in done:
            assert r.submitted_at <= r.admitted_at <= r.done_at
            assert r.ttfa_s > 0
            assert r.first_audio_step == r.admit_step + 1
    elif case == "done":
        assert [len(r.chunks) for r in done] == [2, 3, 1, 2]
        for r in done:
            assert np.array_equal(np.concatenate(r.chunks), r.pcm)
        assert srv.stats()["frames"] == 3 + 5 + 2 + 4
    elif case in ("chunk_raises", "write_raises"):
        # restarted from scratch: the same seeds, no frame twice
        assert [r.seed for r in done] == [11, 101, 102, 7]
        assert srv._queue == [] and srv._live == [None, None]
