"""Moshi on the port (models/moshi.py, models/mimi.py's RVQ decode,
runtime/moshi.py, the continuous-batching server), held on the CPU at a
tiny size (config.tiny_moshi_config: temporal 2 x 64 with 4 heads of 16,
depth 2 x 32 at 4 sub-steps, 4 codebooks of 16, SEANet's four stages at
small widths, a 20-frame window over a 24-slot ring) on a seeded random
checkpoint against the benchmark's plain float32 reference,
ptts_bench/moshi/reference.py (a full causal forward, teacher-forced on
the served tokens; no cache, no lanes, no kernel).

Tolerances: both sides compute in float32 on the same weights and differ
only in the order of their sums (a cache step against a full pass,
halves RoPE on permuted columns against interleaved RoPE, streaming
convs against whole ones); they agree to ~3e-7 relative. The tests hold
1e-5, thirty times that, while a wrong weight, mask, delay or carry
moves the numbers by 1e-2 to 1. The checkpoint is the benchmark's
(ptts_bench/moshi/weights.py), drawn apart from the port: its norms and
layer scales differ from 1 and from each other, so that a swapped norm
or scale shows (`test_a_swapped_norm_or_scale_is_seen`).
"""
import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from pocket_tts_tpu_torch.config import tiny_moshi_config
from pocket_tts_tpu_torch.io import moshi_params
from pocket_tts_tpu_torch.models import mimi, mimi_transformer, moshi, seanet
from pocket_tts_tpu_torch.ops.seanet_frame import (carry_keys, frame_shapes,
                                                   kernel_ok, last_key)
from pocket_tts_tpu_torch.runtime.moshi import MoshiEngine, MoshiServer
from ptts_bench.moshi import reference as R
from ptts_bench.moshi import weights as W

ROOT = Path(__file__).resolve().parents[1]
TOL = 1e-5
N = 64          # rows of a lane's uniform and user-code tables


def rel(a, b) -> float:
    return float((a.float() - b.float()).norm() / b.float().norm())


@pytest.fixture(scope="module")
def cfg():
    return tiny_moshi_config()


@pytest.fixture(scope="module")
def flat(cfg):
    return W.draw(dataclasses.asdict(cfg), 5, "cpu", torch.float32)


@pytest.fixture(scope="module")
def params(cfg, flat):
    return moshi_params.params_from_flat(dict(flat), cfg, torch.float32)


@pytest.fixture(scope="module")
def ref(cfg, flat):
    return R.Model(flat, dataclasses.asdict(cfg), R.configured(), "cpu")


def tables(cfg, seed, b=1):
    g = torch.Generator().manual_seed(seed)
    noise = torch.rand(b, N, 1 + cfg.n_q, generator=g)
    user = torch.randint(0, cfg.card, (b, N, cfg.n_q), generator=g)
    return noise, user


def serve_lanes(params, cfg, noise, user, plan, steps, hook=None,
                history=None):
    """Run `steps` frames of a len(plan)-lane batch; plan[b] = (the frame
    lane b is admitted at, its call's frames); history: {lane: (text,
    codes)} of calls resumed at a step. Returns per lane its frames' text
    logits, audio logits, tokens, grid columns and PCM."""
    b = len(plan)
    st = moshi.empty_lanes(cfg, b)
    out = [dict(text=[], audio=[], tokens=[], prev=[], pcm=[])
           for _ in range(b)]
    history = history or {}
    for i in range(steps):
        for lane, (at, n) in enumerate(plan):
            if at == i:
                moshi.admit(cfg, st, [lane], [n])
                if lane in history:
                    text, codes = history[lane]
                    moshi.resume(params, cfg, st, lane,
                                 moshi.history_columns(cfg, text, codes,
                                                       user[lane]))
                out[lane]["prev"].append(st.prev[lane].clone())
        if hook:
            hook(i, st)
        pcm, valid = moshi.frame_step_lanes_eager(params, cfg, st, noise,
                                                  user)
        for lane, (at, n) in enumerate(plan):
            if at <= i <= at + n:
                o = out[lane]
                o["text"].append(st.text_logits[lane].clone())
                o["audio"].append(st.audio_logits[lane].clone())
                o["tokens"].append(st.tokens[lane].clone())
                o["prev"].append(st.prev[lane].clone())
                if valid[lane]:
                    o["pcm"].append(pcm[lane].clone())
    return [{k: torch.stack(v) if v else None for k, v in o.items()}
            for o in out]


def solo(params, cfg, n, seed=1):
    noise, user = tables(cfg, seed)
    return serve_lanes(params, cfg, noise, user, [(0, n)], n + 1)[0], user


@pytest.mark.parametrize("n", [6, 26])
def test_frames_through_the_caches_match_the_reference(n, params, cfg,
                                                       ref):
    """Every step's text logits, every sub-step's logits and the PCM of a
    call (26 frames: past the 20-frame window and the 24-slot ring, the
    Mimi ring wrapped) against the reference teacher-forced on the
    served tokens."""
    got, user = solo(params, cfg, n)
    tok = got["tokens"]
    text, audio, pcm = R.run_call(ref, tok[:, 0], tok[:, 1:],
                                  user[0, :n])
    assert got["pcm"].shape == (n, cfg.frame_size)
    for t in range(n + 1):
        assert rel(got["text"][t], text[t]) < TOL
        for k in range(cfg.n_q):
            assert rel(got["audio"][t, k], audio[t, k]) < TOL
    assert rel(got["pcm"].reshape(-1), pcm) < TOL


def _history(cfg, a, seed=8):
    g = torch.Generator().manual_seed(seed)
    return (torch.randint(0, cfg.text_card, (a,), generator=g),
            torch.randint(0, cfg.card, (a, cfg.n_q), generator=g))


@pytest.mark.parametrize("a", [1, 9])
def test_a_resumed_call_matches_the_reference(a, params, cfg, ref):
    """A call of 16 frames resumed at step a (its first a steps' tokens
    given, prefilled through the temporal transformer in one causal
    pass): every served step's logits, and its PCM from frame a - 1 on
    decoded from silence, against the reference teacher-forced on the
    history and the served tokens."""
    n = 16
    noise, user = tables(cfg, 12)
    hist = _history(cfg, a)
    got = serve_lanes(params, cfg, noise, user, [(0, n)], n + 1 - a,
                      history={0: hist})[0]
    tok = torch.cat([torch.cat([hist[0][:, None], hist[1]], 1),
                     got["tokens"]])
    assert tok.shape[0] == n + 1
    text, audio, pcm = R.run_call(ref, tok[:, 0], tok[:, 1:], user[0, :n],
                                  start=a)
    assert got["pcm"].shape == (n - a + 1, cfg.frame_size)
    assert rel(got["text"], text) < TOL
    assert rel(got["audio"], audio) < TOL
    assert rel(got["pcm"].reshape(-1), pcm) < TOL


@pytest.mark.parametrize("pair", [
    ("transformer.layers.1.norm1.alpha", "transformer.layers.1.norm2.alpha"),
    ("depformer.layers.0.norm1.alpha", "depformer.layers.0.norm2.alpha"),
    ("mimi.decoder_transformer.transformer.layers.0.norm1.weight",
     "mimi.decoder_transformer.transformer.layers.0.norm2.weight"),
    ("mimi.decoder_transformer.transformer.layers.1.layer_scale_1.scale",
     "mimi.decoder_transformer.transformer.layers.1.layer_scale_2.scale")])
def test_a_swapped_norm_or_scale_is_seen(pair, flat, cfg, ref):
    """The port on the checkpoint with two of its norms' or layer scales'
    weights swapped falls far outside the tolerance against the reference
    on the true checkpoint: the check sees a misrouted norm or scale."""
    f = dict(flat)
    f[pair[0]], f[pair[1]] = flat[pair[1]], flat[pair[0]]
    bad = moshi_params.params_from_flat(f, cfg, torch.float32)
    n = 6
    got, user = solo(bad, cfg, n)
    tok = got["tokens"]
    text, audio, pcm = R.run_call(ref, tok[:, 0], tok[:, 1:], user[0, :n])
    worst = max(rel(got["text"], text), rel(got["audio"], audio),
                rel(got["pcm"].reshape(-1), pcm))
    assert worst > 100 * TOL


def test_delay_grid_and_initial_tokens(params, cfg):
    """The grid column a frame reads is the reference's (`grid`): column -1
    all initial tokens, then the drawn tokens at their delays and the
    user's codes, each stream its initial token before its first."""
    n = 7
    got, user = solo(params, cfg, n)
    g = R.grid(dataclasses.asdict(cfg), got["tokens"][:, 0],
               got["tokens"][:, 1:], user[0, :n])
    init = moshi.initial_tokens(cfg, "cpu")
    assert torch.equal(got["prev"][0], init)
    # columns 0 .. n - 1, the inputs of steps 1 .. n (column n is never read)
    assert torch.equal(got["prev"][1:-1], g[:-1])
    delayed = [s for s, d in enumerate(cfg.delays) if d]
    assert torch.equal(g[0, delayed], init[delayed])


def test_depth_kv_is_reset_each_frame(params, cfg):
    """Filling the depth transformer's K/V rows with NaN before each frame
    changes nothing: a sub-step reads only the rows its frame wrote."""
    noise, user = tables(cfg, 2)
    clean = serve_lanes(params, cfg, noise, user, [(0, 5)], 6)[0]

    def spoil(i, st):
        for x in st.dk + st.dv:
            x.fill_(float("nan"))
    dirty = serve_lanes(params, cfg, noise, user, [(0, 5)], 6, spoil)[0]
    for key in ("text", "audio", "pcm"):
        assert torch.equal(clean[key], dirty[key])


@pytest.mark.parametrize("k", [0, 2])
def test_sub_step_k_uses_its_own_weights(k, params, cfg):
    """Doubling the depth layer 0's in_proj of sub-step k leaves the
    logits of the sub-steps before k as they were and moves sub-step k's."""
    noise, user = tables(cfg, 3)
    base = serve_lanes(params, cfg, noise, user, [(0, 2)], 1)[0]
    p2 = dict(params, depth=dict(params["depth"]))
    layers = [dict(lp) for lp in params["depth"]["layers"]]
    layers[0]["in_proj"] = list(layers[0]["in_proj"])
    layers[0]["in_proj"][k] = {"w": 2 * layers[0]["in_proj"][k]["w"]}
    p2["depth"]["layers"] = layers
    moved = serve_lanes(p2, cfg, noise, user, [(0, 2)], 1)[0]
    a, b = base["audio"][0], moved["audio"][0]
    assert torch.equal(a[:k], b[:k])
    assert rel(b[k], a[k]) > 1e-3


@pytest.mark.parametrize("part", ["rvq", "transformer", "seanet",
                                  "decode"])
def test_mimi_parts_match_the_reference(part, params, cfg, ref):
    """Moshi's Mimi frame by frame against the reference's whole pass: the
    split RVQ; the transformer over 2 rows a frame (30 frames: its 16-slot
    ring wraps, its 12-row window slides); SEANet's four stages behind the
    widening first conv (its 6-row carry over 2 rows a frame); and the
    whole decode (RVQ, upsample, transformer, SEANet)."""
    mc, pm = cfg.mimi, params["mimi"]
    g = torch.Generator().manual_seed(11)
    frames = 30
    codes = torch.randint(0, cfg.card, (frames, cfg.n_q), generator=g)
    if part == "rvq":
        got = mimi.rvq_decode(pm["quantizer"], codes)
        assert rel(got, ref.rvq(codes)) < TOL
        return
    rows = torch.randn(frames, mc.upsample_stride, mc.dim, generator=g)
    if part == "transformer":
        st = mimi_transformer.init_state(mc.transformer)
        got = torch.cat([mimi_transformer.forward(
            pm["decoder_transformer"], mc.transformer, st, r)[1]
            for r in rows])
        assert rel(got, ref.mimi_transformer(rows.reshape(-1, mc.dim))) \
            < TOL
        return
    if part == "seanet":
        st = seanet.init_state(mc.seanet, mc.upsample_stride)
        outs = []
        for r in rows:
            new, pcm = seanet.forward_plain(pm["decoder"], mc.seanet, st, r)
            st = new
            outs.append(pcm[:, 0])
        assert rel(torch.cat(outs), ref.seanet(rows.reshape(-1, mc.dim))
                   [:, 0]) < TOL
        return
    st = mimi.init_state_lanes(mc, 1)
    st.transformer.offset_dev = torch.zeros(1, dtype=torch.int32)
    got = torch.cat([mimi.decode_codes_frame(pm, mc, st, c[None])[1][0]
                     for c in codes])
    assert rel(got, ref.mimi(codes)) < TOL


def test_two_lanes_at_different_positions(params, cfg):
    """Lane 0 from frame 0, lane 1 admitted 4 frames later, each equal to
    its call served alone (its own uniforms and user codes)."""
    noise, user = tables(cfg, 4, b=2)
    both = serve_lanes(params, cfg, noise, user, [(0, 9), (4, 6)], 11)
    for lane, (n, seed_rows) in enumerate(((9, 0), (6, 1))):
        alone = serve_lanes(params, cfg, noise[lane:lane + 1],
                            user[lane:lane + 1], [(0, n)], n + 1)[0]
        assert torch.equal(both[lane]["tokens"], alone["tokens"])
        for key in ("text", "audio", "pcm"):
            assert rel(both[lane][key], alone[key]) < TOL


def test_a_call_served_through_the_continuous_batching_server(params, cfg,
                                                              ref):
    """Four seeded calls through the continuous-batching server
    (MoshiServer) on two lanes (the third admitted when the first
    finishes; the second resumed at step 3 with its history): each call's
    PCM is its frames from its first served one, equal to the same call
    run alone in a lane with the uniforms the engine draws from its seed,
    and the reference's decode of the tokens drawn."""
    eng = MoshiEngine(params, cfg, device="cpu")
    srv = MoshiServer(eng, lanes=2, chunk_frames=3)
    rng = np.random.default_rng(0)
    calls = [rng.integers(0, cfg.card, (n, cfg.n_q)) for n in (5, 9, 4, 7)]
    hist = {1: tuple(x.numpy() for x in _history(cfg, 3))}
    reqs = [srv.submit_call(c, seed=10 + i, history=hist.get(i))
            for i, c in enumerate(calls)]
    srv.run_pending()
    assert reqs[2].admit_step > 0 and reqs[1].age == 3
    for i, (req, codes) in enumerate(zip(reqs, calls)):
        n, a = len(codes), req.age
        assert req.pcm.shape == ((n - max(a - 1, 0)) * cfg.frame_size,)
        noise = eng.draws(10 + i, srv.capacity)[None, :N]
        user = torch.zeros(1, N, cfg.n_q, dtype=torch.int64)
        user[0, :n] = torch.from_numpy(codes)
        h = ({0: tuple(torch.from_numpy(x) for x in hist[i])} if a
             else None)
        alone = serve_lanes(params, cfg, noise, user, [(0, n)], n + 1 - a,
                            history=h)[0]
        assert rel(torch.from_numpy(req.pcm), alone["pcm"].reshape(-1)) < TOL
        tok = alone["tokens"]
        if a:
            tok = torch.cat([torch.cat([h[0][0][:, None], h[0][1]], 1), tok])
        pcm = R.run_mimi(ref, tok[:, 1:], start=a)
        assert rel(torch.from_numpy(req.pcm), pcm) < TOL


@pytest.mark.parametrize("bad", ["codebooks", "history_len",
                                 "history_shape"])
def test_the_server_refuses_malformed_calls(bad, params, cfg):
    """A call's codes must have n_q columns; its history 0 < a < frames
    steps of text and n_q codes."""
    srv = MoshiServer(MoshiEngine(params, cfg, device="cpu"), lanes=2)
    codes = np.zeros((4, cfg.n_q), np.int64)
    args = {"codebooks": (np.zeros((4, cfg.n_q + 1), np.int64), None),
            "history_len": (codes, (np.zeros(4), np.zeros((4, cfg.n_q)))),
            "history_shape": (codes, (np.zeros(2), np.zeros((2, 1))))}[bad]
    with pytest.raises(ValueError):
        srv.submit_call(args[0], history=args[1])


def test_the_engine_takes_the_card_unless_told(monkeypatch):
    """MoshiEngine's device is the card when none is given, and it raises
    where there is none (the CPU is taken only when asked for)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MoshiEngine({}, tiny_moshi_config())


def test_sample_topk_is_the_inverse_of_the_top_k_cdf():
    """Top-3 of [0, 3, 1, 2] at temperature 1: weights e^3, e^2, e^1 in
    that order; a uniform below the first's share draws index 1, past the
    first two's draws index 2."""
    logits = torch.tensor([[0.0, 3.0, 1.0, 2.0]] * 3)
    w = torch.softmax(torch.tensor([3.0, 2.0, 1.0]), 0)
    u = torch.tensor([w[0] * 0.5, w[0] + w[1] * 0.5,
                      w[0] + w[1] + w[2] * 0.5])
    assert moshi.sample_topk(logits, u, 1.0, 3).tolist() == [1, 3, 2]


def test_k3_covers_four_stages(cfg):
    """K3's launch plan at Moshi's four stages: the final conv is model_14,
    18 launches a frame (14 at three), the first conv 2 rows of 7 x 512 ->
    1024 at full width."""
    from pocket_tts_tpu_torch.config import DEFAULT_CONFIG, MoshiConfig
    full = MoshiConfig().mimi.seanet
    assert kernel_ok(full) and kernel_ok(cfg.mimi.seanet)
    assert last_key(full) == "model_14" and len(carry_keys(full)) == 10
    assert len(frame_shapes(full, 1, 2)) == 18
    assert len(frame_shapes(DEFAULT_CONFIG.mimi.seanet, 1, 16)) == 14
    assert frame_shapes(full, 32, 2)[0] == ("model_0", "gemm", 64, 1024,
                                            7 * 512)


def _tiny_cell(cfg):
    """The benchmark's Moshi configuration and mix at the tiny size."""
    conf = json.loads((ROOT / "ptts_bench/configs/moshi-7b.bf16.json")
                      .read_text())
    m = dataclasses.asdict(cfg)
    for k in ("text_temp", "text_topk", "audio_temp", "audio_topk"):
        m.pop(k)
    conf["model"] = m
    conf["serving"]["dtype"] = "float32"
    mix = json.loads((ROOT / "ptts_bench/traffic/duplex32.json")
                     .read_text())
    mix.update(lanes=3, capacity=24, pool=64, sample=4, trace_chunks=2)
    mix["arrivals"].update(sessions=3)
    mix["frames"].update(median=8, min=4, max=18)
    mix["codes"].update(bins=cfg.card, codebooks=cfg.n_q)
    mix["sampling"].update(text_topk=5, audio_topk=6)
    mix["aged"].update(text_bins=cfg.text_card)
    return conf, mix


def test_the_family_plans_the_same_lengths_for_every_seed(cfg):
    """Every seed's plan holds the same multiset of call lengths (the
    log-normal's quantiles, 250-2250 frames at the cell's size), in its
    own order; its first calls, one a session, are aged: longer than the
    pool's mean (a call under way is drawn by its length), each at an age
    below its length."""
    from ptts_bench import families
    conf = json.loads((ROOT / "ptts_bench/configs/moshi-7b.bf16.json")
                      .read_text())
    fam = families.load(conf, ROOT / "ptts_bench")
    mix = json.loads((ROOT / "ptts_bench/traffic/duplex32.json")
                     .read_text())
    plans = [fam.plan(mix, s) for s in (1, 2 ** 31 + 5, 3 * 10 ** 9)]
    lens = [[p.frames for p in pl] for pl in plans]
    assert sorted(lens[0]) == sorted(lens[1]) == sorted(lens[2])
    assert lens[0] != lens[1]
    assert min(lens[0]) == 250 and max(lens[0]) <= 2250
    assert sorted(lens[0])[len(lens[0]) // 2] == pytest.approx(750, abs=5)
    # the sessions' first calls are under way: drawn by length, at an
    # age below it; the rest start fresh
    n = mix["arrivals"]["sessions"]
    for pl in plans:
        assert all(0 <= p.age < p.frames for p in pl[:n])
        assert sum(p.age > 0 for p in pl[:n]) >= n - 2
        assert all(p.age == 0 for p in pl[n:])
    first = [p.frames for pl in plans for p in pl[:n]]
    assert np.mean(first) > 1.1 * np.mean(lens[0])


def test_spans_nest_in_the_frame(cfg):
    """tools/serve_spans.py through the family seam on the tiny cell: the
    three spans of Moshi's frame are recorded in every traced frame, each
    inside its `ptt.frame`."""
    import importlib.util
    from ptts_bench import families
    conf, mix = _tiny_cell(cfg)
    fam = families.load(conf, ROOT / "ptts_bench")
    spec = importlib.util.spec_from_file_location(
        "serve_spans", ROOT / "tools" / "serve_spans.py")
    ss = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ss)
    out = ss.measure(fam, conf, mix, 7, torch.device("cpu"), torch.float32,
                     1, 2)
    assert {"ptt.temporal", "ptt.depth", "ptt.mimi"} <= set(out["nesting"])
    assert all(v == 1.0 for v in out["nesting"].values())
    assert out["split_traced"]["ptt.temporal"] > 0


@pytest.mark.parametrize("trace", [False, True])
def test_the_tiny_cell_judges_aged_calls_correct(trace, cfg):
    """The benchmark's Moshi cell at the tiny size through its harness on
    the CPU in float32: the sessions' first calls resume at their ages,
    calls finish in the window, the judge holds each sampled call
    (aged ones among them, past their history) correct, and the fp8
    control fails; traced, the span metrics the cell lists are read."""
    from ptts_bench import run as brun
    conf, mix = _tiny_cell(cfg)
    # every call finished in the window is judged: how many finish there
    # follows the CPU's pace, and a sample of them can miss the aged one
    mix["sample"] = mix["pool"]
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = next(w for w in bench["workloads"]
                if w["name"] == "moshi7b.duplex32")
    out, rec = brun.run_cell(cell, conf, mix, bench, 2 ** 31 + 9, 1.0,
                             trace, True, torch.device("cpu"),
                             torch.float32, root=ROOT / "ptts_bench")
    assert out["correct"] and out["control_fails"], out
    rows = rec.notes["rows"]
    assert any(r["age"] for r in rows), rows
    assert all(out["checks"][k]["value"] < 1e-4
               for k in ("text_logit_rel", "audio_logit_rel"))
    if trace:
        got = set(out["metrics"])
        assert {"lane_fill_pct", "decode_chunk_ms", "server_host_ms",
                "frame_graph_pct", "host_read_ms.frames"} <= got, got
