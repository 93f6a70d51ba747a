#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU (H100, sm_90a).

    python3 chip_smoke.py [--out DIR]

Drives the port's main path (solo synthesis through `TTSEngine`) at the
full width of DEFAULT_CONFIG with random weights from seed 0, and checks
the three hand-written CUDA kernels on it against their plain PyTorch
versions. Phases, in order; any failure raises and the exit code is 1:

  1. environment   torch / CUDA versions, card name and power limit
  2. build         nvcc builds the kernel library (pocket_tts_tpu_torch/csrc)
  3. kernels       K1 decode attention, K2 ring insert + attention, K3 SEANet
                   frame vs their plain versions at main-path shapes, f32 and
                   bf16, with the tolerances stated below
  4. end to end    bf16 synthesis of the benchmark sentence at temp 0; the
                   launch counters must show 6 K1, 2 K2 and 1 K3 launches per
                   decoded frame
  5. card vs CPU   12 f32 frames on the card vs the port on the CPU
  6. timing        decode frames/s (with and without the per-frame host
                   sync), each kernel's device time vs its plain version's
                   (CUDA events), device busy share of a frame (profiler)

The last three lines of standard output are a JSON object of the kernels, the
card's `nvidia-smi` name and power limit, and the result object
{"ok": true, "device": {...}}. Without a CUDA device the script exits 1 and
prints no result. With --out DIR, the longer output (nvcc's register
report, the profiler table) is also written under DIR.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

# the benchmark sentence of bench.py (fixed text, seed 0, temp 0)
BENCH_TEXT = "The quick brown fox jumped over the sleeping dog."

# Tolerances, set from the working type (max |kernel - plain|):
#  f32: both sides accumulate in f32 and differ only in summation order.
#  bf16: outputs are rounded to bf16 (2^-8 relative) and the kernels round
#        softmax weights and SEANet stages at the TPU kernels' points, the
#        plain versions at the JAX XLA chain's points.
TOL = {
    # attention: absolute, outputs are O(1)
    ("attn", "f32"): 1e-4, ("attn", "bf16"): 2e-2,
    # SEANet: relative to max |plain| (ten rounding stages in a row in bf16)
    ("seanet", "f32"): 1e-4, ("seanet", "bf16"): 5e-2,
    # end to end card vs CPU, f32, relative to max |pcm| after 12 frames
    ("e2e", "f32"): 1e-3,
}
KERNELS = {
    "decode_attn": dict(
        source="pocket_tts_tpu_torch/csrc/decode_attn.cu",
        replaces="pocket_tts_tpu/ops/pallas_attn.py:332"),
    "ring_attn": dict(
        source="pocket_tts_tpu_torch/csrc/ring_attn.cu",
        replaces="pocket_tts_tpu/ops/pallas_mimi.py:324"),
    "seanet_frame": dict(
        source="pocket_tts_tpu_torch/csrc/seanet_frame.cu",
        replaces="pocket_tts_tpu/ops/pallas_seanet.py:258"),
}


def log(*args):
    print(*args, flush=True)


def nvidia_smi() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    return res.stdout.strip().splitlines()[0] if res.returncode == 0 else \
        f"nvidia-smi failed: {res.stderr.strip()}"


def sync(device):
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _dt_name(dtype):
    import torch
    return "bf16" if dtype == torch.bfloat16 else "f32"


# ---------------------------------------------------------------- phase 3 --

def check_k1(device, dtype, results):
    import torch
    from pocket_tts_tpu_torch.ops.decode_attn import (decode_attention,
                                                      decode_attention_plain)
    h, d = 16, 64
    g = torch.Generator(device="cpu").manual_seed(1)
    worst = 0.0
    for s in (128, 384, 1024):
        k = torch.randn(s, h * d, generator=g).to(device, dtype)
        v = torch.randn(s, h * d, generator=g).to(device, dtype)
        q = torch.randn(h, d, generator=g).to(device, dtype)
        for end in sorted({0, 127, 128, s - 1} & set(range(s))):
            pos = torch.arange(s, dtype=torch.int32)
            pos[end + 1:] = -1
            if end > 20:
                pos[3:9] = -1
            pos = pos.to(device)
            got = decode_attention(q, k, v, pos, end)
            want = decode_attention_plain(q, k, v, pos, end)
            sync(device)
            err = (got.float() - want.float()).abs().max().item()
            worst = max(worst, err)
    tol = TOL[("attn", _dt_name(dtype))]
    log(f"  K1 decode_attn {_dt_name(dtype)}: max_abs_err {worst:.3e} "
        f"(tol {tol})")
    if not worst <= tol:
        raise AssertionError(f"K1 {_dt_name(dtype)} error {worst} > {tol}")
    results.setdefault("decode_attn", {})[_dt_name(dtype)] = worst


def check_k2(device, dtype, results):
    import torch
    from pocket_tts_tpu_torch.ops.ring_attn import (
        ring_insert_attention, ring_insert_attention_plain)
    h, d, cap, t, ctx = 8, 64, 256, 16, 250
    g = torch.Generator(device="cpu").manual_seed(2)
    worst = 0.0
    for off in (0, 16, 240, 256, 4096):
        for start in (0, 32):
            if start > off:
                continue
            kc = torch.randn(cap, h * d, generator=g).to(device, dtype)
            vc = torch.randn(cap, h * d, generator=g).to(device, dtype)
            q, kn, vn = (torch.randn(t, h * d, generator=g).to(device, dtype)
                         for _ in range(3))
            kc2, vc2 = kc.clone(), vc.clone()
            got = ring_insert_attention(q, kn, vn, kc, vc, off, start, h, ctx)
            want = ring_insert_attention_plain(q, kn, vn, kc2, vc2, off,
                                               start, h, ctx)
            sync(device)
            if not (torch.equal(kc, kc2) and torch.equal(vc, vc2)):
                raise AssertionError(f"K2 caches differ after insert at "
                                     f"offset {off} start {start}")
            worst = max(worst, (got.float() - want.float()).abs().max().item())
    tol = TOL[("attn", _dt_name(dtype))]
    log(f"  K2 ring_attn {_dt_name(dtype)}: max_abs_err {worst:.3e} "
        f"(tol {tol}); caches equal after every insert")
    if not worst <= tol:
        raise AssertionError(f"K2 {_dt_name(dtype)} error {worst} > {tol}")
    results.setdefault("ring_attn", {})[_dt_name(dtype)] = worst


def check_k3(dec, cfg, device, dtype, results, weights):
    import torch
    from pocket_tts_tpu_torch.models import seanet
    from pocket_tts_tpu_torch.ops.seanet_frame import seanet_frame
    sc, tpf = cfg.mimi.seanet, cfg.mimi.upsample_stride
    g = torch.Generator(device="cpu").manual_seed(3)
    st_k = seanet.init_state(sc, tpf, dtype, device)
    st_p = seanet.init_state(sc, tpf, dtype, device)
    worst_rel = worst_abs = 0.0
    for f in range(6):
        z = torch.randn(tpf, sc.in_ch, generator=g).to(device, dtype)
        got = seanet_frame(dec, sc, st_k, z, weights)
        new, want = seanet.forward_plain(dec, sc, st_p, z)
        for key in st_p:
            st_p[key].copy_(new[key])
        sync(device)
        scale = max(want.float().abs().max().item(), 1e-30)
        err = (got.float() - want.float()).abs().max().item()
        worst_abs = max(worst_abs, err)
        worst_rel = max(worst_rel, err / scale)
        for key in st_p:
            cs = max(st_p[key].float().abs().max().item(), 1e-30)
            cerr = (st_k[key].float() - st_p[key].float()).abs().max().item()
            worst_rel = max(worst_rel, cerr / cs)
    tol = TOL[("seanet", _dt_name(dtype))]
    log(f"  K3 seanet_frame {_dt_name(dtype)}: 6 frames, max_abs_err "
        f"{worst_abs:.3e}, max error relative to max|plain| (pcm and 8 "
        f"carries) {worst_rel:.3e} (tol {tol})")
    if not worst_rel <= tol:
        raise AssertionError(f"K3 {_dt_name(dtype)} rel error {worst_rel}")
    results.setdefault("seanet_frame", {})[_dt_name(dtype)] = worst_abs


# ---------------------------------------------------------------- phase 4 --

def counted_frame_steps():
    """Wrap models.tts.frame_step to count the frames it decodes."""
    from pocket_tts_tpu_torch.models import tts
    real = tts.frame_step
    count = {"frames": 0}

    def frame_step(p, cfg, state, *args, **kw):
        if not state.done:
            count["frames"] += 1
        return real(p, cfg, state, *args, **kw)

    tts.frame_step = frame_step
    return count


def reset_counters():
    from pocket_tts_tpu_torch.ops.decode_attn import decode_attention
    from pocket_tts_tpu_torch.ops.ring_attn import ring_insert_attention
    from pocket_tts_tpu_torch.ops.seanet_frame import seanet_frame
    for fn in (decode_attention, ring_insert_attention, seanet_frame):
        fn.launches = 0


def read_counters():
    from pocket_tts_tpu_torch.ops.decode_attn import decode_attention
    from pocket_tts_tpu_torch.ops.ring_attn import ring_insert_attention
    from pocket_tts_tpu_torch.ops.seanet_frame import seanet_frame
    return {"decode_attn": decode_attention.launches,
            "ring_attn": ring_insert_attention.launches,
            "seanet_frame": seanet_frame.launches}


def make_engine(cfg, device, dtype, seed=0):
    from pocket_tts_tpu.text.tokenizer import MockTokenizer
    from pocket_tts_tpu_torch.io.params import random_params
    from pocket_tts_tpu_torch.runtime.engine import TTSEngine
    params, cfg = random_params(cfg, seed=0, dtype=dtype, device=device)
    return TTSEngine(params=params, cfg=cfg, dtype=dtype, device=device,
                     seed=seed, tokenizer=MockTokenizer(cfg.lut.n_bins))


def end_to_end(engine, voice, counts, text=BENCH_TEXT):
    frames_before = counts["frames"]
    reset_counters()
    t0 = time.perf_counter()
    pcm = engine.synthesize(text, voice, temp=0.0)
    sync(engine.device)
    wall = time.perf_counter() - t0
    launches = read_counters()
    frames = counts["frames"] - frames_before
    per_frame = {"decode_attn": engine.cfg.backbone.num_layers,
                 "ring_attn": engine.cfg.mimi.transformer.num_layers,
                 "seanet_frame": 1}
    log(f"  bf16 synthesize: {frames} frames decoded, {pcm.size} samples "
        f"({pcm.size / engine.sample_rate:.2f} s of audio), wall {wall:.3f} s "
        f"(includes voice priming and prefill)")
    log(f"  launches {launches}, expected per frame {per_frame}")
    if frames < 1 or pcm.size == 0 or pcm.size % engine.frame_size:
        raise AssertionError(f"bad output length {pcm.size}")
    if not np.isfinite(pcm).all():
        raise AssertionError("non-finite pcm")
    if not np.abs(pcm).max() > 0:
        raise AssertionError("silent pcm")
    for name, n in per_frame.items():
        if launches[name] != n * frames:
            raise AssertionError(f"{name}: {launches[name]} launches for "
                                 f"{frames} frames (want {n} per frame)")
    return launches, frames, pcm


# ---------------------------------------------------------------- phase 5 --

def first_frames(engine, voice, n_frames, text=BENCH_TEXT):
    """pcm of the first n_frames of `text` at temp 0, (n, frame)."""
    import torch
    from pocket_tts_tpu.text.preprocess import prepare_text_prompt
    from pocket_tts_tpu_torch.models import tts
    prepared, _ = prepare_text_prompt(text)
    vstate = engine.prime_voice(voice)
    state, max_steps = engine._prefill_sentence(vstate, prepared)
    zero = torch.zeros(engine.cfg.latent_dim, dtype=engine.dtype,
                       device=engine.device)
    out = []
    with torch.no_grad():
        for _ in range(n_frames):
            pcm, _ = tts.frame_step(engine.params, engine.cfg, state, zero,
                                    10 ** 6, max_steps, engine.seanet_weights)
            out.append(pcm.cpu())
    return torch.stack(out).numpy()


# ---------------------------------------------------------------- phase 6 --

def device_ms(fn, iters, warmup=3):
    """(device ms, host ms) per call of fn. Device time: a sleep kernel
    holds the stream while the host queues `iters` calls, so the CUDA events
    around them time the device work back to back, not the host's launch
    rate. Host time: wall clock per call of a synchronised run."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    host = (time.perf_counter() - t0) / iters
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    # hold the stream ~2x the time the host needs to queue the calls
    torch.cuda._sleep(int(2 * host * iters * 2e9))
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters, host * 1e3


def time_decode(engine, voice, n_frames=100, rounds=5, text=BENCH_TEXT):
    """Frames/s of the frame loop as the engine runs it (one host sync per
    frame for the EOS decision) and of the same frames with the EOS read
    left out (no per-frame sync), in alternating rounds after prefill.
    Returns {"sync": [fps...], "nosync": [fps...]} (host clock around work
    that ends in a synchronize)."""
    import torch
    from pocket_tts_tpu.text.preprocess import prepare_text_prompt
    from pocket_tts_tpu_torch.models import flow_lm, mimi, tts
    prepared, _ = prepare_text_prompt(text)
    vstate = engine.prime_voice(voice)
    p, cfg = engine.params, engine.cfg
    zero = torch.zeros(cfg.latent_dim, dtype=engine.dtype,
                       device=engine.device)
    res = {"sync": [], "nosync": []}
    for mode in ("sync", "nosync") * rounds:
        state, _ = engine._prefill_sentence(vstate, prepared)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.no_grad():
            for _ in range(n_frames):
                if mode == "sync":
                    tts.frame_step(p, cfg, state, zero, 10 ** 6, 10 ** 6,
                                   engine.seanet_weights)
                else:
                    _, lat, _ = flow_lm.decode_step(p, cfg, state.flow,
                                                    state.prev_latent, zero)
                    mimi.decode_frame(p["mimi"], cfg.mimi, state.mimi,
                                      flow_lm.denormalize(p, lat),
                                      cfg.gelu_approx, engine.seanet_weights)
                    state.prev_latent = lat
        torch.cuda.synchronize()
        res[mode].append(n_frames / (time.perf_counter() - t0))
    return res


def time_kernels(engine, device, dtype):
    import torch
    from pocket_tts_tpu_torch.models import seanet
    from pocket_tts_tpu_torch.ops.decode_attn import (decode_attention,
                                                      decode_attention_plain)
    from pocket_tts_tpu_torch.ops.ring_attn import (
        ring_insert_attention, ring_insert_attention_plain)
    from pocket_tts_tpu_torch.ops.seanet_frame import seanet_frame
    g = torch.Generator(device="cpu").manual_seed(4)
    cfg = engine.cfg
    out = {}
    # K1 at the benchmark sentence's bucket: S = 384, ~300 live slots
    h, d, s, end = 16, 64, 384, 300
    k = torch.randn(s, h * d, generator=g).to(device, dtype)
    v = torch.randn(s, h * d, generator=g).to(device, dtype)
    q = torch.randn(h, d, generator=g).to(device, dtype)
    pos = torch.arange(s, dtype=torch.int32)
    pos[end + 1:] = -1
    pos = pos.to(device)
    out["decode_attn"] = (
        device_ms(lambda: decode_attention(q, k, v, pos, end), 200),
        device_ms(lambda: decode_attention_plain(q, k, v, pos, end), 50),
        f"S={s} end={end} H={h} D={d}")
    # K2 at a wrapped ring
    h, d, cap, t = 8, 64, 256, 16
    kc = torch.randn(cap, h * d, generator=g).to(device, dtype)
    vc = torch.randn(cap, h * d, generator=g).to(device, dtype)
    q, kn, vn = (torch.randn(t, h * d, generator=g).to(device, dtype)
                 for _ in range(3))
    ctx = cfg.mimi.transformer.context
    out["ring_attn"] = (
        device_ms(lambda: ring_insert_attention(q, kn, vn, kc, vc, 4096, 0,
                                                h, ctx), 200),
        device_ms(lambda: ring_insert_attention_plain(q, kn, vn, kc, vc,
                                                      4096, 0, h, ctx), 20),
        f"cap={cap} T={t} H={h} D={d} offset=4096")
    # K3: one frame of the full decoder
    sc, tpf = cfg.mimi.seanet, cfg.mimi.upsample_stride
    dec = engine.params["mimi"]["decoder"]
    st = seanet.init_state(sc, tpf, dtype, device)
    z = torch.randn(tpf, sc.in_ch, generator=g).to(device, dtype)
    out["seanet_frame"] = (
        device_ms(lambda: seanet_frame(dec, sc, st, z,
                                       engine.seanet_weights), 30),
        device_ms(lambda: seanet.forward_plain(dec, sc, st, z), 5),
        f"z=({tpf}, {sc.in_ch}) -> {tpf * sc.total_stride} samples")
    return out


def profile_frames(engine, voice, path, n_frames=20):
    """Device time by kernel over n_frames of the frame loop
    (torch.profiler). Returns (device busy us per frame, [(kernel, us per
    frame, calls per frame)] largest first); the table goes to `path`
    when one is given."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from pocket_tts_tpu.text.preprocess import prepare_text_prompt
    from pocket_tts_tpu_torch.models import tts
    prepared, _ = prepare_text_prompt(BENCH_TEXT)
    state, _ = engine._prefill_sentence(engine.prime_voice(voice), prepared)
    zero = torch.zeros(engine.cfg.latent_dim, dtype=engine.dtype,
                       device=engine.device)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with torch.no_grad():
            for _ in range(n_frames):
                tts.frame_step(engine.params, engine.cfg, state, zero,
                               10 ** 6, 10 ** 6, engine.seanet_weights)
        torch.cuda.synchronize()
    ka = prof.key_averages()
    if path:
        with open(path, "w") as f:
            f.write(ka.table(sort_by="self_cuda_time_total", row_limit=60))
    kernels = [(e.key, e.self_device_time_total / n_frames,
                e.count / n_frames)
               for e in ka if e.device_type == DeviceType.CUDA]
    kernels.sort(key=lambda r: -r[1])
    return sum(r[1] for r in kernels), kernels


# ------------------------------------------------------------------- main --

def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description="PyTorch port smoke test on "
                                 "one CUDA GPU")
    ap.add_argument("--out", default=None,
                    help="directory for the nvcc report and profiler table")
    out_dir = ap.parse_args(argv).out
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    root = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(root, "pocket_tts_tpu_torch", "csrc")):
        print("chip_smoke: pocket_tts_tpu_torch/ is not beside the script; "
              "run it from a checkout of the repository", file=sys.stderr)
        return 1
    from pocket_tts_tpu.config import DEFAULT_CONFIG
    from pocket_tts_tpu_torch.io.params import random_voice_prompt
    from pocket_tts_tpu_torch.ops import cuda_lib

    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
    device = torch.device("cuda:0")
    card = nvidia_smi()
    kind = torch.cuda.get_device_name(0)
    phase = "environment"
    try:
        log("[1] environment")
        log(f"  python {sys.version.split()[0]}, torch {torch.__version__}, "
            f"CUDA {torch.version.cuda}, device {kind}, "
            f"count {torch.cuda.device_count()}")
        log(f"  nvidia-smi: {card}")
        log(f"  matmul allow_tf32={torch.backends.cuda.matmul.allow_tf32}")

        phase = "build"
        log("[2] build")
        cuda_lib.library()
        log(f"  kernel library {cuda_lib._state['path']}: "
            f"{cuda_lib.build_seconds():.1f} s to build and load")
        if out_dir:
            with open(os.path.join(out_dir, "nvcc_ptxas.txt"), "w") as f:
                f.write(cuda_lib.build_log())
        for line in cuda_lib.build_log().splitlines():
            if "registers" in line or "spill" in line:
                log("  " + line.strip())

        phase = "kernels"
        log("[3] kernels vs plain versions")
        errs = {}
        engines = {}
        for dtype in (torch.float32, torch.bfloat16):
            check_k1(device, dtype, errs)
            check_k2(device, dtype, errs)
            eng = make_engine(DEFAULT_CONFIG, device, dtype)
            engines[dtype] = eng
            check_k3(eng.params["mimi"]["decoder"], eng.cfg, device, dtype,
                     errs, eng.seanet_weights)

        phase = "end to end"
        log("[4] end to end, DEFAULT_CONFIG, bf16, temp 0")
        counts = counted_frame_steps()
        engine = engines[torch.bfloat16]
        voice = random_voice_prompt(engine.cfg, 120)
        launches, frames, _ = end_to_end(engine, voice, counts)

        phase = "card vs cpu"
        log("[5] end to end, card vs CPU, f32, first 12 frames")
        eng_gpu = engines[torch.float32]
        eng_cpu = make_engine(DEFAULT_CONFIG, "cpu", torch.float32)
        pcm_gpu = first_frames(eng_gpu, voice, 12)
        pcm_cpu = first_frames(eng_cpu, voice, 12)
        scale = float(np.abs(pcm_cpu).max())
        err = float(np.abs(pcm_gpu - pcm_cpu).max())
        tol = TOL[("e2e", "f32")]
        log(f"  max |pcm card - pcm cpu| {err:.3e}, max |pcm| {scale:.3e}, "
            f"relative {err / max(scale, 1e-30):.3e} (tol {tol})")
        if not (np.isfinite(pcm_gpu).all() and scale > 0
                and err <= tol * scale):
            raise AssertionError("card vs CPU pcm differ")
        del eng_cpu

        phase = "timing"
        log(f"[6] timing on {card} (CUDA events, bf16, warm L2)")
        dec = time_decode(engine, voice)
        for mode, runs in dec.items():
            log(f"  decode frames/s [{mode}], 100-frame rounds: "
                + ", ".join(f"{r:.1f}" for r in runs))
        ms_sync = 1e3 / float(np.median(dec["sync"]))
        ms_nosync = 1e3 / float(np.median(dec["nosync"]))
        log(f"  decode (median of rounds): {1e3 / ms_sync:.1f} frames/s with "
            f"the per-frame EOS sync, {1e3 / ms_nosync:.1f} without; sync cost "
            f"{ms_sync - ms_nosync:.3f} ms/frame")
        times = time_kernels(engine, device, torch.bfloat16)
        for name, ((ms, host), (plain_ms, plain_host), shape) in \
                times.items():
            log(f"  {name} ({shape}): kernel {ms * 1e3:.2f} us device, "
                f"{host * 1e3:.2f} us host per call; plain "
                f"{plain_ms * 1e3:.2f} us device, {plain_host * 1e3:.2f} us "
                f"host per call")
        try:
            busy, kern = profile_frames(
                engine, voice,
                os.path.join(out_dir, "profile_frames.txt") if out_dir
                else None)
            log(f"  profiler: device busy {busy:.1f} us per frame in "
                f"{sum(r[2] for r in kern):.0f} kernel launches, "
                f"{1e3 * ms_sync:.1f} us wall per frame: device idle "
                f"{1 - busy / (1e3 * ms_sync):.1%}")
            for key, us, calls in kern[:12]:
                log(f"    {us:9.1f} us/frame  {calls:6.1f} calls/frame  "
                    f"{key[:70]}")
        except Exception as e:  # measurement only: the run stays valid
            log(f"  profiler unavailable: {type(e).__name__}: {e}")
    except Exception:
        import traceback
        traceback.print_exc()
        print(f"chip_smoke: FAILED in phase '{phase}'", file=sys.stderr)
        return 1

    kernels = [dict(name=name, route="cuda", **KERNELS[name],
                    launches=launches[name],
                    max_abs_err=errs[name]["bf16"],
                    ms=times[name][0][0], plain_ms=times[name][1][0])
               for name in KERNELS]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
