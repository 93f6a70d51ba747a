#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU (H100, sm_90a).

    python3 chip_smoke.py [--out DIR]

Drives the port's four solo paths (synthesis through `TTSEngine` with
bf16 weights, and with `quantize="int8"`, `"int4"` and `"q4_0"`) at the
full width of DEFAULT_CONFIG with random weights from seed 0, and checks
the eleven hand-written CUDA kernel entries on them against their plain
PyTorch versions. Phases, in order; any failure raises, names its phase
and the exit code is 1:

  1. environment   torch / CUDA versions, card name and power limit
  2. build         nvcc builds the kernel library (pocket_tts_tpu_torch/csrc)
  3. kernels       K1 decode attention, K2 ring insert + attention, K3 SEANet
                   frame; K4a int8 matmul, K5a/K5b fused layer pre/post and
                   K6 fused flow net on int8 weights; K4b int4 matmul and
                   the int4 K5a/K5b/K6 on per-channel int4 and on q4_0
                   (K-grouped) weights: each vs its plain version at
                   main-path shapes, f32 and bf16, with the tolerances
                   stated below
  4. end to end    synthesis of the benchmark sentence at temp 0 on each
                   path, counters set to 0 before each run and read after:
                   per decoded frame every path launches 6 K1, 2 K2 and 1
                   K3; int8 adds 1 K4a, 8 K5a, 8 K5b, 1 K6 and 24 K4a per
                   prefill call; int4 and q4_0 the same counts of K4b and
                   the int4 K5a/K5b/K6 (counted apart from int8). Then the
                   q4_0 engine is built again from a params cache written
                   and read back here, and must give the same pcm, bit for
                   bit
  5. card vs CPU   12 f32 frames on the card vs the port on the CPU, with
                   bf16, int8, int4 and q4_0 weights
  6. timing        decode frames/s of the four paths in alternating rounds
                   (with and without the per-frame host sync), each
                   kernel's device time vs its plain version's (CUDA
                   events), device busy share and launches per frame of
                   each path (profiler)

The last three lines of standard output are a JSON object of the kernels
(launches from the runs of the path that uses each: K1-K3 from bf16, the
int8 entries from int8, the int4 entries from int4 and q4_0 together),
the card's `nvidia-smi` name and power limit, and the result object
{"ok": true, "device": {...}}. Without a CUDA device the script exits 1
and prints no result. With --out DIR, the longer output (nvcc's register
report, the profiler tables) is also written under DIR.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
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
    # quantized matmul (K4a, K4b) and the fused layer (K5a/K5b), int8 and
    # int4: relative to max |plain|. Kernel and plain version round at the
    # same points (int4 nibbles times group scales are exact in float32 on
    # both sides); in bf16 a float32 sum taken in another order can round
    # one ulp apart (2^-8 of the largest output) at each rounding point,
    # here one or two in a row.
    ("quant", "f32"): 1e-4, ("quant", "bf16"): 1e-2,
    # flow net (K6): relative to max |plain|; bf16 as above, over a chain
    # of ~14 rounding points, each of which can move the next by one ulp
    ("flow", "f32"): 1e-4, ("flow", "bf16"): 3e-2,
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
    "int8_matmul": dict(
        source="pocket_tts_tpu_torch/csrc/int8_matmul.cu",
        replaces="pocket_tts_tpu/ops/quant_matmul.py:118"),
    "fused_pre": dict(
        source="pocket_tts_tpu_torch/csrc/fused_layer.cu",
        replaces="pocket_tts_tpu/ops/fused_layer.py:208"),
    "fused_post": dict(
        source="pocket_tts_tpu_torch/csrc/fused_layer.cu",
        replaces="pocket_tts_tpu/ops/fused_layer.py:576"),
    "fused_flow": dict(
        source="pocket_tts_tpu_torch/csrc/fused_flow.cu",
        replaces="pocket_tts_tpu/ops/fused_flow.py:188"),
    "int4_matmul": dict(
        source="pocket_tts_tpu_torch/csrc/int4_matmul.cu",
        replaces="pocket_tts_tpu/ops/quant_matmul.py:407"),
    "fused_pre_int4": dict(
        source="pocket_tts_tpu_torch/csrc/fused_layer.cu",
        replaces="pocket_tts_tpu/ops/fused_layer.py:208"),
    "fused_post_int4": dict(
        source="pocket_tts_tpu_torch/csrc/fused_layer.cu",
        replaces="pocket_tts_tpu/ops/fused_layer.py:576"),
    "fused_flow_int4": dict(
        source="pocket_tts_tpu_torch/csrc/fused_flow.cu",
        replaces="pocket_tts_tpu/ops/fused_flow.py:188"),
}
# the kernels each path adds to K1-K3, and the paths whose counts the
# kernels line reports for each
PATH_KERNELS = {
    "int8": ("int8_matmul", "fused_pre", "fused_post", "fused_flow"),
    "int4": ("int4_matmul", "fused_pre_int4", "fused_post_int4",
             "fused_flow_int4"),
}
PATH_KERNELS["q4_0"] = PATH_KERNELS["int4"]
QUANT_PATHS = ("int8", "int4", "q4_0")


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


def _rel_check(name, key, dtype, pairs, results, label=""):
    """Largest |kernel - plain| over `pairs`, relative to max |plain| per
    pair, against TOL[(key, dtype)]; records the largest absolute error
    (over every call for `name`)."""
    worst_rel = worst_abs = 0.0
    for got, want in pairs:
        scale = max(want.float().abs().max().item(), 1e-30)
        err = (got.float() - want.float()).abs().max().item()
        if not np.isfinite(got.float().cpu().numpy()).all():
            raise AssertionError(f"{name}: non-finite output")
        worst_abs = max(worst_abs, err)
        worst_rel = max(worst_rel, err / scale)
    tol = TOL[(key, _dt_name(dtype))]
    log(f"  {name}{label} {_dt_name(dtype)}: {len(pairs)} cases, "
        f"max_abs_err {worst_abs:.3e}, relative to max|plain| "
        f"{worst_rel:.3e} (tol {tol})")
    if not worst_rel <= tol:
        raise AssertionError(f"{name}{label} {_dt_name(dtype)} rel error "
                             f"{worst_rel} > {tol}")
    errs = results.setdefault(name, {})
    errs[_dt_name(dtype)] = max(errs.get(_dt_name(dtype), 0.0), worst_abs)


def _rand(rng, device, dtype, *shape, scale=1.0):
    import torch
    return torch.from_numpy((rng.randn(*shape) * scale).astype(
        np.float32)).to(device, dtype)


def _with_biases(p, rng, device, dtype):
    """A copy of layer params p with a random bias on each linear (the
    checkpoint's transformer linears have none; the kernels take them)."""
    out = dict(p)
    for name in ("in_proj", "out_proj", "linear1", "linear2"):
        out[name] = dict(p[name], b=_rand(rng, device, dtype,
                                          p[name]["scale"].shape[-1],
                                          scale=0.1))
    return out


QUANTIZE = {"int8": dict(bits=8), "int4": dict(bits=4),
            "q4_0": dict(bits=4, group=32)}


def quant_matmul_fns(path):
    """(kernel name, wrapper, plain version, weight key) of the matmul
    kernel of a quantized path."""
    from pocket_tts_tpu_torch.ops import quant_matmul as qm
    if path == "int8":
        return "int8_matmul", qm.int8_matmul, qm.int8_matmul_plain, "q"
    return "int4_matmul", qm.int4_matmul, qm.int4_matmul_plain, "q4"


def check_quant_kernels(pq, cfg, device, dtype, results, path):
    """The path's matmul kernel (K4a or K4b), K5a, K5b and K6 vs their
    plain versions at the main path's shapes; pq: the full-width tree
    quantized for `path` (int8, int4 or q4_0) on the card in `dtype`;
    inputs from numpy seed 5. Also the options the main path leaves
    unused: biases on the layer's linears, and a flow net whose input_proj
    and final.linear stay plain (tiny_config(64)). Under q4_0 at full
    width input_linear and the flow net's input_proj (K = 32) keep
    per-channel int4 scales beside grouped ones."""
    from pocket_tts_tpu_torch.config import tiny_config
    from pocket_tts_tpu_torch.io.params import random_params
    from pocket_tts_tpu_torch.io.quant import quantize_params
    from pocket_tts_tpu_torch.ops import fused_flow, fused_layer
    from pocket_tts_tpu_torch.ops.basic import slice_layer_params
    mm_name, mm, mm_plain, key = quant_matmul_fns(path)
    suffix = PATH_KERNELS[path][1][len("fused_pre"):]
    label = f" [{path}]"
    rng = np.random.RandomState(5)
    bb = pq["layers"]
    mt = pq["mimi"]["decoder_transformer"]["layers"]
    if path == "q4_0" and not (
            pq["input_linear"]["scale"].dim() == 1
            and pq["flow_net"]["input_proj"]["scale"].dim() == 1
            and pq["flow_net"]["cond_embed"]["scale"].dim() == 2
            and bb["in_proj"]["scale"].dim() == 3):
        raise AssertionError("q4_0 tree lacks its mixed scale layouts")
    # K4a / K4b: input_linear each frame (T=1, K=32), and prefill buckets
    # through in_proj (K=1024, N=3072), linear1 (N=4096) and linear2
    # (K=4096)
    pairs = []
    cases = [(1, pq["input_linear"])]
    for t in (16, 130):
        for name in ("in_proj", "linear1", "linear2", "out_proj"):
            cases.append((t, slice_layer_params(bb, -1)[name]))
    for t, lin in cases:
        k = lin[key].shape[0] * (2 if key == "q4" else 1)
        x = _rand(rng, device, dtype, t, k, scale=0.5)
        pairs.append((mm(x, lin[key], lin["scale"]),
                      mm_plain(x, lin[key], lin["scale"])))
    sync(device)
    _rel_check(mm_name, "quant", dtype, pairs, results, label)
    # K5a / K5b: backbone T=1 (eps 1e-5; erf and tanh GELU) and mimi T=16
    # (eps 0, layer scales)
    dm, md = cfg.backbone.d_model, cfg.mimi.transformer.d_model
    eps_m = cfg.mimi.transformer.norm_eps
    pre, post = [], []
    for layers, t, d, eps, bias in ((bb, 1, dm, 1e-5, False),
                                    (bb, 1, dm, 1e-5, True),
                                    (mt, 16, md, eps_m, False)):
        for l in (0, layers["in_proj"]["scale"].shape[0] - 1):
            p = slice_layer_params(layers, l)
            if bias:
                p = _with_biases(p, rng, device, dtype)
            if not fused_layer.supported(p):
                raise AssertionError("fused layer route not taken")
            x = _rand(rng, device, dtype, t, d, scale=0.5)
            attn = _rand(rng, device, dtype, t, d, scale=0.5)
            pre.append((fused_layer.pre_attention(p, x, eps),
                        fused_layer.pre_attention_plain(p, x, eps)))
            for approx in (False, True):
                post.append((
                    fused_layer.post_attention(p, x, attn, eps, approx),
                    fused_layer.post_attention_plain(p, x, attn, eps,
                                                     approx)))
    sync(device)
    _rel_check("fused_pre" + suffix, "quant", dtype, pre, results, label)
    _rel_check("fused_post" + suffix, "quant", dtype, post, results, label)
    # K6: the flow net on one conditioning row; then a tiny_config(64) net
    # with plain input_proj / final.linear
    tiny, _ = random_params(tiny_config(64), seed=7, dtype=dtype,
                            device=device)
    tiny = quantize_params(tiny, **QUANTIZE[path])
    if "w" not in tiny["flow_net"]["input_proj"]:
        raise AssertionError("tiny flow net has no plain linear")
    pairs = []
    for tree, n in ((pq, 3), (tiny, 2)):
        fp, tc = tree["flow_net"], tree["_time_cond"]
        if not fused_flow.supported(fp):
            raise AssertionError("fused flow route not taken")
        for _ in range(n):
            c = _rand(rng, device, dtype, tree["out_norm"]["scale"].shape[0])
            x = _rand(rng, device, dtype, tree["bos_emb"].shape[0])
            pairs.append((fused_flow.flow_forward(fp, c, x, tc),
                          fused_flow.flow_forward_plain(fp, c, x, tc)))
    sync(device)
    _rel_check("fused_flow" + suffix, "flow", dtype, pairs, results, label)


# ---------------------------------------------------------------- phase 4 --

def counted_frame_steps():
    """Wrap models.tts.frame_step and models.flow_lm.prefill to count the
    frames decoded and the prefill calls (voice priming and each
    sentence's text) made."""
    from pocket_tts_tpu_torch.models import flow_lm, tts
    real_step, real_prefill = tts.frame_step, flow_lm.prefill
    count = {"frames": 0, "prefills": 0}

    def frame_step(p, cfg, state, *args, **kw):
        if not state.done:
            count["frames"] += 1
        return real_step(p, cfg, state, *args, **kw)

    def prefill(*args, **kw):
        count["prefills"] += 1
        return real_prefill(*args, **kw)

    tts.frame_step = frame_step
    flow_lm.prefill = prefill
    return count


def _counters():
    """{kernel name: (wrapper, attribute of its launch count)}: the fused
    wrappers count int8 launches in `launches` and int4 ones in
    `launches_int4`."""
    from pocket_tts_tpu_torch.ops import fused_flow, fused_layer
    from pocket_tts_tpu_torch.ops.decode_attn import decode_attention
    from pocket_tts_tpu_torch.ops.quant_matmul import (int4_matmul,
                                                       int8_matmul)
    from pocket_tts_tpu_torch.ops.ring_attn import ring_insert_attention
    from pocket_tts_tpu_torch.ops.seanet_frame import seanet_frame
    out = {"decode_attn": (decode_attention, "launches"),
           "ring_attn": (ring_insert_attention, "launches"),
           "seanet_frame": (seanet_frame, "launches"),
           "int8_matmul": (int8_matmul, "launches"),
           "int4_matmul": (int4_matmul, "launches")}
    for name, fn in (("fused_pre", fused_layer.pre_attention),
                     ("fused_post", fused_layer.post_attention),
                     ("fused_flow", fused_flow.flow_forward)):
        out[name] = (fn, "launches")
        out[name + "_int4"] = (fn, "launches_int4")
    return out


def reset_counters():
    for fn, attr in _counters().values():
        setattr(fn, attr, 0)


def read_counters():
    return {name: getattr(fn, attr)
            for name, (fn, attr) in _counters().items()}


def _engine_kw(cfg, device, dtype):
    from pocket_tts_tpu.text.tokenizer import MockTokenizer
    return dict(cfg=cfg, dtype=dtype, device=device, seed=0,
                tokenizer=MockTokenizer(cfg.lut.n_bins))


def make_engine(cfg, device, dtype, quantize=None):
    from pocket_tts_tpu_torch.io.params import random_params
    from pocket_tts_tpu_torch.runtime.engine import TTSEngine
    params, cfg = random_params(cfg, seed=0, dtype=dtype, device=device)
    return TTSEngine(params=params, quantize=quantize,
                     **_engine_kw(cfg, device, dtype))


def expected_launches(cfg, path):
    """(launches per decoded frame, launches per prefill call) by kernel
    for a path: "bf16", "int8", "int4" or "q4_0"."""
    nb, nm = cfg.backbone.num_layers, cfg.mimi.transformer.num_layers
    per_frame = {"decode_attn": nb, "ring_attn": nm, "seanet_frame": 1}
    per_prefill = {}
    if path in PATH_KERNELS:
        mm, pre, post, flow = PATH_KERNELS[path]
        per_frame.update({mm: 1, pre: nb + nm, post: nb + nm, flow: 1})
        per_prefill = {mm: 4 * nb}
    return per_frame, per_prefill


def end_to_end(engine, voice, counts, label, text=BENCH_TEXT):
    """Synthesize `text` at temp 0 on path `label` with the counters set to
    0 just before and read just after; checks the pcm and the launch
    counts."""
    frames0, prefills0 = counts["frames"], counts["prefills"]
    per_frame, per_prefill = expected_launches(engine.cfg, label)
    reset_counters()
    t0 = time.perf_counter()
    pcm = engine.synthesize(text, voice, temp=0.0)
    sync(engine.device)
    wall = time.perf_counter() - t0
    launches = read_counters()
    frames = counts["frames"] - frames0
    prefills = counts["prefills"] - prefills0
    audio_s = pcm.size / engine.sample_rate
    log(f"  {label} synthesize: {frames} frames decoded, {prefills} "
        f"prefill calls, {pcm.size} samples ({audio_s:.2f} s of audio), "
        f"wall {wall:.3f} s (includes voice priming and prefill)")
    log(f"  launches {launches}; expected per frame {per_frame}, per "
        f"prefill call {per_prefill}")
    if frames < 1 or pcm.size == 0 or pcm.size % engine.frame_size:
        raise AssertionError(f"bad output length {pcm.size}")
    if not np.isfinite(pcm).all():
        raise AssertionError("non-finite pcm")
    if not np.abs(pcm).max() > 0:
        raise AssertionError("silent pcm")
    for name in KERNELS:
        want = (per_frame.get(name, 0) * frames
                + per_prefill.get(name, 0) * prefills)
        if launches[name] != want:
            raise AssertionError(
                f"{label} {name}: {launches[name]} launches for {frames} "
                f"frames and {prefills} prefill calls (want {want})")
    return launches, frames, pcm


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        return {p: t for k, v in tree.items()
                for p, t in _leaves(v, f"{prefix}/{k}").items()}
    if isinstance(tree, (tuple, list)):
        return {p: t for i, v in enumerate(tree)
                for p, t in _leaves(v, f"{prefix}/{i}").items()}
    return {prefix: tree}


def check_cache(engine, voice, pcm):
    """Write engine's params to a params cache, build an engine from it
    and check that every tensor comes back equal (dtype, shape, bits) and
    that the benchmark sentence at temp 0 gives `pcm` again, bit for bit.
    The cache goes to a temporary directory (TMPDIR)."""
    import torch
    from pocket_tts_tpu_torch.runtime.engine import TTSEngine
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "params_q4_0.safetensors")
        t0 = time.perf_counter()
        engine.save_params_cache(path)
        size = os.path.getsize(path)
        t1 = time.perf_counter()
        eng2 = TTSEngine.from_params_cache(
            path, **_engine_kw(engine.cfg, engine.device, engine.dtype))
        t2 = time.perf_counter()
    want, got = _leaves(engine.params), _leaves(eng2.params)
    if sorted(want) != sorted(got):
        raise AssertionError("params cache: the tree changed")
    for key, t in want.items():
        u = got[key]
        if not (t.dtype == u.dtype and t.shape == u.shape
                and u.device == t.device
                and torch.equal(t.view(torch.int16) if t.dtype ==
                                torch.bfloat16 else t,
                                u.view(torch.int16) if u.dtype ==
                                torch.bfloat16 else u)):
            raise AssertionError(f"params cache: {key} differs")
    pcm2 = eng2.synthesize(BENCH_TEXT, voice, temp=0.0)
    same = pcm2.shape == pcm.shape and np.array_equal(pcm2, pcm)
    n_bf16 = sum(t.dtype == torch.bfloat16 for t in want.values())
    log(f"  q4_0 params cache: {size / 2**20:.1f} MiB, {len(want)} tensors "
        f"({n_bf16} bf16), written in {t1 - t0:.2f} s, read into an "
        f"engine in {t2 - t1:.2f} s; tensors equal; pcm "
        f"{'equal bit for bit' if same else 'DIFFERS'}")
    if not same:
        raise AssertionError("engine from the params cache: pcm differs")


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


def time_decode(engines, voice, n_frames=100, rounds=3, text=BENCH_TEXT):
    """Frames/s of the frame loop as the engine runs it (one host sync per
    frame for the EOS decision) and of the same frames with the EOS read
    left out (no per-frame sync), after prefill, for each of `engines`
    ({label: engine}) in turns: the order of the engines flips every
    round. Returns {label: {"sync": [fps...], "nosync": [fps...]}} (host
    clock around work that ends in a synchronize)."""
    import torch
    from pocket_tts_tpu.text.preprocess import prepare_text_prompt
    from pocket_tts_tpu_torch.models import flow_lm, mimi, tts
    prepared, _ = prepare_text_prompt(text)
    vstates = {k: e.prime_voice(voice) for k, e in engines.items()}
    res = {k: {"sync": [], "nosync": []} for k in engines}
    labels = list(engines)
    for r in range(rounds):
        for label in (labels if r % 2 == 0 else labels[::-1]):
            engine = engines[label]
            p, cfg = engine.params, engine.cfg
            zero = torch.zeros(cfg.latent_dim, dtype=engine.dtype,
                               device=engine.device)
            for mode in ("sync", "nosync"):
                state, _ = engine._prefill_sentence(vstates[label],
                                                    prepared)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                with torch.no_grad():
                    for _ in range(n_frames):
                        if mode == "sync":
                            tts.frame_step(p, cfg, state, zero, 10 ** 6,
                                           10 ** 6, engine.seanet_weights)
                        else:
                            _, lat, _ = flow_lm.decode_step(
                                p, cfg, state.flow, state.prev_latent, zero)
                            mimi.decode_frame(
                                p["mimi"], cfg.mimi, state.mimi,
                                flow_lm.denormalize(p, lat), cfg.gelu_approx,
                                engine.seanet_weights)
                            state.prev_latent = lat
                torch.cuda.synchronize()
                res[label][mode].append(n_frames
                                        / (time.perf_counter() - t0))
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


def time_quant_kernels(pq, cfg, device, dtype, path, out):
    """Device time of the path's K4a/K4b, K5a, K5b and K6 vs their plain
    versions at the decode step's shapes, appended to out[kernel name] (the
    first row of each name is the one the JSON line reports)."""
    from pocket_tts_tpu_torch.ops import fused_flow, fused_layer
    from pocket_tts_tpu_torch.ops.basic import slice_layer_params
    mm_name, mm, mm_plain, key = quant_matmul_fns(path)
    _, pre, post, flow = PATH_KERNELS[path]
    rng = np.random.RandomState(6)
    dm, md = cfg.backbone.d_model, cfg.mimi.transformer.d_model
    eps_m = cfg.mimi.transformer.norm_eps
    bb = slice_layer_params(pq["layers"], 0)
    mt = slice_layer_params(pq["mimi"]["decoder_transformer"]["layers"], 0)
    rows = {n: out.setdefault(n, []) for n in PATH_KERNELS[path]}
    lin = pq["input_linear"]
    x = _rand(rng, device, dtype, 1, cfg.latent_dim)
    rows[mm_name].append((
        device_ms(lambda: mm(x, lin[key], lin["scale"]), 200),
        device_ms(lambda: mm_plain(x, lin[key], lin["scale"]), 50),
        f"{path} input_linear T=1 K={cfg.latent_dim} N={dm}"))
    lin = bb["in_proj"]
    xp = _rand(rng, device, dtype, 128, dm)
    rows[mm_name].append((
        device_ms(lambda: mm(xp, lin[key], lin["scale"]), 20),
        device_ms(lambda: mm_plain(xp, lin[key], lin["scale"]), 20),
        f"{path} prefill in_proj T=128 K={dm} N={3 * dm}"))
    for p, t, d, eps, name in ((bb, 1, dm, 1e-5, "backbone"),
                               (mt, 16, md, eps_m, "mimi")):
        x = _rand(rng, device, dtype, t, d, scale=0.5)
        attn = _rand(rng, device, dtype, t, d, scale=0.5)
        rows[pre].append((
            device_ms(lambda: fused_layer.pre_attention(p, x, eps), 200),
            device_ms(lambda: fused_layer.pre_attention_plain(p, x, eps),
                      50), f"{path} {name} T={t} dm={d}"))
        rows[post].append((
            device_ms(lambda: fused_layer.post_attention(p, x, attn, eps),
                      200),
            device_ms(lambda: fused_layer.post_attention_plain(p, x, attn,
                                                               eps), 50),
            f"{path} {name} T={t} dm={d}"))
    fp, tc = pq["flow_net"], pq["_time_cond"]
    c = _rand(rng, device, dtype, dm)
    x = _rand(rng, device, dtype, cfg.latent_dim)
    rows[flow].append((
        device_ms(lambda: fused_flow.flow_forward(fp, c, x, tc), 200),
        device_ms(lambda: fused_flow.flow_forward_plain(fp, c, x, tc), 20),
        f"{path} c={dm} x={cfg.latent_dim} dim={cfg.flow.dim} "
        f"depth={cfg.flow.depth}"))
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
    from pocket_tts_tpu_torch.config import DEFAULT_CONFIG
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
        engines = {}   # (path, dtype) -> engine
        for dtype in (torch.float32, torch.bfloat16):
            check_k1(device, dtype, errs)
            check_k2(device, dtype, errs)
            eng = make_engine(DEFAULT_CONFIG, device, dtype)
            engines["bf16", dtype] = eng
            check_k3(eng.params["mimi"]["decoder"], eng.cfg, device, dtype,
                     errs, eng.seanet_weights)
            for path in QUANT_PATHS:
                qeng = make_engine(DEFAULT_CONFIG, device, dtype, path)
                engines[path, dtype] = qeng
                check_quant_kernels(qeng.params, qeng.cfg, device, dtype,
                                    errs, path)

        phase = "end to end"
        log("[4] end to end, DEFAULT_CONFIG, temp 0: bf16, int8, int4, "
            "q4_0")
        counts = counted_frame_steps()
        paths = ("bf16",) + QUANT_PATHS
        engine = engines["bf16", torch.bfloat16]
        voice = random_voice_prompt(engine.cfg, 120)
        runs = {path: end_to_end(engines[path, torch.bfloat16], voice, counts,
                                 path) for path in paths}

        phase = "params cache"
        log("[4b] q4_0 engine again from a params cache")
        check_cache(engines["q4_0", torch.bfloat16], voice, runs["q4_0"][2])

        phase = "card vs cpu"
        log("[5] end to end, card vs CPU, f32, first 12 frames")
        for path in paths:
            eng_cpu = make_engine(DEFAULT_CONFIG, "cpu", torch.float32,
                                  None if path == "bf16" else path)
            pcm_gpu = first_frames(engines[path, torch.float32], voice, 12)
            pcm_cpu = first_frames(eng_cpu, voice, 12)
            del eng_cpu
            scale = float(np.abs(pcm_cpu).max())
            err = float(np.abs(pcm_gpu - pcm_cpu).max())
            tol = TOL[("e2e", "f32")]
            log(f"  {path} weights: max |pcm card - pcm cpu| {err:.3e}, max "
                f"|pcm| {scale:.3e}, relative {err / max(scale, 1e-30):.3e} "
                f"(tol {tol})")
            if not (np.isfinite(pcm_gpu).all() and scale > 0
                    and err <= tol * scale):
                raise AssertionError(f"card vs CPU pcm differ ({path})")
            del engines[path, torch.float32]

        phase = "timing"
        log(f"[6] timing on {card} (CUDA events, bf16, warm L2)")
        bf = {path: engines[path, torch.bfloat16] for path in paths}
        dec = time_decode(bf, voice)
        med = {}
        for label, modes in dec.items():
            for mode, rounds in modes.items():
                log(f"  {label} decode frames/s [{mode}], 100-frame rounds: "
                    + ", ".join(f"{r:.1f}" for r in rounds))
            ms_sync = 1e3 / float(np.median(modes["sync"]))
            ms_nosync = 1e3 / float(np.median(modes["nosync"]))
            med[label] = ms_sync
            log(f"  {label} decode (median of rounds): {1e3 / ms_sync:.1f} "
                f"frames/s with the per-frame EOS sync, "
                f"{1e3 / ms_nosync:.1f} without; sync cost "
                f"{ms_sync - ms_nosync:.3f} ms/frame")
        times = {k: [v] for k, v in time_kernels(engine, device,
                                                  torch.bfloat16).items()}
        for path in QUANT_PATHS:
            time_quant_kernels(bf[path].params, bf[path].cfg, device,
                               torch.bfloat16, path, times)
        for name, rows in times.items():
            for (ms, host), (plain_ms, plain_host), shape in rows:
                log(f"  {name} ({shape}): kernel {ms * 1e3:.2f} us device, "
                    f"{host * 1e3:.2f} us host per call; plain "
                    f"{plain_ms * 1e3:.2f} us device, {plain_host * 1e3:.2f}"
                    f" us host per call")
        for label, eng in bf.items():
            phase = f"timing: profiler, {label}"
            busy, kern = profile_frames(
                eng, voice,
                os.path.join(out_dir, f"profile_frames_{label}.txt")
                if out_dir else None)
            log(f"  {label} profiler: device busy {busy:.1f} us per "
                f"frame in {sum(r[2] for r in kern):.0f} kernel "
                f"launches, {1e3 * med[label]:.1f} us wall per frame: "
                f"device idle {1 - busy / (1e3 * med[label]):.1%}")
            for key, us, calls in kern[:12]:
                log(f"    {us:9.1f} us/frame  {calls:6.1f} calls/frame "
                    f" {key[:70]}")
    except Exception:
        import traceback
        traceback.print_exc()
        print(f"chip_smoke: FAILED in phase '{phase}'", file=sys.stderr)
        return 1

    def path_launches(name):
        users = [p for p in QUANT_PATHS if name in PATH_KERNELS[p]]
        return sum(runs[p][0][name] for p in users or ["bf16"])

    kernels = [dict(name=name, route="cuda", **KERNELS[name],
                    launches=path_launches(name),
                    max_abs_err=errs[name]["bf16"],
                    ms=times[name][0][0][0], plain_ms=times[name][0][1][0])
               for name in KERNELS]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
