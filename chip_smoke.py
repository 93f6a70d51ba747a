#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU (H100, sm_90a).

    python3 chip_smoke.py [--out DIR]
    python3 chip_smoke.py --kernel-times   # K3-K8 times only (two trees)
    python3 chip_smoke.py --cards 4 [--out DIR]   # phases 1, 2 and 12 only
    python3 chip_smoke.py --frame-graphs [--out DIR]  # phases 1, 2 and 13

Drives the port's solo paths (synthesis through `TTSEngine` with bf16
weights, with `quantize="int8"`, `"int4"` and `"q4_0"`, with int4 weights
and the int8 KV cache, `quantize_kv=True`, and slice 6's paths: int8 +
`backbone.use_megalayer`; int4 + int8 KV + megalayer + the int8 mimi ring,
`mimi.transformer.quantize_kv`; int4 + `backbone.use_bilayer`; int8 and
int4 with the SEANet decoder's convs quantized too, `quantize_convs=True`,
which runs no K3) and its continuous-batching server (`ContinuousBatchingServer`, 32 lanes, with
bf16 weights and in the JAX package's serving mode: int4 weights, int8
KV cache, shared prefix, also at 128 lanes and with quantized convs; 4
lanes without the fused insert; and CLI `--serve`), the GGUF checkpoint
and params cache, the CLI's other entry points (--bench --json,
--profile, --batch with FLAC output, --quantize-convs), the A/B runner
(`python -m pocket_tts_tpu_torch.ab`) and the reference-exact mode at the
full width of DEFAULT_CONFIG with random weights from seed 0, and checks the twenty-six hand-written CUDA kernel entries on
them against their plain PyTorch versions; with --cards 4, sharded
serving over NCCL on four cards (phase 12). Phases, in order; any failure
raises, names its phase and the exit code is 1:

  1. environment   torch / CUDA versions, card name and power limit
  2. build         nvcc builds the kernel library (pocket_tts_tpu_torch/csrc)
  3. kernels       K1 decode attention (ends at its chunk boundaries and
                   the last slot of S = 1024, a chunk with no live slot),
                   K2 ring insert + attention (starts that fence whole
                   chunks), K3 SEANet frame (and on tiny_config's narrow
                   decoder); K4a int8 matmul, K5a/K5b
                   fused layer pre/post and K6 fused flow net on int8
                   weights; K4a and K4b int4 matmul (input_linear at 1,
                   2, 15, 16 and 32 rows, the four prefill linears at 1,
                   2, 15, 16, 64, 128, 130 and 256: each of their routes,
                   K4a's warpgroup kernel from 64 rows) and the int4
                   K5a/K5b/K6 on per-channel int4 and on q4_0
                   (K-grouped) weights: each vs its plain version at
                   main-path shapes, f32 and bf16, with the tolerances
                   stated below
  3c. at batch     K7 fused insert + decode attention at S=1024, H*D=1024,
                   B=32 and solo (linear and ring; write slot at 0, at
                   chunk boundaries and at S-1; one invalid lane, one idle
                   lane; with and without statistics), K2 over 32 lanes
                   with distinct starts (each lane equal to the solo call
                   bit for bit), K3 over 2, 5 (last M tiles partly filled)
                   and 32 lanes, f32 and bf16
  3d. serving mode K1 over int8 caches (S=384, end=300 and more); K7 over
                   int8 caches at S=896, K7's cases of 3c (output, cache
                   bytes and scale rows) and with statistics (out, m, l;
                   an idle lane gives 0, -inf, 0);
                   K5a/K5b over 32 backbone rows and 64, 256 and 512 mimi
                   rows (and 15 and 16: both sides of the tensor-core
                   route's R_min) and K6 over 32, 40 and 64 rows, int8,
                   int4 and q4_0; the same three kernels on
                   tiny_config(64)'s narrow widths, and there K5a's and
                   K5b's four row-block products at 1, 2 and 15 rows
                   (the skinny kernel in bf16); f32 and bf16. Then K4a
                   and K4b at the seven quantized convs' shapes
                   (conv_shapes / conv_products), solo and 32 lanes'
                   rows, f32 and bf16: K4a's warpgroup kernel at N = 64
                   and K = 128, K4b's tensor-core kernel at K = 3584 over
                   512 rows, 15360 rows
  3e. slice 6      K8 megalayer on every layer of the int8 and int4 trees,
                   caches of the working type and int8, S=384 with the
                   write slot at 300 and at a tile edge (y, cache rows and
                   scale rows); K5c bilayer on all five layer pairs of the
                   int4 and q4_0 trees; K2-q over an int8 ring of 256 slots,
                   solo and 32 lanes with distinct starts (ring bytes and
                   scales equal, each lane equal to the solo call bit for
                   bit); K1 over 32 lanes, S=1024 and 896, caches of the
                   working type and int8, with and without statistics, an
                   idle lane and then every lane idle (0, -inf, 0), lanes
                   equal to the solo call bit for bit; f32 and bf16
  4. end to end    synthesis of the benchmark sentence at temp 0 on each
                   path, counters set to 0 before each run and read after:
                   per decoded frame every path launches 6 K1, 2 K2 and 1
                   K3; int8 adds 1 K4a, 8 K5a, 8 K5b, 2 K6 and 24 K4a per
                   prefill call (in a prefill call of 64 rows or more on
                   the warpgroup kernel, counted once more under
                   int8_matmul_wgmma); int4 and q4_0 the same counts of
                   K4b and
                   the int4 K5a/K5b/K6 (counted apart from int8); int4 +
                   int8 KV the int4 counts with K1's int8-KV variant in
                   place of K1; int8 + megalayer 6 K8 and 2 K5a, 2 K5b (the
                   mimi layers) and no K1; int4 + int8 KV + megalayer + the
                   int8 mimi ring 6 K8 (int4, int8 KV) and K2-q in place of
                   K2; int4 + bilayer 1 + 2 K5a, 5 K5c, 1 + 2 K5b, 6 K1.
                   Launches of the tensor-core product (rows_mma_kernel:
                   bf16 K5a calls of MMA_ROWS rows or more, the row-block
                   K5b launches) count once more under rows_mma: the
                   mimi layers' K5a solo (2 a frame), every K5a / K5b
                   launch over the lanes in the serving mode; those of
                   the skinny kernel (bf16 below MMA_ROWS rows) under
                   rows_skinny: the backbone's K5a at T = 1 (6 a frame,
                   1 on the bilayer path). K4b's launches (the same
                   kernels) count under int4_matmul only.
                   The quantized-convs paths (int8_convs, int4_convs)
                   launch their counterpart's kernels but no K3, and 7
                   more K4a / K4b a frame (for int8, 5 of them on the
                   warpgroup kernel).
                   Then the q4_0 engine is built again from a params cache
                   written and read back here, and must give the same pcm,
                   bit for bit
  4c. GGUF         an engine loaded from tts_b6369a24.gguf (random_flat
                   seed 0, written by the port) gives the pcm of one
                   loaded from tts_b6369a24.safetensors, bit for bit; CLI
                   --quantize int8 --save-cache x.gguf --gguf-quantize
                   q8_0, then --load-cache x.gguf synthesizes
  5. card vs CPU   12 f32 frames on the card vs the port on the CPU, on
                   each of the ten paths
  6. timing        decode frames/s of the ten paths in alternating rounds
                   (with and without the per-frame host sync; each of slice
                   6's paths beside its 3-call counterpart), each kernel's
                   device time vs its plain version's and the library
                   call's (SDPA for K1, K2, K7 and K1 over lanes; none for
                   the int8 KV variants, beside which SDPA over bf16 caches
                   of the same shape is timed for comparison; none for K8,
                   beside which the 3-call path it replaces is timed, and
                   for K5c, beside K5b then K5a; the library call of K4a
                   is torch._weight_int8pack_mm; CUDA events) beside its
                   bound; K1, K7 and K2 at every split count
                   (time_splits); each of K3's conv-GEMMs at every tile
                   and split (time_k3_plans); each of K3's 14 launches solo
                   and at 32 lanes beside torch.matmul at its (M, N, K);
                   each K5a / K5b product over many rows on rows_kernel and
                   on rows_mma_kernel at every tile and split
                   (time_rows_plans: R_min and rows_plan); K4a's
                   warpgroup kernel at every tile height and split beside
                   rows_mma_kernel, the dense bf16 product and the
                   library call on the four prefill linears at 64, 128
                   and 256 rows (time_k4a_plans: wgmma_plan and
                   WGMMA_ROWS); K6 on clusters of 16 and 8 blocks
                   (time_flow_clusters); K4a / K4b at each quantized
                   conv, solo and 32 lanes, beside the plain version,
                   the library call, the dense bf16 product and the
                   bound, and their sums over a frame
                   (time_conv_kernels)
  7. serving       f32, 4 lanes, 6 requests (two admitted mid-decode), each
                   pcm vs the solo engine on the card, with bf16 weights,
                   with int8 weights + int8 KV + shared prefix, and with
                   int8 weights + int8 KV + shared prefix + the int8 mimi
                   ring without the fused insert (counters read: per batch
                   frame step 6 K1 over lanes with statistics, 2 K2-q, no
                   K7); 32 lanes, 48 requests, counters set to 0 before and
                   read after, with bf16 weights (per batch frame step 6 K7,
                   2 K2, 1 K3, no K1) and in the serving mode (per step 6
                   K7 int8 with statistics, 2 K2, 1 K3, 0 K1, 2 K6 over
                   the 32 rows, 8 K5a and 24 K5b launches over the lanes'
                   rows, 1 K4b, and 24 K4b per admission prefill);
                   aggregate frames/s, TTFA p50/p95; CLI --serve writes one
                   wav per request, and so does CLI --serve --quantize int4
                   --quantize-kv --share-prefix; f32, 32 lanes, the 6
                   requests in the serving mode with quantized convs vs
                   solo (per step 7 more K4b and no K3)
  8. profiler      device busy share and launches per frame of each solo
                   path (6 K1, 0 on the megalayer paths, 2 K2 and 14 K3
                   launches a frame, no memset, no more launches than
                   FRAME_LAUNCHES) and per chunk of
                   serving with every lane busy, in both serving modes
                   and in the serving mode with quantized convs
                   (torch.profiler after 2 warm-up steps; last, after
                   every host-clock measurement), the launch counters over
                   the same frames and chunks beside the profiler's
                   records by kernel family (launch_crosscheck)
  9. command line  the CLI in subprocesses on the card: --bench --json
                   with bf16 and int8 weights (the JAX CLI's keys;
                   frames/s, RTF, ttfa_ms), the CLI's stream loop on each
                   solo path's warm engine in process (the same three
                   numbers without the process's start-up), hbm_bw_util
                   and mfu of each
                   solo path's phase-6 frames/s (utils/roofline.py at the
                   card's published peaks), --profile (the Chrome trace
                   names K1, K2 and K3's kernels), --batch 4 --json -o
                   .flac --out-rate 16000 (read back at 16 kHz), each
                   with --quantize-convs once more (--bench int8,
                   --batch int4, --serve in the serving mode); ab on a
                   tiny release-layout fixture, card vs CPU (check_ab);
                   the
                   reference-exact mode in process, f32 and int8 weights:
                   18 f32 frames (past the 250-slot mimi ring's wrap) on
                   the card vs the CPU within 1e-3, no
                   K1/K2/K7/K8/K5 launch, one K3 sequence a frame, K4a on
                   every linear (expected_exact); the serving mode at 128
                   lanes: f32 vs the solo engine (launches checked), CLI
                   --serve --lanes 128, and the wall per chunk with all 128
                   lanes busy (reported)
 10. dormant       the modules a checkpoint switches on (random weights,
     modules       seed 0, the extra weights from RandomState(0)): the
                   native library built from the repo's source (its
                   splitter equals StrProcessor on BENCH_TEXT in
                   15-character chunks; a FIFO round trip); K4a / K4b at
                   the SEANet encoder's four quantized convs
                   (encoder_conv_shapes) and the gating linears, f32 and
                   bf16, vs plain, routes logged; "gated_rms" (SwiGLU
                   gating of hidden 1024 and RMSNorm alphas in the mimi
                   layers) through TTSEngine.synthesize and "cross"
                   (cross-attention in the backbone and mimi layers over a
                   64-row conditioning, driven frame by frame), bf16 and
                   int8, launches checked per frame (gated_rms: 2 K2 and
                   no K5a/K5b in mimi; cross: 6 K1 and no K7, K8, K5a,
                   K5b, K5c); both paths card f32 vs CPU f32 over 12
                   frames within 1e-3; one weights-per-step gating (M = 4,
                   a schedule) card vs CPU; the encoder over 48 000
                   samples: 25 calls of 1920 vs one call, card vs CPU,
                   bf16 vs f32, int8 and int4 (convs) vs CPU; frames/s,
                   launches and device busy a frame of the four paths
                   beside bf16 (reported, not claimed), and K4's times at
                   the encoder shapes beside plain, library and bound
 11. mesh          sharded serving on 4 ranks (data 2 x model 2) that
                   share the one card over gloo (parallel.launch; NCCL
                   refuses two ranks on one device), loading the library
                   phase 2 built: K1 over lanes with statistics (working
                   type and int8), K7 int8 with statistics, K2 and K2-q
                   at one rank's shapes (8 backbone heads, 4 mimi heads,
                   16 lanes) vs plain, f32 and bf16, and their times
                   beside plain, library and bound; (f) K4a (int8) and
                   K4b (int4, q4_0) at one rank's shapes
                   (mesh_k4_shapes: in_proj / linear1 column shards,
                   the whole out_proj / linear2, the flow net's linears)
                   over 2, 16 and 256 rows vs plain, f32 and bf16, and
                   their bf16 times beside plain, library and bound; at
                   DEFAULT_CONFIG,
                   temp 0: (a) BatchedEngine(mesh=) over 4 streams, f32,
                   each to its sentence's frame budget, vs the unsharded
                   port on the card within 1e-3 of max |pcm|; (b) ContinuousBatchingServer(mesh=)
                   with 4 lanes, the int8 KV cache, the int8 mimi ring and
                   the shared prefix, 6 requests (two admitted
                   mid-decode) vs the unsharded server, f32 within 2e-3;
                   (c) the same in bf16 within 2^-6 of the peak, two to
                   four bf16 ulps there (MESH_BF16_TOL); (e) each rank's counters per batch
                   frame step: 6 K7-q with statistics, 2 K2-q, 1 K3, no
                   K1, and without the fused insert 6 K1 over lanes with
                   statistics; 3 all-reduces a layer, 3 all-gathers a
                   chunk; (g) the serving mode on the mesh: (c) with
                   int4 weights, each rank's K4b calls derived from the
                   tree (mesh_k4_calls), no K5a / K5b / K5c / K8 / K6, a
                   max and two gathers a layer; (h) BatchedEngine(mesh=)
                   with int8 weights, f32, within 1e-3 of max |pcm|, its
                   K4a calls as derived; every rank's audio equal bit for
                   bit; (i) dryrun_multichip(4, "cuda", backend="gloo");
                   wall per step beside the unsharded server's
 12. mesh over     only with --cards 4 (which runs phases 1, 2 and 12 and
     NCCL          fails in phase 1 with fewer cards): NCCL ranks, one a
                   card (parallel.launch.RankGroup's default on "cuda"),
                   each subgroup warmed by one collective first; (a) K1
                   over lanes with statistics, K7 with statistics
                   (working type and int8), K2 and K2-q at one rank's
                   shapes on a model-4 mesh (4 backbone heads, 2 mimi
                   heads, 32 lanes), K3 over 8 and 32 lanes, K4a / K4b at
                   mesh_k4_shapes(model=4) over 2, 16, 32 and 256 rows,
                   vs plain, f32 and bf16, and their bf16 times; the
                   unsharded references on card 0; (b) phase 11's runs
                   (a, b, c, e, g, h) on a 2 x 2 mesh with phase 11's
                   tolerances and checks; (c) the serving mode (int4
                   weights, int8 KV, int8 mimi ring, shared prefix, bf16)
                   on 1 x 4 and 4 x 1 with 32 lanes and phase 7's 48
                   requests, and f32 float weights on 1 x 4, each vs the
                   one-card server with the same checks; (d) the serving
                   mode on 4 x 1 at 128 lanes (128 long requests) vs one
                   card; the serving mode on a 1 x 1 mesh (the mesh's
                   route, no fused kernel, on one card); (e)
                   dryrun_multichip(4, "cuda") on NCCL. Each group first
                   times one collective of each kind at its ranks' shapes
                   (CUDA events, back to back after a barrier); each run
                   of b-d reports its wall, frames/s, peak memory a rank,
                   collectives a step and, after it, a steady window:
                   wall a chunk, device busy without NCCL, kernels a chunk
                   and NCCL kernel time (torch.profiler) on every rank,
                   beside one card
 13. frame graphs  only with --frame-graphs (phases 1, 2 and 13): the
                   lane frame from CUDA graphs (models/frame_graph.py)
                   against the eager frame at 256 lanes, int4 + int8 KV +
                   int8 Mimi ring + shared prefix and bf16, 50 frames
                   through a 48-slot backbone ring, admissions at the
                   first three chunks: latents and PCM equal bit for bit,
                   ptt.frame spans "capture" then "replay", 6 K7 and 2 K2
                   launches a frame; host ms of a frame's call and ms of
                   a synchronized chunk on both paths, segments a frame

The last three lines of standard output are a JSON object of the kernels
(launches from the runs of the path that uses each: K1-K3 from bf16, the
int8 entries from int8, the int4 entries from int4 and q4_0 together, K1's
int8-KV variant from int4 + int8 KV, K7 from the bf16 serving run, the
serving mode's entries (K7 int8 / statistics, K5a/K5b/K6 over lanes) from
its serving run, K8 from int8 + megalayer and (int4, int8 KV) from int4 +
int8 KV + megalayer, K2-q from the same, K5c from int4 + bilayer, K1 over
lanes from the 4-lane serving run without the fused insert),
the card's `nvidia-smi` name and power limit, and the result object
{"ok": true, "device": {...}}. Without a CUDA device the script exits 1
and prints no result. With --out DIR, the longer output (nvcc's register
report, the profiler tables, and a copy of the log as chip_smoke.log) is
also written under DIR, K1's and K2's registers, shared memory and
spills in ptxas_k1_k2.txt, K3's and K7's in ptxas_k3_k7.txt.
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
    # the megalayer (K8): relative to max |plain|; a chain of ~8 rounding
    # points in bf16 (ln1, q/k/v, rope, softmax weights, attn, ln2, h, y);
    # its int8 K/V bytes may quantize one step apart where a value lies
    # within an ulp of an int8 rounding boundary (checked: at most one
    # step, on few bytes)
    ("mega", "f32"): 1e-4, ("mega", "bf16"): 3e-2,
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
    # K4a: below WGMMA_ROWS rows and in float32 the row-block product of
    # its route (skinny_kernel, rows_mma_kernel, rows_kernel) with the load
    # prologue; from WGMMA_ROWS rows in bf16 the warpgroup kernel
    "int8_matmul": dict(
        source="pocket_tts_tpu_torch/csrc/fused_layer.cu",
        replaces="pocket_tts_tpu/ops/quant_matmul.py:118"),
    "int8_matmul_wgmma": dict(
        source="pocket_tts_tpu_torch/csrc/wgmma_matmul.cu",
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
    # K4b: the row-block product of its route (rows_mma_kernel,
    # skinny_kernel, rows_kernel) with the load prologue
    "int4_matmul": dict(
        source="pocket_tts_tpu_torch/csrc/fused_layer.cu",
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
    "decode_insert_attn": dict(
        source="pocket_tts_tpu_torch/csrc/insert_attn.cu",
        replaces="pocket_tts_tpu/ops/pallas_attn.py:809"),
    # the reference's serving mode: int8 KV cache, shared prefix, quantized
    # weights at batch
    "decode_attn_kv8": dict(
        source="pocket_tts_tpu_torch/csrc/decode_attn.cu",
        replaces="pocket_tts_tpu/ops/pallas_attn.py:332"),
    "decode_insert_attn_kv8": dict(
        source="pocket_tts_tpu_torch/csrc/insert_attn.cu",
        replaces="pocket_tts_tpu/ops/pallas_attn.py:809"),
    "decode_insert_attn_stats": dict(
        source="pocket_tts_tpu_torch/csrc/insert_attn.cu",
        replaces="pocket_tts_tpu/ops/pallas_attn.py:809"),
    "fused_pre_lanes": dict(
        source="pocket_tts_tpu_torch/csrc/fused_layer.cu",
        replaces="pocket_tts_tpu/ops/fused_layer.py:208"),
    "fused_post_lanes": dict(
        source="pocket_tts_tpu_torch/csrc/fused_layer.cu",
        replaces="pocket_tts_tpu/ops/fused_layer.py:576"),
    "fused_flow_lanes": dict(
        source="pocket_tts_tpu_torch/csrc/fused_flow.cu",
        replaces="pocket_tts_tpu/ops/fused_flow.py:188"),
    # slice 6: the whole-layer megakernel (int8 and int4 weights, and its
    # int8-KV variant), the bilayer, the int8 mimi ring, K1 over lanes
    "megalayer": dict(
        source="pocket_tts_tpu_torch/csrc/megalayer.cu",
        replaces="pocket_tts_tpu/ops/fused_step.py:454"),
    "megalayer_int4": dict(
        source="pocket_tts_tpu_torch/csrc/megalayer.cu",
        replaces="pocket_tts_tpu/ops/fused_step.py:454"),
    "megalayer_kv8": dict(
        source="pocket_tts_tpu_torch/csrc/megalayer.cu",
        replaces="pocket_tts_tpu/ops/fused_step.py:454"),
    "bilayer": dict(
        source="pocket_tts_tpu_torch/csrc/fused_layer.cu",
        replaces="pocket_tts_tpu/ops/fused_layer.py:750"),
    "ring_attn_kv8": dict(
        source="pocket_tts_tpu_torch/csrc/ring_attn.cu",
        replaces="pocket_tts_tpu/ops/pallas_mimi.py:324"),
    "decode_attn_lanes": dict(
        source="pocket_tts_tpu_torch/csrc/decode_attn.cu",
        replaces="pocket_tts_tpu/ops/pallas_attn.py:332"),
    "decode_attn_stats": dict(
        source="pocket_tts_tpu_torch/csrc/decode_attn.cu",
        replaces="pocket_tts_tpu/ops/pallas_attn.py:332"),
}
# the kernels whose launches the kernels line reports from the bf16 serving
# run (phase 7, slice 4's path), and from the serving run in the reference's
# serving mode (int4 weights, int8 KV, shared prefix; slice 5's path)
SERVING_KERNELS = ("decode_insert_attn",)
SERVING_KV8_KERNELS = ("decode_insert_attn_kv8", "decode_insert_attn_stats",
                       "fused_pre_lanes", "fused_post_lanes",
                       "fused_flow_lanes")
# the kernels each path adds to K1-K3, and the paths whose counts the
# kernels line reports for each
PATH_KERNELS = {
    "int8": ("int8_matmul", "fused_pre", "fused_post", "fused_flow"),
    "int4": ("int4_matmul", "fused_pre_int4", "fused_post_int4",
             "fused_flow_int4"),
}
PATH_KERNELS["q4_0"] = PATH_KERNELS["int4"]
QUANT_PATHS = ("int8", "int4", "q4_0")
# solo paths with the int8 KV cache: (weights, quantize_kv)
KV8_PATH = "int4_kv8"
# slice 6's solo paths: the megalayer (int8; int4 + int8 KV + the int8 mimi
# ring) and the bilayer (int4), each timed beside its 3-call counterpart
MEGA_PATHS = ("int8_mega", "int4_kv8_mega", "int4_bilayer")
COUNTERPART = {"int8_mega": "int8", "int4_kv8_mega": KV8_PATH,
               "int4_bilayer": "int4"}
# slice 6's solo kernels and the path whose run the kernels line reports
MEGA_KERNELS = {"megalayer": "int8_mega", "megalayer_int4": "int4_kv8_mega",
                "megalayer_kv8": "int4_kv8_mega",
                "ring_attn_kv8": "int4_kv8_mega", "bilayer": "int4_bilayer"}
# the f32 serving check of batched decode without the fused insert: int8
# weights + int8 KV + shared prefix + the int8 mimi ring, K1 over lanes
K1_SERVE = "int8_kv8_k1"
# the quantized-convs solo paths: quantized linears with the SEANet
# decoder's large convs quantized too (quantize_convs): no K3, its chain with
# each quantized conv one launch of K4a (int8) or K4b (int4) a frame over
# all rows, each timed beside its counterpart without quantized convs; and
# the serving mode (int4 weights, int8 KV, shared prefix) with them
CONV_PATHS = ("int8_convs", "int4_convs")
CONV_COUNTERPART = {"int8_convs": "int8", "int4_convs": "int4"}
SERVE_CONVS = "int4_kv8_convs"
ENGINE_KW = {"bf16": dict(), "int8": dict(quantize="int8"),
             "int4": dict(quantize="int4"), "q4_0": dict(quantize="q4_0"),
             KV8_PATH: dict(quantize="int4", quantize_kv=True),
             "int8_kv8": dict(quantize="int8", quantize_kv=True),
             "int8_mega": dict(quantize="int8"),
             "int4_kv8_mega": dict(quantize="int4", quantize_kv=True),
             "int4_bilayer": dict(quantize="int4"),
             K1_SERVE: dict(quantize="int8", quantize_kv=True),
             "exact": dict(), "int8_exact": dict(quantize="int8"),
             "int8_convs": dict(quantize="int8", quantize_convs=True),
             "int4_convs": dict(quantize="int4", quantize_convs=True),
             SERVE_CONVS: dict(quantize="int4", quantize_kv=True,
                               quantize_convs=True)}
# phase 9's reference-exact paths (reference_exact_config: the plain
# attention routes, no K1/K2/K7/K8/K5), f32 and int8 weights
EXACT_PATHS = ("exact", "int8_exact")
# frames of the reference-exact check: 16 mimi steps a frame, so 18 frames
# (288 steps) run past the 250-slot ring's wrap, which falls inside frame
# 16's block and takes the row-scatter insert
EXACT_FRAMES = 18
# the cfg changes of a path: backbone fields, and the mimi ring's
# quantize_kv
PATH_CFG = {"int8_mega": dict(use_megalayer=True, fuse_insert=True),
            "int4_kv8_mega": dict(use_megalayer=True, fuse_insert=True,
                                  mimi_kv8=True),
            "int4_bilayer": dict(use_bilayer=True),
            K1_SERVE: dict(fuse_insert=False, mimi_kv8=True)}


def path_cfg(cfg, path):
    """cfg with the options of `path` (PATH_CFG) set; the reference-exact
    mode for EXACT_PATHS."""
    import dataclasses
    if path in EXACT_PATHS:
        from pocket_tts_tpu_torch.config import reference_exact_config
        cfg = reference_exact_config(cfg)
    ch = dict(PATH_CFG.get(path, {}))
    mimi_kv8 = ch.pop("mimi_kv8", False)
    cfg = dataclasses.replace(cfg, backbone=dataclasses.replace(
        cfg.backbone, **ch))
    if mimi_kv8:
        cfg = dataclasses.replace(cfg, mimi=dataclasses.replace(
            cfg.mimi, transformer=dataclasses.replace(
                cfg.mimi.transformer, quantize_kv=True)))
    return cfg


_T0 = time.perf_counter()
# with --out DIR: a copy of every log line (the standard output's end may be
# all a caller gets back)
_LOG = []


def log(*args):
    print(*args, flush=True)
    for f in _LOG:
        print(*args, file=f, flush=True)


def header(text):
    """A phase's first line, with the seconds since the script started."""
    log(f"{text} [{time.perf_counter() - _T0:.1f} s]")


def nvidia_smi() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    return res.stdout.strip().splitlines()[0] if res.returncode == 0 else \
        f"nvidia-smi failed: {res.stderr.strip()}"


def kernel_ptxas(build_log, names=("decode_attn_kernel", "ring_attn_kernel")):
    """nvcc -Xptxas -v's registers, shared memory and spills of each
    instantiation of the named kernels: ["mangled name: Used ... | stack,
    spills"]."""
    rows, fn, spill = [], None, ""
    for line in build_log.splitlines():
        if "Compiling entry function" in line:
            fn = line.split("'")[1] if "'" in line else None
        elif "spill" in line:
            spill = line.strip()
        elif "Used" in line and "registers" in line and fn and any(
                n in fn for n in names):
            rows.append(f"{fn}: {line.split(':', 1)[1].strip()} | {spill}")
            fn = None
    return rows


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
    from pocket_tts_tpu_torch.ops.decode_attn import (K1_UNIT, chunk_units,
                                                      k1_split)
    h, d = 16, 64
    g = torch.Generator(device="cpu").manual_seed(1)
    worst = 0.0
    for s in (128, 384, 1024):
        k = torch.randn(s, h * d, generator=g).to(device, dtype)
        v = torch.randn(s, h * d, generator=g).to(device, dtype)
        q = torch.randn(h, d, generator=g).to(device, dtype)
        # ends where the chunk count changes (every 32 slots) and where
        # chunk boundaries fall, and the last slot of S
        ends = {0, 31, 32, 33, 127, 128, 255, 256, 300, 301, s - 1}
        for end in sorted(ends & set(range(s))):
            n = k1_split(end, s)
            for hole in ("holes", "chunk"):
                pos = torch.arange(s, dtype=torch.int32)
                pos[end + 1:] = -1
                if hole == "holes" and end > 20:
                    pos[3:9] = -1
                if hole == "chunk":   # one chunk with no live slot
                    if n < 3:
                        continue
                    for lo, hi in chunk_units(2, n, end + 1, K1_UNIT):
                        pos[lo:hi] = -1
                pos = pos.to(device)
                got = decode_attention(q, k, v, pos, end)
                want = decode_attention_plain(q, k, v, pos, end)
                sync(device)
                if not torch.isfinite(got.float()).all():
                    raise AssertionError(f"K1 non-finite at end {end}")
                err = (got.float() - want.float()).abs().max().item()
                worst = max(worst, err)
    tol = TOL[("attn", _dt_name(dtype))]
    log(f"  K1 decode_attn {_dt_name(dtype)}: S 128/384/1024, ends at "
        f"chunk boundaries and the last slot, a chunk masked whole: "
        f"max_abs_err {worst:.3e} (tol {tol})")
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
        # starts past 0 fence old slots; off - 48 and off leave whole
        # chunks with no visible key
        for start in sorted({0, 32, max(off - 48, 0), off}):
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
    log(f"  K2 ring_attn {_dt_name(dtype)}: offsets 0-4096, starts that "
        f"fence whole chunks: max_abs_err {worst:.3e} (tol {tol}); caches "
        "equal after every insert")
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
    check_k3_narrow(device, dtype)


def check_k3_narrow(device, dtype):
    """K3 on tiny_config's decoder (4 to 32 channels: no 16-byte vector
    holds a whole row of the narrow stages, so the kernels take their
    value-at-a-time paths) solo and over 3 lanes, 3 frames each, pcm and
    carries against the plain chain."""
    import torch
    from pocket_tts_tpu_torch.config import tiny_config
    from pocket_tts_tpu_torch.io.params import random_params
    from pocket_tts_tpu_torch.models import seanet
    from pocket_tts_tpu_torch.ops.seanet_frame import (prep_weights,
                                                       seanet_frame)
    p, cfg = random_params(tiny_config(), seed=5, dtype=dtype, device=device)
    dec, sc, tpf = p["mimi"]["decoder"], cfg.mimi.seanet, \
        cfg.mimi.upsample_stride
    weights = prep_weights(dec, sc)
    g = torch.Generator(device="cpu").manual_seed(10)
    worst = 0.0
    for nb in (1, 3):
        st_k = seanet.init_state(sc, tpf, dtype, device)
        if nb > 1:
            st_k = {k: v[None].repeat(nb, *([1] * v.dim())).contiguous()
                    for k, v in st_k.items()}
        st_p = {k: v.clone() for k, v in st_k.items()}
        for _ in range(3):
            z = torch.randn(*((nb,) if nb > 1 else ()), tpf, sc.in_ch,
                            generator=g).to(device, dtype)
            got = seanet_frame(dec, sc, st_k, z, weights)
            new, want = seanet.forward_plain(dec, sc, st_p, z)
            for key in st_p:
                st_p[key].copy_(new[key])
            sync(device)
            for a, b in [(got, want)] + [(st_k[k], st_p[k]) for k in st_p]:
                scale = max(b.float().abs().max().item(), 1e-30)
                worst = max(worst, (a.float() - b.float()).abs().max()
                            .item() / scale)
    tol = TOL[("seanet", _dt_name(dtype))]
    log(f"  K3 seanet_frame narrow {_dt_name(dtype)}: tiny_config, B=1 and "
        f"3, 3 frames each, relative (pcm and 8 carries) {worst:.3e} (tol "
        f"{tol})")
    if not worst <= tol:
        raise AssertionError(f"K3 narrow {_dt_name(dtype)} rel error {worst}")


# --------------------------------------------------------------- phase 3c --

LANES = 32  # the continuous server's default lane count
# the lanes held against the solo call bit for bit (2 and 3 have whole
# chunks fenced off in K2's checks)
SOLO_LANES = (0, 1, 2, 3, LANES - 1)


def k7_case(g, device, dtype, mode, b=LANES, s=1024, h=16, d=64, ws=None):
    """Inputs of one K7 call at the serving shapes: (q, k_new, v_new,
    cur_pos, k_cache, v_cache, pos, read_end, write_slot). linear: lanes
    hold 1..S live slots below the write slot (700 unless given), which is
    the read extent; ring: every slot is live, the write slot (300 unless
    given) holds a stale row whose position was overwritten, and every
    slot is read; lane 1 carries an invalid new row (cur_pos = -1) in
    both."""
    import torch
    hd = h * d
    if ws is None:
        ws = 700 if mode == "linear" else 300
    read_end = ws if mode == "linear" else s - 1
    kc = torch.randn(b, s, hd, generator=g).to(device, dtype)
    vc = torch.randn(b, s, hd, generator=g).to(device, dtype)
    q = torch.randn(b, h, d, generator=g).to(device, dtype)
    kn = torch.randn(b, 1, hd, generator=g).to(device, dtype)
    vn = torch.randn(b, 1, hd, generator=g).to(device, dtype)
    pos = torch.arange(s, dtype=torch.int32).repeat(b, 1) + 5000
    if mode == "linear":
        pos[:, ws + 1:] = -1
        for i in range(b):       # lanes of different lengths, with holes
            pos[i, : (i * 37) % max(ws, 1)] = -1
    pos[::3, 40:60] = -1         # padding rows of short prompts/texts
    cur = pos[:, ws] + 10 ** 6
    if b > 1:
        cur[1] = -1
    pos[:, ws] = cur
    return (q, kn, vn, cur.to(device), kc, vc, pos.to(device), read_end,
            ws)


# K7's cases (mode, lanes, write slot; None: k7_case's): the serving shapes,
# write slots at 0, at chunk boundaries (units of 8 slots) and at S - 1
# (ring: every slot read; linear: read_end the last slot), and the solo
# call of `--fuse-insert` (B = 1)
K7_CASES = (("linear", LANES, None), ("ring", LANES, None),
            ("ring", LANES, 0), ("ring", LANES, 8), ("ring", LANES, 512),
            ("ring", LANES, -1), ("linear", LANES, -1), ("linear", 1, None),
            ("ring", 1, None), ("ring", 1, 64))
K7_IDLE = 3   # a lane with no attended slot (B > 1)


def _k7_idle_check(name, got, stats, b):
    """An idle lane gives out 0 (and m = -inf, l = 0)."""
    import torch
    if b <= K7_IDLE:
        return
    out = got[0] if stats else got
    ok = bool((out[K7_IDLE] == 0).all())
    if stats:
        ok = ok and bool(torch.isneginf(got[1][K7_IDLE]).all()
                         and (got[2][K7_IDLE] == 0).all())
    if not ok:
        raise AssertionError(f"{name}: the idle lane is not (0, -inf, 0)")


def check_k7(device, dtype, results):
    """K7 over caches of the working type vs its plain version, each case
    of K7_CASES with and without statistics, lane K7_IDLE idle: output (m
    and l), and the caches after the insert."""
    import torch
    from pocket_tts_tpu_torch.ops.insert_attn import (
        decode_insert_attention, decode_insert_attention_plain)
    g = torch.Generator(device="cpu").manual_seed(7)
    worst = 0.0
    for mode, b, ws in K7_CASES:
        s = 1024
        q, kn, vn, cur, kc, vc, pos, re_, ws = k7_case(
            g, device, dtype, mode, b, s, ws=None if ws is None else ws % s)
        if b > K7_IDLE:
            pos[K7_IDLE] = -1
            cur[K7_IDLE] = -1
        for stats in (False, True):
            kc2, vc2, kc3, vc3 = kc.clone(), vc.clone(), kc.clone(), vc.clone()
            got = decode_insert_attention(q, kn, vn, cur, kc2, vc2, pos, re_,
                                          ws, stats=stats)
            want = decode_insert_attention_plain(q, kn, vn, cur, kc3, vc3,
                                                 pos, re_, ws, stats=stats)
            sync(device)
            label = f"{mode} B={b} ws={ws}{' stats' if stats else ''}"
            if not (torch.equal(kc2, kc3) and torch.equal(vc2, vc3)):
                raise AssertionError(f"K7 caches differ after insert "
                                     f"({label})")
            out, ref = (got[0], want[0]) if stats else (got, want)
            if not torch.isfinite(out.float()).all():
                raise AssertionError(f"K7 non-finite output ({label})")
            _k7_idle_check(f"K7 {label}", got, stats, b)
            err = (out.float() - ref.float()).abs().max().item()
            if stats:
                live = torch.isfinite(want[1])
                if not torch.equal(live, torch.isfinite(got[1])):
                    raise AssertionError(f"K7 m masks differ ({label})")
                err = max(err, (got[1][live] - want[1][live]).abs().max()
                          .item(), ((got[2][live] - want[2][live]).abs()
                                    / want[2][live]).max().item())
            worst = max(worst, err)
    tol = TOL[("attn", _dt_name(dtype))]
    log(f"  K7 decode_insert_attn {_dt_name(dtype)}: S=1024 H*D=1024, "
        f"{len(K7_CASES)} cases (B={LANES} and 1; linear and ring; write "
        "slot at 0, chunk boundaries and S-1), with and without statistics,"
        f" one invalid lane, one idle lane: max_abs_err {worst:.3e} (tol "
        f"{tol}; m absolute, l relative); caches equal")
    if not worst <= tol:
        raise AssertionError(f"K7 {_dt_name(dtype)} error {worst} > {tol}")
    results.setdefault("decode_insert_attn", {})[_dt_name(dtype)] = worst


def check_k2_lanes(device, dtype, results):
    """K2 over 32 lanes with distinct starts against its plain version;
    lane i of the lane call equals the solo call on lane i's data bit for
    bit (the same code)."""
    import torch
    from pocket_tts_tpu_torch.ops.ring_attn import (
        ring_insert_attention, ring_insert_attention_plain)
    h, d, cap, t, ctx, b = 8, 64, 256, 16, 250, LANES
    g = torch.Generator(device="cpu").manual_seed(8)
    worst = 0.0
    for off in (240, 4096):
        starts = torch.tensor([(i * 97) % (off + 1) // t * t
                               for i in range(b)], dtype=torch.int32)
        starts[0], starts[1] = 0, off
        starts[2], starts[3] = off - 16, off - 64   # whole chunks fenced
        kc = torch.randn(b, cap, h * d, generator=g).to(device, dtype)
        vc = torch.randn(b, cap, h * d, generator=g).to(device, dtype)
        q, kn, vn = (torch.randn(b, t, h * d, generator=g).to(device, dtype)
                     for _ in range(3))
        kc2, vc2, kc3, vc3 = kc.clone(), vc.clone(), kc.clone(), vc.clone()
        st = starts.to(device)
        got = ring_insert_attention(q, kn, vn, kc, vc, off, st, h, ctx)
        want = ring_insert_attention_plain(q, kn, vn, kc2, vc2, off, st, h,
                                           ctx)
        solo = [ring_insert_attention(q[i], kn[i], vn[i], kc3[i], vc3[i],
                                      off, int(starts[i]), h, ctx)
                for i in SOLO_LANES]
        sync(device)
        if not (torch.equal(kc, kc2) and torch.equal(vc, vc2)):
            raise AssertionError(f"K2 lanes: caches differ at offset {off}")
        for i, o in zip(SOLO_LANES, solo):
            if not torch.equal(got[i], o):
                raise AssertionError(f"K2 lane {i} differs from the solo "
                                     f"call at offset {off}")
        worst = max(worst, (got.float() - want.float()).abs().max().item())
    tol = TOL[("attn", _dt_name(dtype))]
    log(f"  K2 ring_attn lanes {_dt_name(dtype)}: B={b}, distinct starts, "
        "lanes with whole chunks fenced: "
        f"max_abs_err {worst:.3e} (tol {tol}); caches equal; lanes equal "
        "the solo call bit for bit")
    if not worst <= tol:
        raise AssertionError(f"K2 lanes {_dt_name(dtype)} error {worst}")
    errs = results.setdefault("ring_attn", {})
    errs[_dt_name(dtype)] = max(errs.get(_dt_name(dtype), 0.0), worst)


# K3's lane counts: two, a count whose GEMMs leave their last M tile partly
# filled, and the server's
K3_LANES = (2, 5, LANES)


def check_k3_lanes(dec, cfg, device, dtype, results, weights,
                   lanes=K3_LANES):
    """K3 over each of `lanes` lanes (streams stacked on M) for 3 frames
    each against the plain chain with a lane axis, pcm and the 8
    carries."""
    import torch
    from pocket_tts_tpu_torch.models import mimi, seanet
    from pocket_tts_tpu_torch.ops.seanet_frame import seanet_frame
    sc, tpf = cfg.mimi.seanet, cfg.mimi.upsample_stride
    g = torch.Generator(device="cpu").manual_seed(9)
    worst_rel = worst_abs = 0.0
    for nb in lanes:
        st_k = mimi.init_state_lanes(cfg.mimi, nb, dtype, device).seanet
        st_p = {k: v.clone() for k, v in st_k.items()}
        for _ in range(3):
            z = torch.randn(nb, tpf, sc.in_ch, generator=g).to(device, dtype)
            got = seanet_frame(dec, sc, st_k, z, weights)
            new, want = seanet.forward_plain(dec, sc, st_p, z)
            for key in st_p:
                st_p[key].copy_(new[key])
            sync(device)
            scale = max(want.float().abs().max().item(), 1e-30)
            err = (got.float() - want.float()).abs().max().item()
            if not torch.isfinite(got.float()).all():
                raise AssertionError(f"K3 lanes: non-finite pcm (B={nb})")
            worst_abs = max(worst_abs, err)
            worst_rel = max(worst_rel, err / scale)
            for key in st_p:
                cs = max(st_p[key].float().abs().max().item(), 1e-30)
                cerr = (st_k[key].float() - st_p[key].float()).abs().max() \
                    .item()
                worst_rel = max(worst_rel, cerr / cs)
    tol = TOL[("seanet", _dt_name(dtype))]
    log(f"  K3 seanet_frame lanes {_dt_name(dtype)}: B={lanes}, 3 frames "
        f"each, max_abs_err {worst_abs:.3e}, relative (pcm and 8 carries) "
        f"{worst_rel:.3e} (tol {tol})")
    if not worst_rel <= tol:
        raise AssertionError(f"K3 lanes {_dt_name(dtype)} rel error "
                             f"{worst_rel}")
    errs = results.setdefault("seanet_frame", {})
    errs[_dt_name(dtype)] = max(errs.get(_dt_name(dtype), 0.0), worst_abs)


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
    # through in_proj (K=1024, N=3072), linear1 (N=4096), linear2
    # (K=4096) and out_proj, on each of their routes: the skinny kernel at
    # 1, 2 and 15 rows, the tensor cores from 16 (input_linear over 32
    # lanes: K = 32, a k-tile of 16 packed rows), K4a's warpgroup kernel
    # from 64 (130: a ragged token tile), rows_kernel in float32
    from pocket_tts_tpu_torch.ops.quant_matmul import int8_route
    pairs, wide = [], []
    cases = [(t, pq["input_linear"]) for t in (1, 2, 15, 16, LANES)]
    for t in (1, 2, 15, 16, 64, 128, 130, 256):
        for name in ("in_proj", "linear1", "linear2", "out_proj"):
            cases.append((t, slice_layer_params(bb, -1)[name]))
    for t, lin in cases:
        k = lin[key].shape[0] * (2 if key == "q4" else 1)
        x = _rand(rng, device, dtype, t, k, scale=0.5)
        pairs.append((mm(x, lin[key], lin["scale"]),
                      mm_plain(x, lin[key], lin["scale"])))
        if key == "q" and int8_route(dtype, t) == "wgmma":
            wide.append(pairs[-1])
    sync(device)
    _rel_check(mm_name, "quant", dtype, pairs, results, label)
    if wide:
        _rel_check("int8_matmul_wgmma", "quant", dtype, wide, results, label)
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


# -------------------------------------------- phase 3f: quantized convs --

def conv_products(dec, cfg):
    """[(module, key, weight, scale, rows a lane a frame)] of the quantized
    convs of a decoder tree (qc / qc4 / qt / qt4), in the chain's order."""
    from pocket_tts_tpu_torch.ops.seanet_frame import STAGES
    rows = cfg.mimi.upsample_stride
    out = []

    def add(name, mod, n_rows):
        for key in ("qc", "qc4", "qt", "qt4"):
            if key in mod:
                out.append((name, key, mod[key], mod["scale"], n_rows))

    add("model_0", dec["model_0"], rows)
    for (tr, rn), st in zip(STAGES, cfg.mimi.seanet.stages):
        add(tr, dec[tr], rows)
        rows *= st.stride
        for blk in ("block_1", "block_3"):
            add(f"{rn}.{blk}", dec[rn][blk], rows)
    add("model_11", dec["model_11"], rows)
    return out


def conv_matmul_fns(key):
    """(kernel name, wrapper, plain version) of a quantized conv's key."""
    from pocket_tts_tpu_torch.ops import quant_matmul as qm
    if key in ("qc", "qt"):
        return "int8_matmul", qm.int8_matmul, qm.int8_matmul_plain
    return "int4_matmul", qm.int4_matmul, qm.int4_matmul_plain


def conv_route(key, dtype, rows):
    """The kernel a K4a / K4b call of `rows` rows takes."""
    from pocket_tts_tpu_torch.ops.fused_layer import rows_route
    from pocket_tts_tpu_torch.ops.quant_matmul import int8_route
    return (int8_route(dtype, rows) if key in ("qc", "qt")
            else rows_route(dtype, rows))


def check_conv_kernels(engine, device, dtype, results, path):
    """K4a or K4b vs its plain version at each quantized conv's shape
    (`conv_products` of the engine's decoder, which must name the
    convs `conv_shapes` expects), solo rows and LANES lanes' rows (the
    window-concat input of a conv1d, the carries' rows included, is the
    product's x; here random from numpy seed 9), with the tolerances of
    the other K4 checks. In bf16 the cases must reach the routes the
    conv shapes reach first: K4a's warpgroup kernel at N = 64 and at
    K = 128, K4b's tensor-core kernel at K = 3584 over 512 rows, and
    15360 rows."""
    import torch
    dec, cfg = engine.params["mimi"]["decoder"], engine.cfg
    prods = conv_products(dec, cfg)
    want = conv_shapes(cfg)
    got = [(name, q.shape[0] * (2 if key.endswith("4") else 1),
            q.shape[1], rows) for name, key, q, _, rows in prods]
    if got != want:
        raise AssertionError(f"{path}: quantized convs {got}, expected "
                             f"{want}")
    rng = np.random.RandomState(9)
    pairs, routes = [], []
    for name, key, q, scale, rows in prods:
        mm_name, mm, plain = conv_matmul_fns(key)
        k = q.shape[0] * (2 if key.endswith("4") else 1)
        for b in (1, LANES):
            x = _rand(rng, device, dtype, b * rows, k, scale=0.5)
            pairs.append((mm(x, q, scale), plain(x, q, scale)))
            routes.append((name, b * rows, k, q.shape[1],
                           conv_route(key, dtype, b * rows)))
    sync(device)
    _rel_check(mm_name, "quant", dtype, pairs, results, f" [{path}]")
    log(f"    routes (conv, rows, K, N, kernel): {routes}")
    if dtype == torch.bfloat16:
        need = ([("wgmma", "N", 64), ("wgmma", "K", 128)]
                if mm_name == "int8_matmul" else [("mma", "K", 3584)])
        for route, dim, val in need:
            if not any(r == route and (n if dim == "N" else k) == val
                       for _, _, k, n, r in routes):
                raise AssertionError(f"{path}: no {route} case at {dim} = "
                                     f"{val}")
        if mm_name == "int4_matmul" and not any(
                r == "mma" and k == 3584 and rows == 512
                for _, rows, k, _, r in routes):
            raise AssertionError(f"{path}: no mma case at K 3584, 512 rows")
        if max(rows for _, rows, _, _, _ in routes) != 15360:
            raise AssertionError(f"{path}: no case of 15360 rows")


# ------------------------------------------------- phase 3d: serving mode --

def kv8_rows(g, device, dtype, *shape):
    """Random rows of the working type quantized as the backbone does:
    (int8 rows, float32 scales)."""
    import torch
    from pocket_tts_tpu_torch.models.backbone import quantize_rows
    return quantize_rows(torch.randn(*shape, generator=g).to(device, dtype))


def check_k1_kv8(device, dtype, results):
    """K1 over int8 caches with per-row scales vs its plain version: S =
    384 with end 300 (the benchmark sentence's bucket), and S = 128, 1024
    at several ends, with position holes."""
    import torch
    from pocket_tts_tpu_torch.ops.decode_attn import (decode_attention,
                                                      decode_attention_plain)
    h, d = 16, 64
    g = torch.Generator(device="cpu").manual_seed(11)
    worst = 0.0
    for s, ends in ((384, (300, 0, 383)), (128, (127,)), (1024, (700,))):
        k, ks = kv8_rows(g, device, dtype, s, h * d)
        v, vs = kv8_rows(g, device, dtype, s, h * d)
        q = torch.randn(h, d, generator=g).to(device, dtype)
        for end in ends:
            pos = torch.arange(s, dtype=torch.int32)
            pos[end + 1:] = -1
            if end > 20:
                pos[3:9] = -1
            pos = pos.to(device)
            got = decode_attention(q, k, v, pos, end, ks, vs)
            want = decode_attention_plain(q, k, v, pos, end, ks, vs)
            sync(device)
            worst = max(worst, (got.float() - want.float()).abs().max()
                        .item())
    tol = TOL[("attn", _dt_name(dtype))]
    log(f"  K1 decode_attn_kv8 {_dt_name(dtype)}: int8 caches, S=384 "
        f"end=300 and more: max_abs_err {worst:.3e} (tol {tol})")
    if not worst <= tol:
        raise AssertionError(f"K1 kv8 {_dt_name(dtype)} error {worst}")
    results.setdefault("decode_attn_kv8", {})[_dt_name(dtype)] = worst


def k7_kv8_case(g, device, dtype, mode, b=LANES, s=896, ws=None, h=16):
    """k7_case with int8 caches and scale rows (the ring is the serving
    mode's 896 slots: kv_capacity - the prompt bucket), the new rows
    quantized: (q, k_new, v_new, cur_pos, k, v, pos, read_end, ws, ks, vs,
    ks_new, vs_new); the write slot holds stale bytes and scales."""
    import torch
    q, _, _, cur, _, _, pos, re_, ws = k7_case(g, device, dtype, mode, b, s,
                                               h=h, ws=ws)
    h, d = q.shape[1:]
    k, ks = kv8_rows(g, device, dtype, b, s, h * d)
    v, vs = kv8_rows(g, device, dtype, b, s, h * d)
    kn, ksn = kv8_rows(g, device, dtype, b, 1, h * d)
    vn, vsn = kv8_rows(g, device, dtype, b, 1, h * d)
    ks[:, ws] = vs[:, ws] = 1e3          # stale scales: never read
    return (q, kn, vn, cur, k, v, pos, re_, ws, ks, vs, ksn[:, 0].contiguous(),
            vsn[:, 0].contiguous())


def check_k7_kv8(device, dtype, results):
    """K7 with int8 caches vs its plain version, each case of K7_CASES at
    the serving mode's S = 896 (one invalid lane, lane K7_IDLE idle): the
    output, the cache bytes and the scale rows after the insert; and K7
    with statistics (int8 and working-type caches): out, m and l. An idle
    lane (no attended slot) must give out 0, m = -inf and l = 0 on both
    sides."""
    import torch
    from pocket_tts_tpu_torch.ops.insert_attn import (
        decode_insert_attention, decode_insert_attention_plain)
    g = torch.Generator(device="cpu").manual_seed(12)
    tol = TOL[("attn", _dt_name(dtype))]
    worst = {"decode_insert_attn_kv8": 0.0, "decode_insert_attn_stats": 0.0}
    worst_m = worst_l = 0.0
    s = 896
    for mode, b, ws in K7_CASES:
        ws = None if ws is None else ws % s
        for kind in ("kv8", "kv8_stats", "stats"):
            if kind == "stats":
                q, kn, vn, cur, k, v, pos, re_, ws_ = k7_case(
                    g, device, dtype, mode, b, s, ws=ws)
                kw, kw2 = {}, {}
            else:
                (q, kn, vn, cur, k, v, pos, re_, ws_, ks, vs, ksn,
                 vsn) = k7_kv8_case(g, device, dtype, mode, b, s, ws)
                kw = dict(k_scale=ks, v_scale=vs, ks_new=ksn, vs_new=vsn)
                kw2 = dict(k_scale=ks.clone(), v_scale=vs.clone(),
                           ks_new=ksn, vs_new=vsn)
            stats = kind != "kv8"
            if b > K7_IDLE:                  # nothing attended
                pos[K7_IDLE] = -1
                cur[K7_IDLE] = -1
            label = f"{kind} {mode} B={b} ws={ws_}"
            k2, v2 = k.clone(), v.clone()
            got = decode_insert_attention(q, kn, vn, cur, k, v, pos, re_,
                                          ws_, stats=stats, **kw)
            want = decode_insert_attention_plain(q, kn, vn, cur, k2, v2, pos,
                                                 re_, ws_, stats=stats, **kw2)
            sync(device)
            if not (torch.equal(k, k2) and torch.equal(v, v2)):
                raise AssertionError(f"K7 caches differ ({label})")
            if kw and not (torch.equal(kw["k_scale"], kw2["k_scale"])
                           and torch.equal(kw["v_scale"], kw2["v_scale"])):
                raise AssertionError(f"K7 scale rows differ ({label})")
            _k7_idle_check(f"K7 {label}", got, stats, b)
            got = got if stats else (got,)
            want = want if stats else (want,)
            if not torch.isfinite(got[0].float()).all():
                raise AssertionError(f"K7 non-finite output ({label})")
            err = (got[0].float() - want[0].float()).abs().max().item()
            name = ("decode_insert_attn_stats" if stats
                    else "decode_insert_attn_kv8")
            worst[name] = max(worst[name], err)
            if stats:
                (_, m, l), (_, mp, lp) = got, want
                live = torch.isfinite(mp)
                if not torch.equal(live, torch.isfinite(m)):
                    raise AssertionError(f"K7 m masks differ ({label})")
                worst_m = max(worst_m, (m[live] - mp[live]).abs().max()
                              .item())
                worst_l = max(worst_l, ((l[live] - lp[live]).abs()
                                        / lp[live]).max().item())
    log(f"  K7 decode_insert_attn_kv8 {_dt_name(dtype)}: int8 caches, S=896,"
        f" {len(K7_CASES)} cases (B={LANES} and 1; ring and linear; write "
        "slot at 0, chunk boundaries and S-1), one invalid lane, one idle "
        f"lane: max_abs_err {worst['decode_insert_attn_kv8']:.3e} (tol "
        f"{tol}); cache bytes and scale rows equal")
    log(f"  K7 decode_insert_attn_stats {_dt_name(dtype)}: int8 and "
        f"{_dt_name(dtype)} caches, the same cases: out max_abs_err "
        f"{worst['decode_insert_attn_stats']:.3e} (tol {tol}), m max_abs_err"
        f" {worst_m:.3e} (tol {tol}), l max relative error {worst_l:.3e} "
        f"(tol {tol})")
    if not (max(worst.values()) <= tol and worst_m <= tol
            and worst_l <= tol):
        raise AssertionError(f"K7 int8/stats {_dt_name(dtype)} errors "
                             f"{worst} m {worst_m} l {worst_l}")
    for name, err in worst.items():
        results.setdefault(name, {})[_dt_name(dtype)] = err


def lane_rows():
    """(rows, layers) of the K5a/K5b checks over many rows: 32 backbone
    rows (32 lanes x 1), the backbone rows on both sides of the tensor-core
    route's R_min (MMA_ROWS - 1 and MMA_ROWS lanes x 1), and 64, 256 and
    512 mimi rows (4, 16 and 32 lanes x 16)."""
    from pocket_tts_tpu_torch.ops.fused_layer import MMA_ROWS
    return ((LANES, "backbone"), (MMA_ROWS - 1, "backbone"),
            (MMA_ROWS, "backbone"), (64, "mimi"), (256, "mimi"),
            (512, "mimi"))


# K6 over many rows: 32 lanes, 40 (a row block and a part on SIMT f32, one
# MMA row block in bf16) and 64 (a large server's lanes)
FLOW_ROWS = (LANES, 40, 64)


def check_quant_lanes(pq, cfg, device, dtype, results, path):
    """K5a and K5b over many rows, as the serving mode runs them at a lane
    axis (`lane_rows`), and K6 over FLOW_ROWS rows. Each vs its plain
    version; inputs from numpy seed 8."""
    from pocket_tts_tpu_torch.ops import fused_flow, fused_layer
    from pocket_tts_tpu_torch.ops.basic import slice_layer_params
    rng = np.random.RandomState(8)
    label = f" [{path}]"
    pre, post = [], []
    for rows, which in lane_rows():
        if which == "backbone":
            p = slice_layer_params(pq["layers"], 1)
            t, dm, eps = 1, cfg.backbone.d_model, 1e-5
        else:
            p = slice_layer_params(
                pq["mimi"]["decoder_transformer"]["layers"], 1)
            t, dm = 16, cfg.mimi.transformer.d_model
            eps = cfg.mimi.transformer.norm_eps
        x = _rand(rng, device, dtype, rows // t, t, dm, scale=0.5)
        attn = _rand(rng, device, dtype, rows // t, t, dm, scale=0.5)
        pre.append((fused_layer.pre_attention(p, x, eps),
                    fused_layer.pre_attention_plain(p, x, eps)))
        post.append((fused_layer.post_attention(p, x, attn, eps),
                     fused_layer.post_attention_plain(p, x, attn, eps)))
    sync(device)
    _rel_check("fused_pre_lanes", "quant", dtype, pre, results, label)
    _rel_check("fused_post_lanes", "quant", dtype, post, results, label)
    fp, tc = pq["flow_net"], pq["_time_cond"]
    pairs = []
    for b in FLOW_ROWS:
        c = _rand(rng, device, dtype, b, cfg.backbone.d_model)
        x = _rand(rng, device, dtype, b, cfg.latent_dim)
        pairs.append((fused_flow.flow_forward(fp, c, x, tc),
                      fused_flow.flow_forward_plain(fp, c, x, tc)))
    sync(device)
    _rel_check("fused_flow_lanes", "flow", dtype, pairs, results, label)


def rows_step_pairs(p, rows, eps, dtype, rng, device):
    """K5a's product and K5b's three row-block products of layer p, each
    one launch of the row-block route for `rows` rows (`rows_launch`:
    the skinny kernel below MMA_ROWS bf16 rows), beside the plain
    arithmetic of the same step, each prologue / epilogue pair once:
    ROWS_LN + EPI_ROUND (qkv), ROWS_LOAD + EPI_RESID_F32 (x1),
    ROWS_LN_F32 + EPI_GELU (h), ROWS_LOAD + EPI_RESID (the output).
    Returns [(kernel out, plain out)]."""
    import torch
    from pocket_tts_tpu_torch.ops import cuda_lib
    from pocket_tts_tpu_torch.ops import fused_layer as fl
    from pocket_tts_tpu_torch.ops.basic import gelu, layer_norm
    from pocket_tts_tpu_torch.ops.quant_matmul import kernel_operands
    dm = p["norm1"]["scale"].shape[0]
    hid = p["linear1"]["scale"].shape[-1]
    ls1 = p.get("layer_scale_1", {}).get("scale")
    ls2 = p.get("layer_scale_2", {}).get("scale")
    x = _rand(rng, device, dtype, rows, dm, scale=0.5)
    attn = _rand(rng, device, dtype, rows, dm, scale=0.5)
    x1 = _rand(rng, device, torch.float32, rows, dm)
    h = _rand(rng, device, dtype, rows, hid, scale=0.5)

    def scaled(ls, v):
        return v if ls is None else ls.float() * v

    f32 = torch.float32
    steps = (
        ("in_proj", x, p["norm1"], None, None, dtype, fl.ROWS_LN,
         fl.EPI_ROUND, fl.pre_attention_plain(p, x, eps)),
        ("out_proj", attn, {}, x, ls1, f32, fl.ROWS_LOAD, fl.EPI_RESID_F32,
         x.float() + scaled(ls1, fl._deq(attn, p["out_proj"]))),
        ("linear1", x1, p["norm2"], None, None, dtype, fl.ROWS_LN_F32,
         fl.EPI_GELU, gelu(fl._deq(layer_norm(p["norm2"], x1, eps)
                                   .to(dtype), p["linear1"]), False)
         .to(dtype)),
        ("linear2", h, {}, x1, ls2, dtype, fl.ROWS_LOAD, fl.EPI_RESID,
         (x1 + scaled(ls2, fl._deq(h, p["linear2"]))).to(dtype)))
    pairs = []
    for name, a, norm, res, ls, odt, pro, epi, want in steps:
        k, n = a.shape[-1], want.shape[-1]
        lin, layout = kernel_operands(p[name], k, n, x)
        out = torch.empty(rows, n, dtype=odt, device=device)
        fl.rows_launch(cuda_lib.library(), dtype, a,
                       (norm.get("scale"), norm.get("bias")), lin, layout,
                       res, ls, out, rows, k, n, pro, epi, False, eps,
                       cuda_lib.stream_ptr(device))
        pairs.append((out, want))
    return pairs


def check_quant_narrow(device, dtype):
    """K5a, K5b, K5c, K6 and K8 on tiny_config(64)'s narrow widths
    (backbone d_model 256, mimi 128, flow dim 128, latent 8: a few 64-column
    tiles, 8 columns a chain block), quantized to int8, int4 and q4_0: K5a
    and K5b at 1 and 80 backbone rows and 16 and 160 mimi rows (K5a on both
    routes; K5b cooperative up to 64 / 128 rows at these widths, in three
    tensor-core launches above); the cooperative K5b solo at T = 1, 2, 15
    and 16 backbone rows and 16 and 32 mimi rows (the ragged edges of its
    tiles and of the tensor cores' row blocks); K6 at 1, 4, 16 and 40 rows;
    K5c on the layer pair (0, 1) (int4, q4_0); K8 on both layers (int8,
    int4) with caches of the working type and int8: live slots 0..100 with
    the write slot at 100, inside a chunk (37) and at 2 (empty chunks), and
    cur_pos < 0; K5a's and K5b's four row-block products, each prologue /
    epilogue pair, at 1, 2 and 15 rows (the skinny route in bf16) on a
    backbone and a mimi layer, with and without biases (rows_step_pairs);
    each vs its plain version."""
    import torch
    from pocket_tts_tpu_torch.config import tiny_config
    from pocket_tts_tpu_torch.io.params import random_params
    from pocket_tts_tpu_torch.io.quant import quantize_params
    from pocket_tts_tpu_torch.ops import fused_flow, fused_layer, fused_step
    from pocket_tts_tpu_torch.ops.basic import slice_layer_params
    from pocket_tts_tpu_torch.ops.rope import rope_cos_sin
    p0, cfg = random_params(tiny_config(64), seed=5, dtype=dtype,
                            device=device)
    rng = np.random.RandomState(12)
    g = torch.Generator(device="cpu").manual_seed(13)
    bbc, mtc = cfg.backbone, cfg.mimi.transformer
    for path, kw in QUANTIZE.items():
        pq = quantize_params(p0, **kw)
        mlayers = pq["mimi"]["decoder_transformer"]["layers"]
        pre, post, solo, flow, bil = [], [], [], [], []
        for rows, t, layers, dm, eps in (
                (1, 1, pq["layers"], bbc.d_model, 1e-5),
                (80, 1, pq["layers"], bbc.d_model, 1e-5),
                (16, 16, mlayers, mtc.d_model, mtc.norm_eps),
                (160, 16, mlayers, mtc.d_model, mtc.norm_eps)):
            p = slice_layer_params(layers, 1)
            x = _rand(rng, device, dtype, rows // t, t, dm, scale=0.5)
            attn = _rand(rng, device, dtype, rows // t, t, dm, scale=0.5)
            pre.append((fused_layer.pre_attention(p, x, eps),
                        fused_layer.pre_attention_plain(p, x, eps)))
            post.append((fused_layer.post_attention(p, x, attn, eps),
                         fused_layer.post_attention_plain(p, x, attn, eps)))
        for t, layers, dm, eps in ((1, pq["layers"], bbc.d_model, 1e-5),
                                   (2, pq["layers"], bbc.d_model, 1e-5),
                                   (15, pq["layers"], bbc.d_model, 1e-5),
                                   (16, pq["layers"], bbc.d_model, 1e-5),
                                   (16, mlayers, mtc.d_model, mtc.norm_eps),
                                   (32, mlayers, mtc.d_model, mtc.norm_eps)):
            p = slice_layer_params(layers, 0)
            x = _rand(rng, device, dtype, t, dm, scale=0.5)
            attn = _rand(rng, device, dtype, t, dm, scale=0.5)
            solo.append((fused_layer.post_attention(p, x, attn, eps,
                                                    approx=t % 2 == 1),
                         fused_layer.post_attention_plain(
                             p, x, attn, eps, approx=t % 2 == 1)))
        fp = pq["flow_net"]
        tc = _rand(rng, device, dtype, cfg.flow.dim)
        for b in (None, 4, 16, 40):
            shape = () if b is None else (b,)
            c = _rand(rng, device, dtype, *shape, cfg.backbone.d_model)
            x = _rand(rng, device, dtype, *shape, cfg.latent_dim)
            flow.append((fused_flow.flow_forward(fp, c, x, tc),
                         fused_flow.flow_forward_plain(fp, c, x, tc)))
        steps = []
        for layers, eps in ((pq["layers"], 1e-5), (mlayers, mtc.norm_eps)):
            for bias in (False, True):
                p = slice_layer_params(layers, 1)
                if bias:
                    p = _with_biases(p, rng, device, dtype)
                for rows in (1, 2, 15):
                    steps += rows_step_pairs(p, rows, eps, dtype, rng,
                                             device)
        if path != "int8":
            p0_, p1_ = (slice_layer_params(pq["layers"], i) for i in (0, 1))
            x = _rand(rng, device, dtype, 1, bbc.d_model, scale=0.5)
            a = _rand(rng, device, dtype, 1, bbc.d_model, scale=0.5)
            bil += list(zip(fused_layer.bilayer_post_pre(p0_, p1_, x, a),
                            fused_layer.bilayer_post_pre_plain(p0_, p1_, x,
                                                               a)))
        sync(device)
        label = f" narrow [{path}]"
        _rel_check("fused_pre_lanes", "quant", dtype, pre, {}, label)
        _rel_check("fused_post_lanes", "quant", dtype, post, {}, label)
        _rel_check("fused_post", "quant", dtype, solo, {},
                   f"{label} T = 1, 2, 15, 16 / 16, 32")
        _rel_check("fused_flow_lanes", "flow", dtype, flow, {}, label)
        _rel_check("rows steps", "quant", dtype, steps, {},
                   f"{label} 1, 2, 15 rows (skinny in bf16)")
        if bil:
            _rel_check("bilayer", "quant", dtype, bil, {}, label)
        if path == "q4_0":
            continue
        worst_y = worst_c = 0.0
        for kvq in (False, True):
            for end, ws, live in ((100, 100, True), (100, 37, True),
                                  (2, 2, True), (100, 100, False)):
                x, k, v, ks, vs, pos, cur = k8_case(
                    g, device, dtype, kvq, s=bbc.kv_capacity, end=end,
                    dm=bbc.d_model)
                if ws != end:    # a ring: the write slot inside the live ones
                    cur = pos[ws:ws + 1].clone()
                    if kvq:
                        ks[end], vs[end] = ks[end - 1], vs[end - 1]
                        ks[ws] = vs[ws] = 1e3
                    else:
                        k[end], v[end] = k[end - 1], v[end - 1]
                        k[ws], v[ws] = 1e3, -1e3
                if not live:
                    cur = torch.full_like(cur, -1)
                cos, sin = rope_cos_sin(cur.clamp(min=0), bbc.head_dim,
                                        bbc.max_period)
                for l in range(bbc.num_layers):
                    p = slice_layer_params(pq["layers"], l)
                    c1 = [c if c is None else c.clone() for c in (k, v, ks,
                                                                  vs)]
                    c2 = [c if c is None else c.clone() for c in (k, v, ks,
                                                                  vs)]
                    y = fused_step.megalayer(p, x, cos, sin, cur, c1[0],
                                             c1[1], pos, end, ws, c1[2],
                                             c1[3])
                    want = fused_step.megalayer_plain(
                        p, x, cos, sin, cur, c2[0], c2[1], pos, end, ws,
                        c2[2], c2[3])
                    sync(device)
                    if not torch.isfinite(y.float()).all():
                        raise AssertionError(f"K8{label}: non-finite y")
                    scale = max(want.float().abs().max().item(), 1e-30)
                    worst_y = max(worst_y, (y.float() - want.float()).abs()
                                  .max().item() / scale)
                    worst_c = max(worst_c, _cache_check(f"K8{label}", c1,
                                                        c2))
        tol = TOL[("mega", _dt_name(dtype))]
        log(f"  megalayer{label} {_dt_name(dtype)}: write slot 100 / 37 / "
            f"2, cur_pos < 0, both caches: y relative to max|plain| "
            f"{worst_y:.3e}, cache and scale rows {worst_c:.3e} (tol {tol})")
        if not (worst_y <= tol and worst_c <= tol):
            raise AssertionError(f"K8{label} {_dt_name(dtype)}: y {worst_y} "
                                 f"cache {worst_c} > {tol}")


# ------------------------------------------------- phase 3e: slice 6 -------

def k8_case(g, device, dtype, kvq, s=384, end=300, dm=1024):
    """Inputs of one K8 call at the benchmark bucket: x (1, dm), caches
    (S, dm) pre-insert with slots 0..end-1 live (a few padding holes) and
    a stale row at the write slot `end`, pos (S,) post-insert, scales for
    int8 caches: (x, k, v, ks, vs, pos, cur_pos)."""
    import torch
    x = (0.5 * torch.randn(1, dm, generator=g)).to(device, dtype)
    if kvq:
        k, ks = kv8_rows(g, device, dtype, s, dm)
        v, vs = kv8_rows(g, device, dtype, s, dm)
        ks[end] = vs[end] = 1e3           # stale scales: never read
    else:
        k = torch.randn(s, dm, generator=g).to(device, dtype)
        v = torch.randn(s, dm, generator=g).to(device, dtype)
        k[end], v[end] = 1e3, -1e3        # stale row: never read
        ks = vs = None
    pos = torch.arange(s, dtype=torch.int32) + 5
    pos[end + 1:] = -1
    pos[40:47] = -1
    return x, k, v, ks, vs, pos.to(device), pos[end:end + 1].to(device)


def _cache_check(name, got, want):
    """K8's cache rows and scale rows after the insert: int8 bytes at most
    one step apart, float rows and scales relative to max |plain|. Returns
    the largest relative error of the float ones."""
    import torch
    worst = 0.0
    for a, b in zip(got, want):
        if a is None:
            continue
        if a.dtype == torch.int8:
            d = (a.int() - b.int()).abs()
            if int(d.max()) > 1:
                raise AssertionError(f"{name}: int8 bytes {int(d.max())} "
                                     "steps apart")
            continue
        scale = max(b.float().abs().max().item(), 1e-30)
        worst = max(worst, (a.float() - b.float()).abs().max().item() / scale)
    return worst


def check_k8(engines, device, dtype, results):
    """K8 vs megalayer_plain on the full-width int8 and int4 trees, caches
    of the working type and int8: S = 384 with end = 300 (the write slot
    inside a 128-slot tile) and with the write slot at a tile edge (end =
    255, 256), every layer; y, the cache rows and the scale rows."""
    import torch
    from pocket_tts_tpu_torch.ops import fused_step
    from pocket_tts_tpu_torch.ops.basic import slice_layer_params
    from pocket_tts_tpu_torch.ops.rope import rope_cos_sin
    g = torch.Generator(device="cpu").manual_seed(21)
    dn = _dt_name(dtype)
    tol = TOL[("mega", dn)]
    for path, name in (("int8", "megalayer"), ("int4", "megalayer_int4")):
        eng = engines[path, dtype]
        bb = eng.cfg.backbone
        worst_y = worst_c = 0.0
        nbytes = ndiff = 0
        for kvq in (False, True):
            for end in (300, 255, 256):
                x, k, v, ks, vs, pos, cur = k8_case(g, device, dtype, kvq,
                                                    end=end, dm=bb.d_model)
                cos, sin = rope_cos_sin(cur, bb.head_dim, bb.max_period)
                for l in range(bb.num_layers):
                    p = slice_layer_params(eng.params["layers"], l)
                    c1 = [c if c is None else c.clone() for c in (k, v, ks,
                                                                  vs)]
                    c2 = [c if c is None else c.clone() for c in (k, v, ks,
                                                                  vs)]
                    y = fused_step.megalayer(p, x, cos, sin, cur, c1[0],
                                             c1[1], pos, end, end, c1[2],
                                             c1[3])
                    want = fused_step.megalayer_plain(
                        p, x, cos, sin, cur, c2[0], c2[1], pos, end, end,
                        c2[2], c2[3])
                    sync(device)
                    if not torch.isfinite(y.float()).all():
                        raise AssertionError(f"K8 {path}: non-finite y")
                    scale = max(want.float().abs().max().item(), 1e-30)
                    worst_y = max(worst_y, (y.float() - want.float()).abs()
                                  .max().item() / scale)
                    worst_c = max(worst_c, _cache_check(
                        f"K8 {path}", c1, c2))
                    rows = torch.arange(k.shape[0], device=device) != end
                    if not (torch.equal(c1[0][rows], k[rows])
                            and torch.equal(c1[1][rows], v[rows])):
                        raise AssertionError(f"K8 {path}: rows other than "
                                             "the write slot changed")
                    if kvq:
                        nbytes += 2 * k.shape[1]
                        ndiff += int((c1[0][end] != c2[0][end]).sum()
                                     + (c1[1][end] != c2[1][end]).sum())
                    err = (y.float() - want.float()).abs().max().item()
                    errs = results.setdefault(name, {})
                    errs[dn] = max(errs.get(dn, 0.0), err)
                    if kvq:
                        e8 = results.setdefault("megalayer_kv8", {})
                        e8[dn] = max(e8.get(dn, 0.0), err)
        log(f"  K8 {name} {dn}: S=384, write slot 300 / 255 / 256, "
            f"{bb.num_layers} layers, {dn} and int8 caches: y error "
            f"relative to max|plain| {worst_y:.3e}, cache and scale rows "
            f"{worst_c:.3e} (tol {tol}); int8 bytes one step apart: "
            f"{ndiff} of {nbytes}")
        if not (worst_y <= tol and worst_c <= tol):
            raise AssertionError(f"K8 {path} {dn}: y {worst_y} cache "
                                 f"{worst_c} > {tol}")


def check_k5c(engines, device, dtype, results):
    """K5c vs bilayer_post_pre_plain on the full-width int4 and q4_0 trees,
    all five layer pairs, with and without the tanh GELU."""
    from pocket_tts_tpu_torch.ops import fused_layer
    from pocket_tts_tpu_torch.ops.basic import slice_layer_params
    rng = np.random.RandomState(22)
    pairs = []
    for path in ("int4", "q4_0"):
        eng = engines[path, dtype]
        layers = eng.params["layers"]
        dm = eng.cfg.backbone.d_model
        for l in range(eng.cfg.backbone.num_layers - 1):
            p0, p1 = (slice_layer_params(layers, i) for i in (l, l + 1))
            if not fused_layer.bilayer_supported(p0, p1):
                raise AssertionError(f"{path}: bilayer route not taken")
            x = _rand(rng, device, dtype, 1, dm, scale=0.5)
            a = _rand(rng, device, dtype, 1, dm, scale=0.5)
            got = fused_layer.bilayer_post_pre(p0, p1, x, a,
                                               approx=l % 2 == 1)
            want = fused_layer.bilayer_post_pre_plain(p0, p1, x, a,
                                                      approx=l % 2 == 1)
            pairs += list(zip(got, want))
    sync(device)
    _rel_check("bilayer", "quant", dtype, pairs, results,
               " [int4, q4_0; x_next and qkv]")


def check_k2q(device, dtype, results):
    """K2-q vs its plain version: solo (cap 256, offsets before and after
    the ring wraps) and 32 lanes with distinct starts, each lane equal to
    the solo call bit for bit; ring bytes and scale rows equal."""
    import torch
    from pocket_tts_tpu_torch.ops.ring_attn import (
        ring_insert_attention, ring_insert_attention_plain)
    h, d, cap, t, ctx = 8, 64, 256, 16, 250
    hd = h * d
    g = torch.Generator(device="cpu").manual_seed(23)
    worst = 0.0

    def case(*lead):
        q = torch.randn(*lead, t, hd, generator=g).to(device, dtype)
        kn, ksn = kv8_rows(g, device, dtype, *lead, t, hd)
        vn, vsn = kv8_rows(g, device, dtype, *lead, t, hd)
        k, ks = kv8_rows(g, device, dtype, *lead, cap, hd)
        v, vs = kv8_rows(g, device, dtype, *lead, cap, hd)
        return q, kn, vn, k, v, ksn, vsn, ks, vs

    def run(fn, c, off, start):
        q, kn, vn, k, v, ksn, vsn, ks, vs = c
        caches = [k.clone(), v.clone(), ks.clone(), vs.clone()]
        out = fn(q, kn, vn, caches[0], caches[1], off, start, h, ctx,
                 k_scale=caches[2], v_scale=caches[3], ks_new=ksn,
                 vs_new=vsn)
        return [out] + caches

    for off in (0, 16, 240, 256, 4096):
        for start in sorted({0, 32, max(off - 48, 0), off}):
            if start > off:
                continue
            c = case()
            got = run(ring_insert_attention, c, off, start)
            want = run(ring_insert_attention_plain, c, off, start)
            sync(device)
            if not all(torch.equal(a, b) for a, b in zip(got[1:], want[1:])):
                raise AssertionError(f"K2-q rings differ at offset {off}")
            worst = max(worst, (got[0].float() - want[0].float()).abs()
                        .max().item())
    for off in (240, 4096):
        c = case(LANES)
        starts = torch.tensor([(i * 97) % (off + 1) // t * t
                               for i in range(LANES)], dtype=torch.int32)
        starts[0], starts[1] = 0, off
        starts[2], starts[3] = off - 16, off - 64   # whole chunks fenced
        st = starts.to(device)
        got = run(ring_insert_attention, c, off, st)
        want = run(ring_insert_attention_plain, c, off, st)
        solo = [run(ring_insert_attention, [a[i] for a in c], off,
                    int(starts[i])) for i in SOLO_LANES]
        sync(device)
        if not all(torch.equal(a, b) for a, b in zip(got[1:], want[1:])):
            raise AssertionError(f"K2-q lanes: rings differ at {off}")
        for i, o in zip(SOLO_LANES, solo):
            if not torch.equal(got[0][i], o[0]):
                raise AssertionError(f"K2-q lane {i} differs from the solo "
                                     f"call at offset {off}")
        worst = max(worst, (got[0].float() - want[0].float()).abs().max()
                    .item())
    tol = TOL[("attn", _dt_name(dtype))]
    log(f"  K2-q ring_attn_kv8 {_dt_name(dtype)}: int8 ring cap 256, solo "
        f"and B={LANES} with distinct starts: max_abs_err {worst:.3e} (tol "
        f"{tol}); ring bytes and scale rows equal; lanes equal the solo "
        "call bit for bit")
    if not worst <= tol:
        raise AssertionError(f"K2-q {_dt_name(dtype)} error {worst}")
    results.setdefault("ring_attn_kv8", {})[_dt_name(dtype)] = worst


def k1_lanes_case(g, device, dtype, kvq, s, b=LANES, end=None, h=16,
                  d=64):
    """K1 over lanes: q (B, H, D), caches (B, S, H*D) of the working type
    or int8 with (B, S) scales, pos (B, S) with lanes of different lengths
    and holes; lane 2 attends nothing. end: S - 1 (ring mode) by
    default."""
    import torch
    end = s - 1 if end is None else end
    q = torch.randn(b, h, d, generator=g).to(device, dtype)
    if kvq:
        k, ks = kv8_rows(g, device, dtype, b, s, h * d)
        v, vs = kv8_rows(g, device, dtype, b, s, h * d)
    else:
        k = torch.randn(b, s, h * d, generator=g).to(device, dtype)
        v = torch.randn(b, s, h * d, generator=g).to(device, dtype)
        ks = vs = None
    pos = torch.arange(s, dtype=torch.int32).repeat(b, 1) + 5000
    for i in range(b):
        pos[i, : (i * 37) % s] = -1
    pos[::3, 40:60] = -1
    pos[:, end + 1:] = -1
    pos[2] = -1
    return q, k, v, ks, vs, pos.to(device), end


def check_k1_lanes(device, dtype, results):
    """K1 over 32 lanes vs its plain version: S = 1024 (bf16 caches) and S
    = 896 (int8), ring (every slot read) and linear (end 700), with and
    without statistics; the idle lane gives out 0, m = -inf, l = 0."""
    import torch
    from pocket_tts_tpu_torch.ops.decode_attn import (decode_attention,
                                                      decode_attention_plain)
    g = torch.Generator(device="cpu").manual_seed(24)
    tol = TOL[("attn", _dt_name(dtype))]
    worst = {"decode_attn_lanes": 0.0, "decode_attn_stats": 0.0}
    worst_m = worst_l = 0.0
    for kvq, s in ((False, 1024), (True, 896)):
        for end in (None, 700):
            q, k, v, ks, vs, pos, e = k1_lanes_case(g, device, dtype, kvq, s,
                                                    end=end)
            for stats in (False, True):
                got = decode_attention(q, k, v, pos, e, ks, vs, stats=stats)
                want = decode_attention_plain(q, k, v, pos, e, ks, vs,
                                              stats=stats)
                sync(device)
                got = got if stats else (got,)
                want = want if stats else (want,)
                name = "decode_attn_stats" if stats else "decode_attn_lanes"
                if not torch.isfinite(got[0].float()).all():
                    raise AssertionError("K1 lanes: non-finite output")
                if not (got[0][2] == 0).all():
                    raise AssertionError("K1 lanes: the idle lane is not 0")
                worst[name] = max(worst[name], (got[0].float()
                                                - want[0].float()).abs()
                                  .max().item())
                # each lane equals the solo call on its data bit for bit
                for i in SOLO_LANES:
                    solo = decode_attention(
                        q[i], k[i], v[i], pos[i], e,
                        None if ks is None else ks[i],
                        None if vs is None else vs[i], stats=stats)
                    solo = solo if stats else (solo,)
                    if not all(torch.equal(a[i], o)
                               for a, o in zip(got, solo)):
                        raise AssertionError(f"K1 lane {i} differs from the "
                                             "solo call")
                if stats:
                    (_, m, l), (_, mp, lp) = got, want
                    if not (torch.isneginf(m[2]).all() and (l[2] == 0).all()):
                        raise AssertionError("K1 lanes: the idle lane is not "
                                             "(0, -inf, 0)")
                    live = torch.isfinite(mp)
                    if not torch.equal(live, torch.isfinite(m)):
                        raise AssertionError("K1 lanes: m masks differ")
                    worst_m = max(worst_m, (m[live] - mp[live]).abs().max()
                                  .item())
                    worst_l = max(worst_l, ((l[live] - lp[live]).abs()
                                            / lp[live]).max().item())
        # every lane idle: every chunk of every cluster is empty
        pos = torch.full_like(pos, -1)
        for stats in (False, True):
            got = decode_attention(q, k, v, pos, e, ks, vs, stats=stats)
            sync(device)
            got = got if stats else (got,)
            if not ((got[0] == 0).all() and (not stats or (
                    torch.isneginf(got[1]).all() and (got[2] == 0).all()))):
                raise AssertionError("K1 lanes: all-idle lanes are not "
                                     "(0, -inf, 0)")
    log(f"  K1 decode_attn_lanes {_dt_name(dtype)}: B={LANES}, S=1024 "
        f"{_dt_name(dtype)} and S=896 int8, ring and end=700, an idle lane, "
        f"then every lane idle; lanes equal the solo call bit for bit: "
        f"max_abs_err {worst['decode_attn_lanes']:.3e}; with statistics out "
        f"{worst['decode_attn_stats']:.3e}, m {worst_m:.3e}, l relative "
        f"{worst_l:.3e} (tol {tol})")
    if not (max(worst.values()) <= tol and worst_m <= tol
            and worst_l <= tol):
        raise AssertionError(f"K1 lanes {_dt_name(dtype)} errors {worst} "
                             f"m {worst_m} l {worst_l}")
    for name, err in worst.items():
        results.setdefault(name, {})[_dt_name(dtype)] = err


# ---------------------------------------------------------------- phase 4 --

def counted_frame_steps():
    """Wrap models.tts.frame_step and models.flow_lm.prefill to count the
    frames decoded and the prefill calls (voice priming and each
    sentence's text) made, and the prefill calls of WGMMA_ROWS rows or
    more (K4a's warpgroup route in bf16)."""
    from pocket_tts_tpu_torch.models import flow_lm, tts
    from pocket_tts_tpu_torch.ops.quant_matmul import WGMMA_ROWS
    real_step, real_prefill = tts.frame_step, flow_lm.prefill
    count = {"frames": 0, "prefills": 0, "wide_prefills": 0}

    def frame_step(p, cfg, state, *args, **kw):
        if not state.done:
            count["frames"] += 1
        return real_step(p, cfg, state, *args, **kw)

    def prefill(p, cfg, state, emb, *args, **kw):
        count["prefills"] += 1
        count["wide_prefills"] += emb.shape[0] >= WGMMA_ROWS
        return real_prefill(p, cfg, state, emb, *args, **kw)

    tts.frame_step = frame_step
    flow_lm.prefill = prefill
    return count


def _counters():
    """{kernel name: (wrapper, attribute of its launch count)}: the fused
    wrappers count solo int8 launches in `launches`, solo int4 ones in
    `launches_int4` and launches over lanes in `launches_lanes`; K1, K2 and
    K7 count int8-KV launches in `launches_kv8` (K1 over lanes in
    `launches_lanes` instead), K1 and K7 their launches with statistics
    once more in `launches_stats`; K8 counts by weights and once more with
    an int8 cache, K5c in `bilayer_post_pre.launches_bilayer`."""
    from pocket_tts_tpu_torch.ops import fused_flow, fused_layer
    from pocket_tts_tpu_torch.ops.decode_attn import decode_attention
    from pocket_tts_tpu_torch.ops.insert_attn import decode_insert_attention
    from pocket_tts_tpu_torch.ops.quant_matmul import (int4_matmul,
                                                       int8_matmul)
    from pocket_tts_tpu_torch.ops.ring_attn import ring_insert_attention
    from pocket_tts_tpu_torch.ops.seanet_frame import seanet_frame
    from pocket_tts_tpu_torch.ops.fused_step import megalayer
    out = {"decode_attn": (decode_attention, "launches"),
           "decode_attn_kv8": (decode_attention, "launches_kv8"),
           "decode_attn_lanes": (decode_attention, "launches_lanes"),
           "decode_attn_stats": (decode_attention, "launches_stats"),
           "ring_attn": (ring_insert_attention, "launches"),
           "ring_attn_kv8": (ring_insert_attention, "launches_kv8"),
           "megalayer": (megalayer, "launches"),
           "megalayer_int4": (megalayer, "launches_int4"),
           "megalayer_kv8": (megalayer, "launches_kv8"),
           "bilayer": (fused_layer.bilayer_post_pre, "launches_bilayer"),
           "seanet_frame": (seanet_frame, "launches"),
           "int8_matmul": (int8_matmul, "launches"),
           "int8_matmul_wgmma": (int8_matmul, "launches_wgmma"),
           "int4_matmul": (int4_matmul, "launches"),
           "decode_insert_attn": (decode_insert_attention, "launches"),
           "decode_insert_attn_kv8": (decode_insert_attention,
                                      "launches_kv8"),
           "decode_insert_attn_stats": (decode_insert_attention,
                                        "launches_stats"),
           "rows_mma": (fused_layer._rows_call, "launches_mma"),
           "rows_skinny": (fused_layer._rows_call, "launches_skinny")}
    for name, fn in (("fused_pre", fused_layer.pre_attention),
                     ("fused_post", fused_layer.post_attention),
                     ("fused_flow", fused_flow.flow_forward)):
        out[name] = (fn, "launches")
        out[name + "_int4"] = (fn, "launches_int4")
        out[name + "_lanes"] = (fn, "launches_lanes")
    return out


def reset_counters():
    for fn, attr in _counters().values():
        setattr(fn, attr, 0)


def read_counters():
    return {name: getattr(fn, attr)
            for name, (fn, attr) in _counters().items()}


def _engine_kw(cfg, device, dtype):
    from pocket_tts_tpu_torch.text.tokenizer import MockTokenizer
    return dict(cfg=cfg, dtype=dtype, device=device, seed=0,
                tokenizer=MockTokenizer(cfg.lut.n_bins))


def make_engine(cfg, device, dtype, quantize=None, quantize_kv=False,
                params=None, quantize_convs=False):
    """An engine on random weights from seed 0 (or on `params`, a tree of
    an engine made here, with its cfg; quantized linears stay as they are,
    so quantize_convs on an int8 or int4 engine's tree quantizes its convs
    alone)."""
    from pocket_tts_tpu_torch.io.params import random_params
    from pocket_tts_tpu_torch.runtime.engine import TTSEngine
    if params is None:
        params, cfg = random_params(cfg, seed=0, dtype=dtype, device=device)
    return TTSEngine(params=params, quantize=quantize,
                     quantize_kv=quantize_kv, quantize_convs=quantize_convs,
                     **_engine_kw(cfg, device, dtype))


def expected_launches(cfg, path, dtype=None):
    """(launches per decoded frame, launches per prefill call) by kernel
    for a path (WIDE_PREFILL's entries per prefill call of WGMMA_ROWS
    rows or more) in `dtype` (bf16 when None): "bf16", "int8", "int4",
    "q4_0", "int4_kv8" (int4 weights,
    int8 KV cache: K1's int8-KV variant), "int8_mega" (K8 per backbone
    layer), "int4_kv8_mega" (K8's int4 and int8-KV variant, and K2-q for
    the int8 mimi ring), "int4_bilayer" (K5a of layer 0, K5c at each
    layer boundary, K5b after the last, K1 per layer), or a
    reference-exact path (`expected_exact`)."""
    if path in EXACT_PATHS:
        return expected_exact(cfg, path)
    nb, nm = cfg.backbone.num_layers, cfg.mimi.transformer.num_layers
    kv8 = ENGINE_KW[path].get("quantize_kv", False)
    if ENGINE_KW[path].get("quantize_convs"):
        return conv_launches(cfg, path, *expected_launches(
            cfg, CONV_COUNTERPART[path], dtype))
    k1 = "decode_attn_kv8" if kv8 else "decode_attn"
    ring = ("ring_attn_kv8" if PATH_CFG.get(path, {}).get("mimi_kv8")
            else "ring_attn")
    per_frame = {ring: nm, "seanet_frame": 1}
    per_prefill = {}
    weights = ENGINE_KW[path].get("quantize")
    if weights not in PATH_KERNELS:
        per_frame[k1] = nb
        return per_frame, per_prefill
    from pocket_tts_tpu_torch.ops.fused_flow import LAUNCHES
    from pocket_tts_tpu_torch.ops.fused_layer import rows_route
    import torch
    mm, pre, post, flow = PATH_KERNELS[weights]
    per_frame.update({mm: 1, pre: nb + nm, post: nb + nm, flow: LAUNCHES})
    # the mimi layers' K5a (T = 16 rows) on the tensor cores
    if rows_route(torch.bfloat16, cfg.mimi.upsample_stride) == "mma":
        per_frame["rows_mma"] = nm
    per_prefill = {mm: 4 * nb}
    if weights == "int8":   # the bf16 prefill buckets of 64 rows or more
        per_prefill["int8_matmul_wgmma"] = 4 * nb
    skinny = rows_route(torch.bfloat16, 1) == "skinny"  # K5a of a T = 1 layer
    if cfg.backbone.use_megalayer:
        per_frame.update({pre: nm, post: nm,
                          ("megalayer" if weights == "int8"
                           else "megalayer_int4"): nb})
        if kv8:
            per_frame["megalayer_kv8"] = nb
    elif cfg.backbone.use_bilayer:
        per_frame.update({pre: 1 + nm, post: 1 + nm, "bilayer": nb - 1,
                          k1: nb})
        if skinny:
            per_frame["rows_skinny"] = 1
    else:
        per_frame[k1] = nb
        if skinny:
            per_frame["rows_skinny"] = nb
    return per_frame, per_prefill


def expected_exact(cfg, path):
    """expected_launches of a reference-exact path, from the JAX routing
    (`pallas_mode == "off"`, models/backbone.py:415-424, models/
    mimi_transformer.py:205-221): no K1, K2, K7, K8 or K5a/K5b/K5c; one K3
    sequence a frame (seanet.py reads no switch); with int8 weights every
    linear unfused through K4a: input_linear, the backbone's four linears
    a layer at T = 1 and the mimi's four a layer at T = 16 each frame, the
    backbone's four a layer each prefill call, and K6's launches (the flow
    net reads no switch). Float32 only (phase 9): K4a takes the
    row-block routes there, never the warpgroup kernel."""
    nb, nm = cfg.backbone.num_layers, cfg.mimi.transformer.num_layers
    if cfg.backbone.use_pallas_attn is not False or (
            cfg.mimi.transformer.use_pallas_attn is not False):
        raise ValueError(f"{path}: not a reference-exact cfg")
    per_frame, per_prefill = {"seanet_frame": 1}, {}
    if ENGINE_KW[path].get("quantize") == "int8":
        from pocket_tts_tpu_torch.ops.fused_flow import LAUNCHES
        per_frame.update(int8_matmul=1 + 4 * nb + 4 * nm,
                         fused_flow=LAUNCHES)
        per_prefill["int8_matmul"] = 4 * nb
    return per_frame, per_prefill


def conv_shapes(cfg):
    """[(module, K, N, rows a lane a frame)] of the decoder convs that
    quantize_params(convs=True) quantizes, from the cfg's dims alone (an
    expectation independent of the tree, `conv_products`): every conv of
    at least _MIN_CONV_QUANT_SIZE elements, conv1d as its window product
    (K*Cin, Cout), the transposed convs as (Cin, K*Cout); the resnets'
    block_1 halves the channels."""
    from pocket_tts_tpu_torch.io.quant import _MIN_CONV_QUANT_SIZE
    from pocket_tts_tpu_torch.ops.seanet_frame import STAGES
    sc = cfg.mimi.seanet
    rows = cfg.mimi.upsample_stride
    out = []

    def add(name, cin, cout, k, n_rows, tr=False):
        if cin * cout * k >= _MIN_CONV_QUANT_SIZE:
            out.append((name, cin, k * cout, n_rows) if tr
                       else (name, k * cin, cout, n_rows))

    add("model_0", sc.in_ch, sc.in_ch, sc.first_kernel, rows)
    for (tr, rn), st in zip(STAGES, sc.stages):
        add(tr, st.in_ch, st.out_ch, st.kernel, rows, tr=True)
        rows *= st.stride
        hid = st.out_ch // 2
        add(f"{rn}.block_1", st.out_ch, hid, sc.resnet_kernel, rows)
        add(f"{rn}.block_3", hid, st.out_ch, 1, rows)
    add("model_11", sc.stages[-1].out_ch, sc.out_ch, sc.last_kernel, rows)
    return out


def conv_launches(cfg, path, per_frame, per_prefill):
    """expected_launches of a CONV_PATHS path from its counterpart's: no
    K3 sequence, and per frame one launch of the path's matmul kernel for
    each quantized conv (`conv_shapes`, solo rows), K4a's from WGMMA_ROWS
    rows in bf16 counted once more under int8_matmul_wgmma."""
    from pocket_tts_tpu_torch.ops.quant_matmul import WGMMA_ROWS
    per_frame = dict(per_frame)
    del per_frame["seanet_frame"]
    shapes = conv_shapes(cfg)
    mm = PATH_KERNELS[ENGINE_KW[path]["quantize"]][0]
    per_frame[mm] += len(shapes)
    if mm == "int8_matmul":
        wide = sum(rows >= WGMMA_ROWS for _, _, _, rows in shapes)
        if wide:
            per_frame["int8_matmul_wgmma"] = wide
    return per_frame, per_prefill


# kernels that a prefill call launches only at WGMMA_ROWS rows or more
WIDE_PREFILL = ("int8_matmul_wgmma",)


def end_to_end(engine, voice, counts, label, text=BENCH_TEXT,
               expected=None):
    """Synthesize `text` at temp 0 on path `label` with the counters set to
    0 just before and read just after; checks the pcm and the launch
    counts (`expected`: (per frame, per prefill call), else
    expected_launches of the label)."""
    frames0, prefills0 = counts["frames"], counts["prefills"]
    wide0 = counts["wide_prefills"]
    per_frame, per_prefill = expected or expected_launches(engine.cfg,
                                                           label)
    reset_counters()
    t0 = time.perf_counter()
    pcm = engine.synthesize(text, voice, temp=0.0)
    sync(engine.device)
    wall = time.perf_counter() - t0
    launches = read_counters()
    frames = counts["frames"] - frames0
    prefills = counts["prefills"] - prefills0
    wide = counts["wide_prefills"] - wide0
    audio_s = pcm.size / engine.sample_rate
    log(f"  {label} synthesize: {frames} frames decoded, {prefills} "
        f"prefill calls ({wide} of 64 rows or more), "
        f"{pcm.size} samples ({audio_s:.2f} s of audio), "
        f"wall {wall:.3f} s (includes voice priming and prefill)")
    log(f"  launches {launches}; expected per frame {per_frame}, per "
        f"prefill call {per_prefill}")
    if frames < 1 or pcm.size == 0 or pcm.size % engine.frame_size:
        raise AssertionError(f"bad output length {pcm.size}")
    if not np.isfinite(pcm).all():
        raise AssertionError("non-finite pcm")
    if not np.abs(pcm).max() > 0:
        raise AssertionError("silent pcm")
    for name in list(KERNELS) + ["rows_mma", "rows_skinny"]:
        want = (per_frame.get(name, 0) * frames
                + per_prefill.get(name, 0) * (wide if name in WIDE_PREFILL
                                              else prefills))
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
    from pocket_tts_tpu_torch.text.preprocess import prepare_text_prompt
    prepared, _ = prepare_text_prompt(text)
    state, _ = engine._prefill_sentence(engine.prime_voice(voice), prepared)
    return stream_frames(engine, state, n_frames)


# ---------------------------------------------------------------- phase 6 --

def device_ms(fn, iters, warmup=3):
    """(device ms, host ms) per call of fn. Device time: a sleep kernel
    holds the stream while the host queues the calls, so the CUDA events
    around them time the device work back to back, not the host's launch
    rate. It is taken twice, with one sleep ahead of all `iters` calls and
    with one ahead of each call, and the smaller kept: the first runs at
    the host's pace once a call of many small launches fills the CUDA
    launch queue while the device sleeps; the second adds each call's
    start-up latency (~3 us). Host time: wall clock per call of a
    synchronised run."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    host = (time.perf_counter() - t0) / iters

    def held(per_sleep):
        events = []
        for _ in range(iters // per_sleep):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            # hold the stream ~2x the time the host needs to queue the calls
            torch.cuda._sleep(int(2 * host * per_sleep * 2e9))
            a.record()
            for _ in range(per_sleep):
                fn()
            b.record()
            events.append((a, b))
        torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b in events) / iters

    return min(held(iters), held(1)), host * 1e3


def time_decode(engines, voice, n_frames=100, rounds=3, text=BENCH_TEXT):
    """Frames/s of the frame loop as the engine runs it (one host sync per
    frame for the EOS decision) and of the same frames with the EOS read
    left out (no per-frame sync), after prefill, for each of `engines`
    ({label: engine}) in turns: the order of the engines flips every
    round. Returns {label: {"sync": [fps...], "nosync": [fps...]}} (host
    clock around work that ends in a synchronize)."""
    import torch
    from pocket_tts_tpu_torch.text.preprocess import prepare_text_prompt
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


# H100 SXM peaks (NVIDIA data sheet, dense rates): HBM3 bytes/s and the
# FLOP/s of the inputs' type (bf16 on the tensor cores, f32 outside them)
HBM_BYTES_S = 3.35e12
PEAK_FLOPS = {"bf16": 989e12, "f32": 67e12}


def bound_ms(nbytes, flops, dtype_name="bf16"):
    """(least ms the card could take, "bytes" or "operations"): the larger
    of the bytes over the HBM rate and the operations over the peak rate
    for the inputs' type."""
    t_b = nbytes / HBM_BYTES_S
    t_f = flops / PEAK_FLOPS[dtype_name]
    return max(t_b, t_f) * 1e3, ("bytes" if t_b >= t_f else "operations")


def _nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


def _tree_bytes(tree):
    if isinstance(tree, dict):
        return sum(_tree_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_tree_bytes(v) for v in tree)
    return _nbytes(tree)


def _linear_flops(tree, t):
    """2 * t * K * N summed over the linears of a params subtree (the
    logical K: a packed int4 row holds two)."""
    if not isinstance(tree, dict):
        return 0
    for key, mult in (("w", 1), ("q", 1), ("q4", 2)):
        if key in tree:
            k, n = tree[key].shape[-2:]
            return 2 * t * (tree[key].numel() // n) * mult * n
    return sum(_linear_flops(v, t) for v in tree.values())


def seanet_work(weights, cfg, state, z, b=1):
    """(bytes, flops) of one K3 frame over b lanes: every conv weight read
    once, the latents in, the pcm out, the 8 carries read and written."""
    sc, t = cfg.mimi.seanet, cfg.mimi.upsample_stride
    w0 = weights["model_0"][0]
    flops = 2 * b * t * w0.shape[0] * w0.shape[1]
    m = b * t
    for st, (tr, rn) in zip(sc.stages, (("model_2", "model_3"),
                                        ("model_5", "model_6"),
                                        ("model_8", "model_9"))):
        w2 = weights[tr][0]
        wr, _, wc, _ = weights[rn]
        flops += 2 * m * w2.shape[0] * w2.shape[1]
        m *= st.stride
        flops += 2 * m * (wr.shape[0] * wr.shape[1]
                          + wc.shape[0] * wc.shape[1])
    w11 = weights["model_11"][0]
    flops += 2 * m * w11.shape[0] * w11.shape[1]
    wbytes = sum(_nbytes(*v) for v in weights.values())
    nbytes = (wbytes + _nbytes(z) + m * sc.out_ch * z.element_size()
              + 2 * sum(_nbytes(c) for c in state.values()))
    return nbytes, flops


def _heads(c, h):
    """(S, H*D) or (B, S, H*D) flat rows -> a (B, H, S, D) view."""
    c = c if c.dim() == 3 else c[None]
    b, s, hd = c.shape
    return c.view(b, s, h, hd // h).transpose(1, 2)


def sdpa_call(q, k, v, mask):
    """torch's scaled_dot_product_attention: the library yardstick of K1,
    K2 and K7 (timed here, never called by the port)."""
    import torch.nn.functional as F
    return F.scaled_dot_product_attention(q, k, v, attn_mask=mask)


def _row(kernel, plain, lib, bound, shape):
    return {"k": kernel, "plain": plain, "lib": lib, "bound": bound,
            "shape": shape}


def time_kernels(engine, device, dtype):
    """Device time of K1, K2, K3 and K7 against their plain versions and
    the library call (SDPA with the kernel's mask, on a cache that already
    holds the new rows), with each call's bound: {name: [rows]}, the first
    row of each name the one the JSON line reports; and K3's plan sweep
    (time_k3_plans) and table of launches (time_k3_launches), logged."""
    import torch
    from pocket_tts_tpu_torch.models import mimi, seanet
    from pocket_tts_tpu_torch.ops.attention import ring_cache_bias
    from pocket_tts_tpu_torch.ops.decode_attn import (decode_attention,
                                                      decode_attention_plain)
    from pocket_tts_tpu_torch.ops.insert_attn import (
        decode_insert_attention, decode_insert_attention_plain)
    from pocket_tts_tpu_torch.ops.ring_attn import (
        ring_insert_attention, ring_insert_attention_plain)
    from pocket_tts_tpu_torch.ops.seanet_frame import seanet_frame
    g = torch.Generator(device="cpu").manual_seed(4)
    cfg = engine.cfg
    dn = _dt_name(dtype)
    isz = torch.tensor([], dtype=dtype).element_size()
    out = {}
    # K1 at the benchmark sentence's bucket: S = 384, ~300 live slots
    h, d, s, end = 16, 64, 384, 300
    k = torch.randn(s, h * d, generator=g).to(device, dtype)
    v = torch.randn(s, h * d, generator=g).to(device, dtype)
    q = torch.randn(h, d, generator=g).to(device, dtype)
    pos = torch.arange(s, dtype=torch.int32)
    pos[end + 1:] = -1
    pos = pos.to(device)
    mask = (pos >= 0)[None, None, None, :]
    out["decode_attn"] = [_row(
        device_ms(lambda: decode_attention(q, k, v, pos, end), 200),
        device_ms(lambda: decode_attention_plain(q, k, v, pos, end), 50),
        device_ms(lambda: sdpa_call(q[None, :, None], _heads(k, h),
                                    _heads(v, h), mask), 200)[0],
        # K and V of the live slots and their positions read, q in, the
        # output out; 2 flops per multiply-add in the scores and in PV
        bound_ms((2 * (end + 1) + 2) * h * d * isz + 4 * (end + 1),
                 4 * (end + 1) * h * d, dn),
        f"S={s} end={end} H={h} D={d}")]
    # K2 at a wrapped ring, solo and over 32 lanes with distinct starts
    h, d, cap, t = 8, 64, 256, 16
    ctx = cfg.mimi.transformer.context
    out["ring_attn"] = []
    for b in (1, LANES):
        kc = torch.randn(b, cap, h * d, generator=g).to(device, dtype)
        vc = torch.randn(b, cap, h * d, generator=g).to(device, dtype)
        q, kn, vn = (torch.randn(b, t, h * d, generator=g).to(device, dtype)
                     for _ in range(3))
        if b == 1:
            kc, vc, q, kn, vn = kc[0], vc[0], q[0], kn[0], vn[0]
            st = 0
            bias = ring_cache_bias(t, cap, 4096, ctx, device=device)
        else:
            st = (torch.arange(b, dtype=torch.int32) * 64).to(device)
            bias = ring_cache_bias(t, cap, 4096, ctx, start=st[:, None, None],
                                   device=device)[:, None]
        mask = bias == 0
        # per lane: the ring and the new rows read once, q in, the output
        # out, the new rows written; every query scores cap + t keys
        hd = h * d
        nb = b * (2 * (cap + t) + 2 * t + 2 * t) * hd * isz
        fl = 4 * b * t * (cap + t) * hd
        out["ring_attn"].append(_row(
            device_ms(lambda: ring_insert_attention(q, kn, vn, kc, vc, 4096,
                                                    st, h, ctx), 200),
            device_ms(lambda: ring_insert_attention_plain(
                q, kn, vn, kc, vc, 4096, st, h, ctx), 20),
            device_ms(lambda: sdpa_call(_heads(q, h), _heads(kc, h),
                                        _heads(vc, h), mask), 200)[0],
            bound_ms(nb, fl, dn),
            f"B={b} cap={cap} T={t} H={h} D={d} offset=4096"))
    # K3: one frame of the full decoder, solo and over 32 lanes
    sc, tpf = cfg.mimi.seanet, cfg.mimi.upsample_stride
    dec = engine.params["mimi"]["decoder"]
    out["seanet_frame"] = []
    for b in (1, LANES):
        if b == 1:
            stt = seanet.init_state(sc, tpf, dtype, device)
            z = torch.randn(tpf, sc.in_ch, generator=g).to(device, dtype)
        else:
            stt = mimi.init_state_lanes(cfg.mimi, b, dtype, device).seanet
            z = torch.randn(b, tpf, sc.in_ch, generator=g).to(device, dtype)
        out["seanet_frame"].append(_row(
            device_ms(lambda: seanet_frame(dec, sc, stt, z,
                                           engine.seanet_weights), 30),
            device_ms(lambda: seanet.forward_plain(dec, sc, stt, z), 5),
            None,
            bound_ms(*seanet_work(engine.seanet_weights, cfg, stt, z, b),
                     dn),
            f"B={b} z=({tpf}, {sc.in_ch}) -> {tpf * sc.total_stride} "
            "samples per lane"))
    for b, rows in time_k3_plans(engine, device, dtype).items():
        log(f"  K3 plans at B={b} (device us of each conv-GEMM, k3_plan's "
            "tile and splits against the fastest of all): " + "; ".join(
                f"{name} {plan} {times[plan]:.2f}, fastest "
                f"{min(times, key=times.get)} {min(times.values()):.2f}"
                for name, _, plan, times in rows))
    for b, rows in time_k3_launches(engine, device, dtype).items():
        log(f"  K3 launches at B={b} (device us; [torch.matmul at the same "
            f"M, N, K, informative only]): " + "; ".join(
                f"{name} ({m}, {n}, {k}) {us:.2f}"
                + ("" if mm is None else f" [{mm:.2f}]")
                for name, (m, n, k), us, mm in rows)
            + f"; sum {sum(r[2] for r in rows):.2f}")
    # K7 at the serving shapes: 32 lanes, S = 1024, ring mode (every slot
    # read) and linear mode
    out["decode_insert_attn"] = []
    for mode in ("ring", "linear"):
        q, kn, vn, cur, kc, vc, pos, re_, ws = k7_case(g, device, dtype,
                                                       mode)
        b, h, d = q.shape
        mask = (torch.arange(pos.shape[1], device=device) <= re_) & (pos >= 0)
        # this run's data: the K and V rows of the attended slots, q in,
        # the output and the new rows out, the positions read
        nread = int(mask.sum())
        hd = h * d
        nb = ((2 * nread + 2 * b + 2 * b) * hd * isz
              + 4 * b * (re_ + 2))
        out["decode_insert_attn"].append(_row(
            device_ms(lambda: decode_insert_attention(
                q, kn, vn, cur, kc, vc, pos, re_, ws), 200),
            device_ms(lambda: decode_insert_attention_plain(
                q, kn, vn, cur, kc, vc, pos, re_, ws), 20),
            device_ms(lambda: sdpa_call(q[:, :, None], _heads(kc, h),
                                        _heads(vc, h),
                                        mask[:, None, None, :]), 200)[0],
            bound_ms(nb, 4 * nread * hd, dn),
            f"{mode} B={b} S={pos.shape[1]} read_end={re_} H={h} D={d}"))
    return out


def time_k3_launches(engine, device, dtype):
    """Device us of each launch of K3's frame, solo and over 32 lanes,
    beside torch.matmul's at the same (M, N, K) (informative only: a
    launch also builds its A operand, applies its epilogue and writes its
    carries; None for the overlap-adds): {B: [(name, (M, N, K), us,
    matmul us)]}."""
    import torch
    from pocket_tts_tpu_torch.models import mimi, seanet
    from pocket_tts_tpu_torch.ops.seanet_frame import frame_steps
    g = torch.Generator(device="cpu").manual_seed(27)
    sc, tpf = engine.cfg.mimi.seanet, engine.cfg.mimi.upsample_stride
    res = {}
    for b in (1, LANES):
        st = (seanet.init_state(sc, tpf, dtype, device) if b == 1 else
              mimi.init_state_lanes(engine.cfg.mimi, b, dtype, device).seanet)
        z = torch.randn(b * tpf, sc.in_ch, generator=g).to(device, dtype)
        steps, _ = frame_steps(sc, st, z, engine.seanet_weights, b)
        for _, _, run in steps:     # the frame once, in order
            run()
        rows = []
        for name, (m, n, k), run in steps:
            mm = None
            if k:
                a = torch.randn(m, k, generator=g).to(device, dtype)
                w = torch.randn(k, n, generator=g).to(device, dtype)
                mm = 1e3 * device_ms(lambda: a @ w, 100)[0]
            rows.append((name, (m, n, k), 1e3 * device_ms(run, 100)[0], mm))
        res[b] = rows
    return res


def time_k3_plans(engine, device, dtype):
    """Device us of each conv-GEMM of K3's frame, solo and over 32 lanes,
    at every tile K3 is built for and every split count of its reduction
    (through `ptt_seanet_gemm`): the evidence behind `k3_plan`. Returns
    {B: [(name, (M, N, K), the plan k3_plan takes, {(BM, BN, splits):
    us})]}."""
    import torch
    from pocket_tts_tpu_torch.models import mimi, seanet
    from pocket_tts_tpu_torch.ops import cuda_lib
    from pocket_tts_tpu_torch.ops.seanet_frame import (
        BK, MAX_SPLITS, TILES, frame_launches, gemm_args)
    lib = cuda_lib.library()
    g = torch.Generator(device="cpu").manual_seed(29)
    sc, tpf = engine.cfg.mimi.seanet, engine.cfg.mimi.upsample_stride
    code = cuda_lib.dtype_code(torch.empty(0, dtype=dtype))
    stream = cuda_lib.stream_ptr(device)
    res = {}
    for b in (1, LANES):
        st = (seanet.init_state(sc, tpf, dtype, device) if b == 1 else
              mimi.init_state_lanes(engine.cfg.mimi, b, dtype, device).seanet)
        z = torch.randn(b * tpf, sc.in_ch, generator=g).to(device, dtype)
        launches, _ = frame_launches(sc, st, z, engine.seanet_weights, b)
        rows = []
        for name, kind, sp in launches:
            if kind != "gemm":
                continue
            (m, n), k = sp["out"].shape, sp["w"].shape[0]
            kt = -(-k // BK)
            times = {}
            for bm, bn in TILES:
                if bm > 16 and bm // 2 >= m:
                    continue
                for sp_ in range(1, MAX_SPLITS + 1):
                    if sp_ > kt or (sp_ - 1) * -(-kt // sp_) >= kt:
                        continue
                    args = gemm_args(sp, b, (bm, bn, sp_), code, stream)
                    times[bm, bn, sp_] = 1e3 * device_ms(
                        lambda: cuda_lib.check(lib.ptt_seanet_gemm(*args),
                                               "ptt_seanet_gemm"), 30)[0]
            rows.append((name, (m, n, k), tuple(sp["plan"]), times))
        res[b] = rows
    return res


def kernel_times(device):
    """Device us of K3 (bf16 and f32, solo and 32 lanes), K7 (bf16 ring
    and linear, B=32, S=1024; int8 ring, B=32, S=896, with and without the
    statistics) at time_kernels' shapes, of K5a, K5b and K6
    (quant_kernel_times), and of K5b solo, K5c, K8 and K4b
    (coop_kernel_times), through the public wrappers only
    (`seanet_frame`, `decode_insert_attention`, `pre_attention`,
    `post_attention`, `flow_forward`, `bilayer_post_pre`, `megalayer`,
    `int8_matmul`, `int4_matmul`): {label: us}. Run from
    another checkout's root with this script copied there, it times that
    checkout's kernels the same way, so that two versions compare inside
    one call."""
    import torch
    from pocket_tts_tpu_torch.config import DEFAULT_CONFIG
    from pocket_tts_tpu_torch.io.params import random_params
    from pocket_tts_tpu_torch.models import mimi, seanet
    from pocket_tts_tpu_torch.ops.insert_attn import decode_insert_attention
    from pocket_tts_tpu_torch.ops.seanet_frame import (prep_weights,
                                                       seanet_frame)
    g = torch.Generator(device="cpu").manual_seed(28)
    res = {}
    for dtype in (torch.bfloat16, torch.float32):
        p, cfg = random_params(DEFAULT_CONFIG, seed=0, dtype=dtype,
                               device=device)
        dec, sc = p["mimi"]["decoder"], cfg.mimi.seanet
        tpf, w = cfg.mimi.upsample_stride, prep_weights(dec, sc)
        for b in (1, LANES):
            st = (seanet.init_state(sc, tpf, dtype, device) if b == 1 else
                  mimi.init_state_lanes(cfg.mimi, b, dtype, device).seanet)
            z = torch.randn(*((b,) if b > 1 else ()), tpf, sc.in_ch,
                            generator=g).to(device, dtype)
            res[f"K3 {_dt_name(dtype)} B={b}"] = 1e3 * device_ms(
                lambda: seanet_frame(dec, sc, st, z, w), 30)[0]
        del p, dec, w
    for mode in ("ring", "linear"):
        q, kn, vn, cur, kc, vc, pos, re_, ws = k7_case(g, device,
                                                       torch.bfloat16, mode)
        res[f"K7 bf16 {mode} B={LANES} S=1024"] = 1e3 * device_ms(
            lambda: decode_insert_attention(q, kn, vn, cur, kc, vc, pos, re_,
                                            ws), 200)[0]
    for stats in (False, True):
        (q, kn, vn, cur, k, v, pos, re_, ws, ks, vs, ksn,
         vsn) = k7_kv8_case(g, device, torch.bfloat16, "ring")
        res[f"K7 int8{' stats' if stats else ''} ring B={LANES} S=896"] = \
            1e3 * device_ms(lambda: decode_insert_attention(
                q, kn, vn, cur, k, v, pos, re_, ws, ks, vs, ksn, vsn,
                stats=stats), 200)[0]
    return coop_kernel_times(device, quant_kernel_times(device, res))


def _dense(lin, dtype):
    """The dequantized (K, N) weight of a quantized linear, in dtype: the
    operand of the dense reference (torch.matmul), never used by the
    port."""
    from pocket_tts_tpu_torch.ops.quant_matmul import unpack_int4
    if "q" in lin:
        return (lin["q"].float() * lin["scale"].float()).to(dtype)
    w = unpack_int4(lin["q4"])
    s = lin["scale"].float()
    if s.dim() == w.dim():
        s = s.repeat_interleave(w.shape[-2] // s.shape[-2], dim=-2)
    return (w * s).to(dtype)


def quant_kernel_times(device, res):
    """Device us of K5a / K5b over many rows and of K6 through their public
    wrappers, at PERF.md's shapes, on DEFAULT_CONFIG's weights quantized to
    int8, int4 and q4_0, bf16: K5a at T = 1 (backbone) and T = 16 (mimi),
    K5a and K5b over 32 backbone and 512 mimi rows, K6 solo and over 32
    rows. Beside each, "dense": torch.matmul in bf16 over the dequantized
    weights for the same products (K5b: its three; K6: every linear of the
    net), a dense tensor-core reference, not a library yardstick (no single
    call computes the quantized function). Added to res ({label: us})."""
    import torch
    from pocket_tts_tpu_torch.config import DEFAULT_CONFIG
    from pocket_tts_tpu_torch.io.params import random_params
    from pocket_tts_tpu_torch.io.quant import quantize_params
    from pocket_tts_tpu_torch.ops import fused_flow, fused_layer
    from pocket_tts_tpu_torch.ops.basic import slice_layer_params
    dt = torch.bfloat16
    p0, cfg = random_params(DEFAULT_CONFIG, seed=0, dtype=dt, device=device)
    rng = np.random.RandomState(31)
    us = lambda fn, n=50: 1e3 * device_ms(fn, n)[0]
    for path in QUANT_PATHS:
        pq = quantize_params(p0, **QUANTIZE[path])
        bb = slice_layer_params(pq["layers"], 0)
        mt = slice_layer_params(pq["mimi"]["decoder_transformer"]["layers"],
                                0)
        for p, rows, t, eps, name in (
                (bb, 1, 1, 1e-5, "backbone T=1"),
                (mt, 16, 16, cfg.mimi.transformer.norm_eps, "mimi T=16"),
                (bb, LANES, 1, 1e-5, f"backbone rows={LANES}"),
                (mt, LANES * 16, 16, cfg.mimi.transformer.norm_eps,
                 f"mimi rows={LANES * 16}")):
            dm = p["norm1"]["scale"].shape[0]
            lead = (rows // t, t) if rows > t else (t,)
            x = _rand(rng, device, dt, *lead, dm, scale=0.5)
            attn = _rand(rng, device, dt, *lead, dm, scale=0.5)
            a2 = x.reshape(-1, dm)
            w_in = _dense(p["in_proj"], dt)
            res[f"K5a {path} {name}"] = us(
                lambda: fused_layer.pre_attention(p, x, eps))
            res[f"K5a {path} {name} dense"] = us(lambda: a2 @ w_in)
            if rows == t:
                continue
            wo, w1, w2 = (_dense(p[k], dt) for k in ("out_proj", "linear1",
                                                      "linear2"))
            hh = _rand(rng, device, dt, rows, w1.shape[1], scale=0.5)
            res[f"K5b {path} {name}"] = us(
                lambda: fused_layer.post_attention(p, x, attn, eps), 20)
            res[f"K5b {path} {name} dense"] = us(
                lambda: (a2 @ wo, a2 @ w1, hh @ w2), 20)
        fp, fcfg = pq["flow_net"], cfg.flow
        tc = _rand(rng, device, dt, fcfg.dim)
        rb = fp["res_blocks"]
        dense = ([_dense(fp["cond_embed"], dt), _dense(fp["input_proj"], dt)
                  if "w" not in fp["input_proj"] else fp["input_proj"]["w"]]
                 + [_dense(slice_layer_params(rb, i)[k], dt)
                    for i in range(fcfg.depth)
                    for k in ("adaln", "mlp_0", "mlp_2")]
                 + [_dense(fp["final"]["adaln"], dt),
                    _dense(fp["final"]["linear"], dt)
                    if "w" not in fp["final"]["linear"]
                    else fp["final"]["linear"]["w"]])
        for b in (None, LANES):
            shape = () if b is None else (b,)
            c = _rand(rng, device, dt, *shape, cfg.backbone.d_model)
            x = _rand(rng, device, dt, *shape, cfg.latent_dim)
            ins = [_rand(rng, device, dt, b or 1, w.shape[0]) for w in dense]
            label = "solo" if b is None else f"rows={b}"
            res[f"K6 {path} {label}"] = us(
                lambda: fused_flow.flow_forward(fp, c, x, tc))
            res[f"K6 {path} {label} dense"] = us(
                lambda: [a @ w for a, w in zip(ins, dense)])
    return res


def finish_bench(lin, h, x1, ls2, mode, ks, dtype):
    """One launch of csrc/coop_bench.cu at T = 1: y = round(x1 + ls2 *
    ((h @ W2) * s2 + b2)) (1, dm) in dtype; mode 0 the layer tail's own
    way (each block's MLP tiles' rows of W2 to a partial, summed by
    warps), 1 W2 split by output columns in ks slices of its rows. None
    when the layout does not fit in a block's shared memory."""
    import ctypes
    import torch
    from pocket_tts_tpu_torch.ops import cuda_lib
    from pocket_tts_tpu_torch.ops import fused_layer as fl
    from pocket_tts_tpu_torch.ops.quant_matmul import kernel_operands
    hid, dm = h.shape[-1], x1.shape[-1]
    y = torch.empty(1, dm, dtype=dtype, device=h.device)
    (w, s, b), (kind, group) = kernel_operands(lin, hid, dm, y)
    grid = min(fl.COOP_MAX_GRID, hid // fl.COOP_TILE)
    if mode == 0:
        units = -(-(hid // fl.COOP_TILE) // grid)
        unit = fl.mlp_tile_bytes(kind, dm, group)[1]
    else:
        units = -(-(dm // fl.COOP_TILE) * ks // grid)
        unit = fl.col_unit_bytes(kind, hid, ks, group)
    o_act = fl.align128(units * unit)
    smem = (o_act + 4 * (hid + fl.COOP_RED_FLOATS + fl.COOP_TILE)
            + fl.SMEM_SLACK)
    if smem > fl.SMEM_MAX:
        return None
    f32 = dict(dtype=torch.float32, device=h.device)
    ptrs = [h, x1, ls2, w, s, b, torch.empty(grid, dm, **f32),
            torch.empty(hid, **f32), torch.empty(ks, dm, **f32), y]
    plan = [mode, grid, ks, fl.finish_vec(1, dm, grid), smem, o_act]
    cuda_lib.check(cuda_lib.library().ptt_finish_bench(
        (ctypes.c_void_p * len(ptrs))(*[None if t is None else t.data_ptr()
                                        for t in ptrs]),
        (ctypes.c_int * 2)(kind, group), (ctypes.c_int * 6)(*plan), dm, hid,
        cuda_lib.dtype_code(y), cuda_lib.stream_ptr(h.device)),
        f"ptt_finish_bench (plan {plan})")
    return y


def finish_times(path, bls, device, dtype, res, two_ways):
    """The backbone's MLP down projection and cross-block sum at T = 1
    both ways (finish_bench): mode 0 ("rows", what K5b, K5c and K8 run)
    and mode 1 ("cols") at one slice and at the slices col_split picks,
    each checked against the plain version (TOL quant) and timed one layer
    repeated and in frame order (two_ways)."""
    import torch
    from pocket_tts_tpu_torch.ops import fused_layer as fl
    from pocket_tts_tpu_torch.ops.quant_matmul import kernel_operands
    rng = np.random.RandomState(45)
    lins = [p["linear2"] for p in bls]
    hid = bls[0]["linear1"]["scale"].shape[-1]
    dm = lins[0]["scale"].shape[-1]
    h = _rand(rng, device, dtype, hid, scale=0.5).float()
    x1 = _rand(rng, device, torch.float32, 1, dm)
    ls2 = bls[0].get("layer_scale_2", {}).get("scale")
    plain = (x1 + (1.0 if ls2 is None else ls2.float())
             * fl._deq(h[None], lins[0])).to(dtype)
    scale = plain.float().abs().max().item()
    _, (kind, group) = kernel_operands(lins[0], hid, dm, plain)
    stored = hid // 2 if "q4" in lins[0] else hid
    grid = min(fl.COOP_MAX_GRID, hid // fl.COOP_TILE)
    split = fl.col_split(dm // fl.COOP_TILE, stored, grid, group)
    for mode, ks, label in ((0, 1, "rows"), (1, 1, "cols ks=1"),
                            (1, split, f"cols ks={split}")):
        if label == "cols ks=1" and split == 1:
            continue
        y = finish_bench(lins[0], h, x1, ls2, mode, ks, dtype)
        if y is None:
            log(f"  finish {label} {path}: does not fit in shared memory")
            continue
        err = (y.float() - plain.float()).abs().max().item() / scale
        if not err <= TOL[("quant", _dt_name(dtype))]:
            raise AssertionError(f"finish {label} {path}: {err:.3e} of "
                                 f"max|plain|")
        two_ways(f"finish {label} {path} backbone T=1",
                 [lambda l=l: finish_bench(l, h, x1, ls2, mode, ks, dtype)
                  for l in lins],
                 _tree_bytes(lins[0]) + _nbytes(h, x1, y), 2 * hid * dm)


def barrier_times(device, res):
    """What a grid barrier costs (csrc/coop_bench.cu ptt_barrier_bench):
    one cooperative launch of 128 blocks (the backbone's grid) with 1 and
    with 101 barriers: grid.sync(); grid.sync() in a launch with clusters
    of 2, each followed by a cluster barrier; and a hand-written barrier
    (one arrival counter, release / acquire). A barrier's cost is the
    difference over 100. Added to res ({label: us})."""
    import torch
    from pocket_tts_tpu_torch.ops import cuda_lib
    lib, stream = cuda_lib.library(), cuda_lib.stream_ptr(device)
    bar = torch.zeros(2, dtype=torch.int32, device=device)
    for kind, label in ((0, "grid barrier"),
                        (1, "grid + cluster barrier, clusters of 2"),
                        (2, "hand-written grid barrier")):
        t = {}
        for n in (1, 101):
            t[n] = 1e3 * device_ms(lambda n=n: cuda_lib.check(
                lib.ptt_barrier_bench(n, 128, kind, bar.data_ptr(), stream),
                "ptt_barrier_bench"), 120)[0]
        res[f"{label}: launch with one"] = t[1]
        res[f"{label}: each"] = (t[101] - t[1]) / 100
    sync(device)
    if bar[0].item() != 0 or bar[1].item() == 0:  # every arrival matched
        raise AssertionError(f"hand-written barrier left {bar.tolist()}")


def coop_kernel_times(device, res):
    """Device us of the cooperative kernels through their public wrappers
    (`post_attention`, `bilayer_post_pre`, `megalayer`), bf16, on
    DEFAULT_CONFIG's weights: K5b solo at T = 1 (backbone) and T = 16
    (mimi) with int8, int4 and q4_0; K5c with int4 and q4_0; K8 with int8
    and int4, caches of bf16 and int8 (S = 384, end = 300). Each two ways:
    "layer", one layer repeated (its weights stay in L2), and "frame", the
    six backbone layers (K5c: the five layer pairs; mimi: the two layers)
    one after another, as a frame streams them; beside each, "bound": one
    call's bytes (weights and activations once, each cache row read once)
    at 3.35 TB/s. K5a at T = 1 (backbone, int8, int4, q4_0) the same two
    ways. Also K4b at T = 1 (K = 32, N = 1024) and at T = 128 on the four
    prefill linears (in_proj 1024 x 3072, out_proj 1024 x 1024, linear1
    1024 x 4096, linear2 4096 x 1024) beside torch._weight_int4pack_mm
    (int4pack_ms) and its bound; K4a (int8) the same at T = 1 and at 64,
    128 and 256 rows beside torch._weight_int8pack_mm (int8pack_ms), its
    bound and the dense bf16 product, and, where the tree has the
    warpgroup kernel, its plan sweep (time_k4a_plans); and the device
    time of one prefill call of 128 rows through the six layers (24 K4a
    or K4b launches) for int8, int4 and q4_0. Where the tree
    has csrc/coop_bench.cu, also what a grid barrier costs
    (barrier_times) and the MLP's down projection with its cross-block
    sum both ways (finish_times). Added to res ({label: us})."""
    import itertools
    import torch
    from pocket_tts_tpu_torch.config import DEFAULT_CONFIG
    from pocket_tts_tpu_torch.io.params import random_params
    from pocket_tts_tpu_torch.io.quant import quantize_params
    from pocket_tts_tpu_torch.models import backbone, flow_lm
    from pocket_tts_tpu_torch.ops import cuda_lib, fused_layer, fused_step
    from pocket_tts_tpu_torch.ops.basic import slice_layer_params
    from pocket_tts_tpu_torch.ops.rope import rope_cos_sin
    dt = torch.bfloat16
    p0, cfg = random_params(DEFAULT_CONFIG, seed=0, dtype=dt, device=device)
    bb, mt = cfg.backbone, cfg.mimi.transformer
    rng = np.random.RandomState(43)
    g = torch.Generator(device="cpu").manual_seed(44)
    us = lambda fn: 1e3 * device_ms(fn, 120)[0]
    if "ptt_barrier_bench" in cuda_lib.SIGNATURES:  # not in older trees
        barrier_times(device, res)

    def two_ways(label, calls, nbytes, flops):
        """calls: one per layer, frame order; the first repeated, then
        all in turn."""
        res[f"{label} layer"] = us(calls[0])
        cyc = itertools.cycle(calls)
        res[f"{label} frame"] = us(lambda: next(cyc)())
        res[f"{label} bound"] = 1e3 * bound_ms(nbytes, flops)[0]

    for path in QUANT_PATHS:
        pq = quantize_params(p0, **QUANTIZE[path])
        bls = [slice_layer_params(pq["layers"], l)
               for l in range(bb.num_layers)]
        mls = [slice_layer_params(pq["mimi"]["decoder_transformer"]["layers"],
                                  l) for l in range(mt.num_layers)]
        for ls, t, dm, eps, name in (
                (bls, 1, bb.d_model, 1e-5, "backbone T=1"),
                (mls, 16, mt.d_model, mt.norm_eps, "mimi T=16")):
            x = _rand(rng, device, dt, t, dm, scale=0.5)
            a = _rand(rng, device, dt, t, dm, scale=0.5)
            post = {k: v for k, v in ls[0].items()
                    if k not in ("norm1", "in_proj")}
            two_ways(f"K5b {path} {name}",
                     [lambda p=p: fused_layer.post_attention(p, x, a, eps)
                      for p in ls],
                     _tree_bytes(post) + _nbytes(x, a) * 3 // 2,
                     _linear_flops(post, t))
        if "ptt_finish_bench" in cuda_lib.SIGNATURES:  # not in older trees
            finish_times(path, bls, device, dt, res, two_ways)
        dm = bb.d_model
        x = _rand(rng, device, dt, 1, dm, scale=0.5)
        a = _rand(rng, device, dt, 1, dm, scale=0.5)
        pre = {k: bls[0][k] for k in ("norm1", "in_proj")}
        two_ways(f"K5a {path} backbone T=1",
                 [lambda p=p: fused_layer.pre_attention(p, x)
                  for p in bls],
                 _tree_bytes(pre) + _nbytes(x) * 4, _linear_flops(pre, 1))
        if path != "int8":
            post = {k: v for k, v in bls[0].items()
                    if k not in ("norm1", "in_proj")}
            pre = {k: bls[1][k] for k in ("norm1", "in_proj")}
            two_ways(f"K5c {path}",
                     [lambda p0=p0_, p1=p1_: fused_layer.bilayer_post_pre(
                         p0, p1, x, a) for p0_, p1_ in zip(bls, bls[1:])],
                     _tree_bytes(post) + _tree_bytes(pre) + _nbytes(x) * 6,
                     _linear_flops(post, 1) + _linear_flops(pre, 1))
        # K4b (int4, q4_0) and K4a (int8, also at 64 and 256 rows, with
        # the dense bf16 product beside it) through their wrappers
        _, mm, _, key = quant_matmul_fns(path)
        tag = "K4a" if path == "int8" else "K4b"
        cases = [(pq["input_linear"], 1)] + [
            (bls[0][k], t) for t in ((64, 128, 256) if path == "int8"
                                     else (128,))
            for k in ("in_proj", "out_proj", "linear1", "linear2")]
        for lin, t in cases:
            kdim = lin[key].shape[0] * (2 if key == "q4" else 1)
            xi = _rand(rng, device, dt, t, kdim)
            y = mm(xi, lin[key], lin["scale"])
            shape = f"T={t} K={kdim} N={y.shape[-1]}"
            res[f"{tag} {path} {shape}"] = us(
                lambda: mm(xi, lin[key], lin["scale"]))
            lib = (int8pack_ms(xi, lin["q"], lin["scale"]) if key == "q"
                   else int4pack_ms(xi, lin, y))
            res[f"{tag} {path} {shape} library"] = (
                None if lib is None else 1e3 * lib)
            res[f"{tag} {path} {shape} bound"] = 1e3 * bound_ms(
                _tree_bytes(lin) + _nbytes(xi, y),
                _linear_flops(lin, t))[0]
            if key == "q" and t > 1:
                w = _dense(lin, dt)
                res[f"{tag} {path} {shape} dense"] = us(lambda: xi @ w)
        if path == "int8" and "ptt_wgmma_int8" in cuda_lib.SIGNATURES:
            for (name, t, kdim, n, plan, plans, mma,
                 _, _) in time_k4a_plans(device, pq):
                for (bt, sp), v in plans.items():
                    res[f"K4a sweep {name} T={t} wgmma {bt}x{sp}"] = v
                res[f"K4a sweep {name} T={t} rows_mma"] = mma
            for name, (_, row) in k4a_marks(device, pq).items():
                for key, v in row.items():
                    res[f"K4a marks {name} T=128 {key}"] = v
        st = backbone.init_state(bb, dt, device)
        emb = _rand(rng, device, dt, 128, dm, scale=0.5)

        def prefill():  # the same 128 slots each call
            st.end = st.next_pos = 0
            flow_lm.prefill(pq, cfg, st, emb, 120)

        res[f"prefill {path} T=128"] = us(prefill)
        if path == "q4_0":
            continue
        isz = 2
        for kvq in (False, True):
            end = 300
            cases = [k8_case(g, device, dt, kvq, end=end, dm=dm)
                     for _ in bls]
            cur = cases[0][6]
            cos, sin = rope_cos_sin(cur, bb.head_dim, bb.max_period)
            pos = cases[0][5]
            nread = int(((pos >= 0) & (torch.arange(pos.shape[0],
                                                    device=device)
                                       < end)).sum())
            row = dm * (1 if kvq else isz) + (4 if kvq else 0)
            two_ways(f"K8 {path} {'int8' if kvq else 'bf16'} cache S=384 "
                     f"end={end}",
                     [lambda p=p, c=c: fused_step.megalayer(
                         p, c[0], cos, sin, cur, c[1], c[2], c[5], end, end,
                         c[3], c[4]) for p, c in zip(bls, cases)],
                     _tree_bytes(bls[0]) + 2 * nread * row + 4 * (end + 1)
                     + 2 * dm * isz + 2 * row,
                     _linear_flops(bls[0], 1) + 4 * nread * dm)
    return res


def time_rows_plans(engines, device):
    """Device us of each row-block product of K5a, K5b and K4b on the three
    kernels: rows_kernel (SIMT), rows_mma_kernel at every tile height and
    reduction split that fits, and up to 16 rows skinny_kernel at every
    slice count it takes: the evidence behind `rows_plan`, `skinny_plan`
    and MMA_ROWS (R_min). int4 and int8: K5a's in_proj at 1, 8, 15, 16 and
    32 backbone rows and 16 and 512 mimi rows, K5b's three row-block
    products at 32 and 512 rows; int4 and q4_0: K4b's input_linear at 1
    and 32 rows and its four prefill linears at 1 and 128 rows (the load
    prologue, the rounding epilogue). Returns [(path, linear, rows, K, N,
    SIMT us, the plan rows_plan takes, {(bm, splits): us}, the slice count
    skinny_plan takes (0 above 16 rows), {ks: us})]."""
    import torch
    from pocket_tts_tpu_torch.ops import cuda_lib
    from pocket_tts_tpu_torch.ops import fused_layer as fl
    from pocket_tts_tpu_torch.ops.basic import slice_layer_params
    from pocket_tts_tpu_torch.ops.quant_matmul import kernel_operands
    lib, stream = cuda_lib.library(), cuda_lib.stream_ptr(device)
    rng = np.random.RandomState(33)
    # (path, name, linear, rows, K, N, prologue, epilogue, norm, eps)
    cases = []
    for path in ("int4", "int8"):
        pq, cfg = engines[path].params, engines[path].cfg
        for layers, dm, eps, rows_list in (
                (pq["layers"], cfg.backbone.d_model, 1e-5,
                 (1, 8, 15, 16, LANES)),
                (pq["mimi"]["decoder_transformer"]["layers"],
                 cfg.mimi.transformer.d_model, cfg.mimi.transformer.norm_eps,
                 (16, LANES * 16))):
            p = slice_layer_params(layers, 0)
            hid = p["linear1"]["scale"].shape[-1]
            for rows in rows_list:
                for name, k, n, pro, epi, norm in (
                        ("in_proj", dm, 3 * dm, fl.ROWS_LN, fl.EPI_ROUND,
                         p["norm1"]),
                        ("out_proj", dm, dm, fl.ROWS_LOAD, fl.EPI_RESID_F32,
                         {}),
                        ("linear1", dm, hid, fl.ROWS_LN_F32, fl.EPI_GELU,
                         p["norm2"]),
                        ("linear2", hid, dm, fl.ROWS_LOAD, fl.EPI_RESID, {})):
                    if name == "in_proj" or fl.post_launches(rows, dm) > 1:
                        cases.append((path, name, p[name], rows, k, n, pro,
                                      epi, norm, eps))
    for path in ("int4", "q4_0"):
        pq = engines[path].params
        p = slice_layer_params(pq["layers"], 0)
        for name, lin, rows_list in (
                [("K4b input_linear", pq["input_linear"], (1, LANES))]
                + [(f"K4b {k}", p[k], (1, 128))
                   for k in ("in_proj", "out_proj", "linear1", "linear2")]):
            k, n = 2 * lin["q4"].shape[0], lin["q4"].shape[1]
            for rows in rows_list:
                cases.append((path, name, lin, rows, k, n, fl.ROWS_LOAD,
                              fl.EPI_ROUND, {}, 0.0))
    out = []
    for path, name, lin, rows, k, n, pro, epi, norm, eps in cases:
        a = _rand(rng, device, torch.float32 if pro == fl.ROWS_LN_F32
                  else torch.bfloat16, rows, k)
        res_t = (_rand(rng, device, torch.bfloat16, rows, n)
                 if epi == fl.EPI_RESID_F32 else
                 _rand(rng, device, torch.float32, rows, n)
                 if epi == fl.EPI_RESID else None)
        dst = torch.empty(rows, n, device=device, dtype=(
            torch.float32 if epi == fl.EPI_RESID_F32 else torch.bfloat16))
        (w, sc, bias), (kind, group) = kernel_operands(
            lin, k, n, dst if dst.dtype == torch.bfloat16 else a)
        ptr = lambda t: 0 if t is None else t.data_ptr()
        args = (a.data_ptr(), ptr(norm.get("scale")), ptr(norm.get("bias")),
                w.data_ptr(), ptr(sc), ptr(bias), ptr(res_t), 0,
                dst.data_ptr(), rows, k, n, kind, group, pro, epi, 0,
                float(eps))
        simt = 1e3 * device_ms(lambda: cuda_lib.check(
            lib.ptt_fused_rows(*args, 1, stream), "ptt_fused_rows"), 30)[0]
        packed = kind != 1
        stored = k // 2 if packed else k
        kt = -(-stored // fl.MMA_BKS)
        ln = {fl.ROWS_LN: 2, fl.ROWS_LN_F32: 4}.get(pro, 0)
        plan = fl.rows_plan(rows, k, n, packed, ln)
        times = {}
        for bm in fl.MMA_BMS:
            if bm > 16 and bm // 2 >= rows:
                continue
            for splits in range(1, fl.MMA_MAX_SPLITS + 1):
                per = -(-kt // splits)
                if ((splits - 1) * per >= kt or fl.rows_mma_smem(
                        bm, per, packed, k, ln) > fl.SMEM_MAX):
                    continue
                times[bm, splits] = 1e3 * device_ms(
                    lambda: cuda_lib.check(lib.ptt_rows_mma(
                        *args, bm, splits, per, stream), "ptt_rows_mma"),
                    30)[0]
        skinny, sks = {}, 0
        if rows <= fl.MMA_ROWS:
            sks = fl.skinny_plan(rows, k, n, kind, group, ln > 0)["ks"]
            for ks in fl.skinny_slices(stored, kind, group):
                sp = fl._plan_ints(fl.skinny_plan(rows, k, n, kind, group,
                                                  ln > 0, ks),
                                   fl.SKINNY_PLAN_KEYS)
                skinny[ks] = 1e3 * device_ms(lambda: cuda_lib.check(
                    lib.ptt_rows_skinny(*args, sp, stream),
                    "ptt_rows_skinny"), 30)[0]
        out.append((path, name, rows, k, n, simt, plan, times, sks, skinny))
    return out


def time_flow_clusters(engines, device):
    """Device us of K6 (int4 at 1, 32 and 64 rows; int8 solo) on clusters
    of 16 and of 8 blocks: the evidence behind `flow_cluster`. Returns
    {label: {csize: us}}."""
    import torch
    from pocket_tts_tpu_torch.ops import fused_flow
    rng = np.random.RandomState(35)
    real = fused_flow.flow_cluster
    out = {}
    try:
        for path, rows in (("int4", None), ("int4", LANES), ("int4", 64),
                           ("int8", None)):
            pq, cfg = engines[path].params, engines[path].cfg
            fp, tc = pq["flow_net"], pq["_time_cond"]
            shape = () if rows is None else (rows,)
            c = _rand(rng, device, torch.bfloat16, *shape,
                      cfg.backbone.d_model)
            x = _rand(rng, device, torch.bfloat16, *shape, cfg.latent_dim)
            row = {}
            for csize in fused_flow.CLUSTERS:
                fused_flow.flow_cluster = lambda *a, cs=csize: cs
                row[csize] = 1e3 * device_ms(
                    lambda: fused_flow.flow_forward(fp, c, x, tc), 50)[0]
            out[f"{path} {'solo' if rows is None else f'rows={rows}'}"] = row
    finally:
        fused_flow.flow_cluster = real
    return out


def time_k4a_plans(device, pq):
    """Device us of K4a's product on the four prefill linears of the int8
    tree pq's first backbone layer (in_proj, out_proj, linear1, linear2)
    at 64, 128 and
    256 rows of bf16 x (numpy seed 37), side by side: the warpgroup kernel
    (ptt_wgmma_int8) at every tile height and split `wgmma_plan` takes (each
    held against int8_matmul_plain at TOL quant), rows_mma_kernel at
    rows_plan's plan (the route below WGMMA_ROWS), the dense bf16
    torch.matmul of the same product and torch._weight_int8pack_mm: the
    evidence behind wgmma_plan and WGMMA_ROWS. Returns [(linear, rows, K,
    N, the plan wgmma_plan takes, {(bt, splits): us}, rows_mma us, dense
    us, library us or None)]."""
    import ctypes
    import torch
    from pocket_tts_tpu_torch.ops import cuda_lib
    from pocket_tts_tpu_torch.ops import fused_layer as fl
    from pocket_tts_tpu_torch.ops import quant_matmul as qm
    from pocket_tts_tpu_torch.ops.basic import slice_layer_params
    lib, stream = cuda_lib.library(), cuda_lib.stream_ptr(device)
    p = slice_layer_params(pq["layers"], 0)
    rng = np.random.RandomState(37)
    tol = TOL[("quant", "bf16")]
    out = []
    for rows in (64, 128, 256):
        for name in ("in_proj", "out_proj", "linear1", "linear2"):
            q, sc = p[name]["q"], p[name]["scale"]
            k, n = q.shape
            x = _rand(rng, device, torch.bfloat16, rows, k)
            want = qm.int8_matmul_plain(x, q, sc)
            y = torch.empty(rows, n, device=device, dtype=torch.bfloat16)
            plans = {}
            for bt in qm.WGMMA_BTS:
                for sp in range(1, qm.WGMMA_MAX_SPLITS + 1):
                    if bt == 128 and rows <= 64:
                        continue
                    plan = qm.wgmma_plan(rows, k, n, bt, sp)
                    if (bt, plan["splits"]) in plans:
                        continue
                    keys = (ctypes.c_int * len(qm.WGMMA_PLAN_KEYS))(
                        *[plan[key] for key in qm.WGMMA_PLAN_KEYS])

                    def call():
                        cuda_lib.check(lib.ptt_wgmma_int8(
                            x.data_ptr(), q.data_ptr(), sc.data_ptr(),
                            y.data_ptr(), rows, k, n, keys, 0, stream),
                            "ptt_wgmma_int8")
                    call()
                    sync(device)
                    err = ((y.float() - want.float()).abs().max()
                           / want.float().abs().max()).item()
                    if not err <= tol:
                        raise AssertionError(
                            f"K4a {name} rows={rows} plan {bt}x{sp}: rel "
                            f"error {err} > {tol}")
                    plans[bt, plan["splits"]] = 1e3 * device_ms(call, 30)[0]
            lin, layout = qm.kernel_operands({"q": q, "scale": sc}, k, n, x)
            mma = 1e3 * device_ms(lambda: fl.rows_launch(
                lib, torch.bfloat16, x, (None, None), lin, layout, None,
                None, y, rows, k, n, fl.ROWS_LOAD, fl.EPI_ROUND, False, 0.0,
                stream), 30)[0]
            w = _dense(p[name], torch.bfloat16)
            dense = 1e3 * device_ms(lambda: x @ w, 30)[0]
            lib_ms = int8pack_ms(x, q, sc)
            pl = qm.wgmma_plan(rows, k, n, fits=qm.wgmma_fits(lib))
            out.append((name, rows, k, n, (pl["bt"], pl["splits"]), plans,
                        mma, dense, None if lib_ms is None else 1e3 * lib_ms))
    return out


def k4a_marks(device, pq):
    """Where a warpgroup K4a call's time goes (`marks=` of
    quant_matmul.wgmma_launch, %globaltimer), on the four prefill linears
    of the int8 tree pq's first backbone layer at 128 rows (numpy seed
    39), the plan wgmma_plan takes, the last of three calls: {linear:
    ((bt, splits), {"span": the grid's last exit minus its first entry;
    per block, mean over the grid: "to first landed", "products" (first
    k-block landed to products done), "epilogue" (products done to exit),
    and the ns each role waited: WGMMA_MARKS[4:]}), all in us}."""
    import torch
    from pocket_tts_tpu_torch.ops import cuda_lib
    from pocket_tts_tpu_torch.ops import quant_matmul as qm
    from pocket_tts_tpu_torch.ops.basic import slice_layer_params
    p = slice_layer_params(pq["layers"], 0)
    rng = np.random.RandomState(39)
    lib, stream = cuda_lib.library(), cuda_lib.stream_ptr(device)
    out = {}
    for name in ("in_proj", "out_proj", "linear1", "linear2"):
        q, sc = p[name]["q"], p[name]["scale"]
        k, n = q.shape
        x = _rand(rng, device, torch.bfloat16, 128, k)
        y = torch.empty(128, n, device=device, dtype=torch.bfloat16)
        plan = qm.wgmma_plan(128, k, n, fits=qm.wgmma_fits(lib))
        mk = torch.zeros(int(np.prod(plan["grid"])), len(qm.WGMMA_MARKS),
                         dtype=torch.int64, device=device)
        for _ in range(3):
            qm.wgmma_launch(lib, x, q, sc, y, 128, k, n, stream, marks=mk)
        sync(device)
        m = mk.cpu().numpy().astype(np.float64) / 1e3
        row = {"span": m[:, 3].max() - m[:, 0].min(),
               "to first landed": (m[:, 1] - m[:, 0]).mean(),
               "products": (m[:, 2] - m[:, 1]).mean(),
               "epilogue": (m[:, 3] - m[:, 2]).mean()}
        for i, key in enumerate(qm.WGMMA_MARKS[4:], 4):
            row[key] = m[:, i].mean()
        out[name] = (plan["bt"], plan["splits"]), row
    return out


def int8pack_ms(x, q, scale):
    """Device ms of torch._weight_int8pack_mm(x, q^T, scale), one PyTorch
    call computing K4a's function (x @ int8 W times per-channel scales; the
    library yardstick, never called by the port), or None when this torch
    has no CUDA kernel for it (the reason is logged)."""
    import torch
    w, sc = q.t().contiguous(), scale.to(x.dtype)
    try:
        torch._weight_int8pack_mm(x, w, sc)
        torch.cuda.synchronize()
    except (RuntimeError, NotImplementedError) as e:
        log(f"  K4a library: none (`_weight_int8pack_mm` has no CUDA kernel "
            f"in torch {torch.__version__}: {str(e).splitlines()[0][:120]})")
        return None
    return device_ms(lambda: torch._weight_int8pack_mm(x, w, sc), 200)[0]


def int4pack_ms(x, lin, want):
    """Device ms of torch._weight_int4pack_mm, one PyTorch call computing
    K4b's function (x @ the int4 W with its scales; the library yardstick,
    never called by the port), or None (the reason logged) when this torch
    has no CUDA kernel for it or its result differs from `want` (K4b's).
    The packing is set up here, outside the timed region: the signed
    nibbles q become u = q + 8 (PyTorch dequantizes (u - 8) * scale +
    zero), zeros 0; per-channel scales repeated over groups of 256 rows
    (K = 32: one group of 32), q4_0's grouped scales as groups of 32."""
    import torch
    from pocket_tts_tpu_torch.ops.quant_matmul import grouped, unpack_int4
    w = unpack_int4(lin["q4"]).to(torch.int32)            # (K, N)
    k, n = w.shape
    u = (w + 8).t().contiguous()                           # (N, K) 0..15
    packed = (u[:, ::2] << 4 | u[:, 1::2]).to(torch.uint8)
    if grouped(lin):
        gsz, sc = k // lin["scale"].shape[0], lin["scale"].float()
    else:
        gsz = min(256, k)
        sc = lin["scale"].float()[None].expand(k // gsz, n)
    sz = torch.stack([sc, torch.zeros_like(sc)], -1).to(x.dtype).contiguous()
    inner = 8 if k % 128 == 0 else 2
    try:
        wp = torch._convert_weight_to_int4pack(packed, inner)
        got = torch._weight_int4pack_mm(x, wp, gsz, sz)
        torch.cuda.synchronize()
    except (RuntimeError, NotImplementedError) as e:
        log(f"  K4b library: none (`_weight_int4pack_mm` in torch "
            f"{torch.__version__}: {str(e).splitlines()[0][:120]})")
        return None
    err = ((got.float() - want.float()).abs().max()
           / want.float().abs().max().clamp_min(1e-30)).item()
    if not err <= TOL[("quant", _dt_name(x.dtype))]:
        log(f"  K4b library: none (`_weight_int4pack_mm` with this packing "
            f"differs from K4b by {err:.3e} of max|K4b|)")
        return None
    return device_ms(lambda: torch._weight_int4pack_mm(x, wp, gsz, sz),
                     200)[0]


def time_splits(device, dtype):
    """Device us of K1, K7 and K2 at each split count (the number of blocks
    in each (head, lane)'s cluster), through the C entry points, at the
    timing rows' shapes: the evidence behind k1_split, k7_split and
    k2_split. Returns
    {label: (the split count the wrapper takes, {splits: us})}."""
    import torch
    from pocket_tts_tpu_torch.ops import cuda_lib
    from pocket_tts_tpu_torch.ops.decode_attn import (K1_UNIT, MAX_SPLITS,
                                                      k1_split)
    from pocket_tts_tpu_torch.ops.insert_attn import k7_split
    from pocket_tts_tpu_torch.ops.ring_attn import k2_split
    lib = cuda_lib.library()
    g = torch.Generator(device="cpu").manual_seed(26)
    code, stream = cuda_lib.dtype_code(torch.empty(0, dtype=dtype)), \
        cuda_lib.stream_ptr(device)
    res = {}

    def k1(q, k, v, pos, e, sp, ks=None, vs=None, st=None):
        b, h, d = q.shape
        out = torch.empty_like(q)
        cuda_lib.check(lib.ptt_decode_attn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), pos.data_ptr(),
            None if ks is None else ks.data_ptr(),
            None if vs is None else vs.data_ptr(), out.data_ptr(),
            None if st is None else st.data_ptr(), b, h, d, k.shape[1],
            k.shape[2], e, sp, code, stream), "ptt_decode_attn")

    h, d, s, end = 16, 64, 384, 300
    q = torch.randn(1, h, d, generator=g).to(device, dtype)
    k = torch.randn(1, s, h * d, generator=g).to(device, dtype)
    v = torch.randn(1, s, h * d, generator=g).to(device, dtype)
    pos = torch.arange(s, dtype=torch.int32)[None].clone()
    pos[:, end + 1:] = -1
    pos = pos.to(device)
    units = -(-(end + 1) // K1_UNIT)
    res["K1 solo S=384 end=300"] = (k1_split(end, s), {
        sp: 1e3 * device_ms(lambda: k1(q, k, v, pos, end, sp), 200)[0]
        for sp in range(1, min(MAX_SPLITS, units) + 1)})
    for kvq, s in ((False, 1024), (True, 896)):
        q, k, v, ks, vs, pos, e = k1_lanes_case(g, device, dtype, kvq, s)
        st = (torch.empty(2, *q.shape[:2], dtype=torch.float32,
                          device=device) if kvq else None)
        res[f"K1 B={LANES} S={s} {'int8 + stats' if kvq else _dt_name(dtype)}"
            ] = (k1_split(e, s), {
                sp: 1e3 * device_ms(lambda: k1(q, k, v, pos, e, sp, ks, vs,
                                               st), 100)[0]
                for sp in range(1, MAX_SPLITS + 1)})
    # K7 at the serving shapes (and solo, as `--fuse-insert` calls it)
    for mode, b, kvq in (("ring", LANES, False), ("linear", LANES, False),
                         ("ring", LANES, True), ("ring", 1, False)):
        if kvq:
            (q, kn, vn, cur, k, v, pos, e, ws, ks, vs, ksn,
             vsn) = k7_kv8_case(g, device, dtype, mode, b)
            st = torch.empty(2, b, q.shape[1], dtype=torch.float32,
                             device=device)
        else:
            q, kn, vn, cur, k, v, pos, e, ws = k7_case(g, device, dtype,
                                                       mode, b)
            ks = vs = ksn = vsn = st = None
        s = k.shape[1]
        out = torch.empty_like(q)

        def k7(sp):
            cuda_lib.check(lib.ptt_insert_attn(
                q.data_ptr(), kn.data_ptr(), vn.data_ptr(), cur.data_ptr(),
                k.data_ptr(), v.data_ptr(), pos.data_ptr(),
                *(None if t is None else t.data_ptr()
                  for t in (ks, vs, ksn, vsn)), out.data_ptr(),
                None if st is None else st.data_ptr(), None, b, q.shape[1],
                q.shape[2], s, e, ws, sp, code, stream), "ptt_insert_attn")
        res[f"K7 {mode} B={b} S={s} "
            f"{'int8 + stats' if kvq else _dt_name(dtype)}"] = (
                k7_split(e, s, b), {
                    sp: 1e3 * device_ms(lambda: k7(sp), 100)[0]
                    for sp in range(1, MAX_SPLITS + 1)})
    h, d, cap, t, ctx = 8, 64, 256, 16, 250
    for b in (1, LANES):
        kc = torch.randn(b, cap, h * d, generator=g).to(device, dtype)
        vc = torch.randn(b, cap, h * d, generator=g).to(device, dtype)
        q, kn, vn = (torch.randn(b, t, h * d, generator=g).to(device, dtype)
                     for _ in range(3))
        st = (torch.arange(b, dtype=torch.int32) * 64).to(device)
        out = torch.empty_like(q)

        def k2(sp):
            cuda_lib.check(lib.ptt_ring_attn(
                q.data_ptr(), kn.data_ptr(), vn.data_ptr(), kc.data_ptr(),
                vc.data_ptr(), out.data_ptr(), st.data_ptr(), None, None,
                None, None, None, b, t, h, d, cap, 4096, 0, ctx, sp, code,
                stream),
                "ptt_ring_attn")
        res[f"K2 B={b} cap={cap}"] = (k2_split(cap, t), {
            sp: 1e3 * device_ms(lambda: k2(sp), 200)[0]
            for sp in range(1, MAX_SPLITS + 1)})
    return res


def phase_marks(name, names, call, device):
    """One call of a cooperative kernel (K5b, K5c, K8) with its per-block
    %globaltimer marks (`marks=`; call(marks) launches it): logs, for each
    named point, when the last block passed it (µs after the first
    block's entry) and, for each grid barrier, the first departure after
    the last arrival."""
    import torch
    from pocket_tts_tpu_torch.ops.fused_layer import (COOP_MARKS,
                                                      COOP_MAX_GRID)
    mk = torch.zeros(COOP_MAX_GRID, COOP_MARKS, dtype=torch.int64,
                     device=device)
    call(mk)
    sync(device)
    m = mk.cpu().numpy()[:, :len(names)]
    m = m[m[:, 0] > 0]                # the launch's blocks
    t0 = m[:, 0].min()
    at = ", ".join(f"{n} {(m[:, i].max() - t0) / 1e3:.2f}"
                   for i, n in enumerate(names) if i)
    bars = ", ".join(f"{(m[:, i].min() - m[:, i - 1].max()) / 1e3:.2f}"
                     for i, n in enumerate(names) if n.startswith("sync"))
    log(f"  {name} phases, {len(m)} blocks (µs after entry, last block): "
        f"{at}; barriers: {bars}")


def time_quant_kernels(pq, cfg, device, dtype, path, out):
    """Device time of the path's K4a/K4b, K5a, K5b and K6 vs their plain
    versions at the decode step's shapes (K4a/K4b also at a 128-row
    prefill in_proj, beside the library call), with each call's bound,
    appended to out[kernel name] (the first row of each name is the one
    the JSON line reports; K4a's 128-row row is also the warpgroup
    kernel's, int8_matmul_wgmma)."""
    import torch
    from pocket_tts_tpu_torch.ops import fused_flow, fused_layer
    from pocket_tts_tpu_torch.ops.basic import slice_layer_params
    from pocket_tts_tpu_torch.ops.quant_matmul import int8_route
    mm_name, mm, mm_plain, key = quant_matmul_fns(path)
    _, pre, post, flow = PATH_KERNELS[path]
    dn = _dt_name(dtype)
    rng = np.random.RandomState(6)
    dm, md = cfg.backbone.d_model, cfg.mimi.transformer.d_model
    eps_m = cfg.mimi.transformer.norm_eps
    bb = slice_layer_params(pq["layers"], 0)
    mt = slice_layer_params(pq["mimi"]["decoder_transformer"]["layers"], 0)
    rows = {n: out.setdefault(n, []) for n in PATH_KERNELS[path]}
    for lin, t, kdim, label in ((pq["input_linear"], 1, cfg.latent_dim,
                                 "input_linear"),
                                (bb["in_proj"], 128, dm, "prefill in_proj")):
        x = _rand(rng, device, dtype, t, kdim)
        y = mm(x, lin[key], lin["scale"])
        if path == "int8":
            lib = int8pack_ms(x, lin[key], lin["scale"])
        else:
            lib = int4pack_ms(x, lin, y)
        row = _row(
            device_ms(lambda: mm(x, lin[key], lin["scale"]),
                      200 if t == 1 else 20),
            device_ms(lambda: mm_plain(x, lin[key], lin["scale"]),
                      50 if t == 1 else 20), lib,
            bound_ms(_nbytes(x, y) + _tree_bytes(lin),
                     _linear_flops(lin, t), dn),
            f"{path} {label} T={t} K={kdim} N={y.shape[-1]}")
        rows[mm_name].append(row)
        if path == "int8" and int8_route(dtype, t) == "wgmma":
            out.setdefault("int8_matmul_wgmma", []).append(row)
    for p, t, d, eps, name in ((bb, 1, dm, 1e-5, "backbone"),
                               (mt, 16, md, eps_m, "mimi")):
        x = _rand(rng, device, dtype, t, d, scale=0.5)
        attn = _rand(rng, device, dtype, t, d, scale=0.5)
        pre_p = {k: p[k] for k in ("norm1", "in_proj")}
        post_p = {k: v for k, v in p.items() if k not in pre_p}
        rows[pre].append(_row(
            device_ms(lambda: fused_layer.pre_attention(p, x, eps), 200),
            device_ms(lambda: fused_layer.pre_attention_plain(p, x, eps),
                      50), None,
            bound_ms(_tree_bytes(pre_p) + _nbytes(x) * 4,
                     _linear_flops(pre_p, t), dn),
            f"{path} {name} T={t} dm={d}"))
        rows[post].append(_row(
            device_ms(lambda: fused_layer.post_attention(p, x, attn, eps),
                      200),
            device_ms(lambda: fused_layer.post_attention_plain(p, x, attn,
                                                               eps), 50),
            None,
            bound_ms(_tree_bytes(post_p) + _nbytes(x, attn) * 3 // 2,
                     _linear_flops(post_p, t), dn),
            f"{path} {name} T={t} dm={d}"))
        phase_marks(f"K5b {path} {name} T={t} {dn}", fused_layer.POST_MARKS,
                    lambda mk: fused_layer.post_attention(p, x, attn, eps,
                                                          marks=mk), device)
    fp, tc = pq["flow_net"], pq["_time_cond"]
    c = _rand(rng, device, dtype, dm)
    x = _rand(rng, device, dtype, cfg.latent_dim)
    rows[flow].append(_row(
        device_ms(lambda: fused_flow.flow_forward(fp, c, x, tc), 200),
        device_ms(lambda: fused_flow.flow_forward_plain(fp, c, x, tc), 20),
        None,
        bound_ms(_tree_bytes(fp) + _nbytes(c, tc) + 2 * _nbytes(x),
                 _linear_flops(fp, 1), dn),
        f"{path} c={dm} x={cfg.latent_dim} dim={cfg.flow.dim} "
        f"depth={cfg.flow.depth}"))
    return out


def time_conv_kernels(engines, device, out):
    """Device time of K4a / K4b at each quantized conv's shape of the
    CONV_PATHS engines (bf16), solo rows and LANES lanes' rows, beside
    the plain version, the library call (torch._weight_int8pack_mm /
    _weight_int4pack_mm), the dense bf16 product on the dequantized
    weight and the bound; each conv logged, and the sum over a frame's
    convs appended to out[kernel name] (rows after the first, which the
    JSON line reports). Returns {(path, lanes): per-frame sums}."""
    import torch
    from pocket_tts_tpu_torch.ops.quant_matmul import deq_dot
    rng = np.random.RandomState(10)
    sums = {}
    for path in CONV_PATHS:
        eng = engines[path]
        for b in (1, LANES):
            tot = dict(k=[0.0, 0.0], plain=[0.0, 0.0], lib=0.0, dense=0.0,
                       bytes=0, flops=0, lib_ok=True)
            for name, key, q, scale, rows in conv_products(
                    eng.params["mimi"]["decoder"], eng.cfg):
                mm_name, mm, plain = conv_matmul_fns(key)
                k = q.shape[0] * (2 if key.endswith("4") else 1)
                n, t = q.shape[1], b * rows
                x = _rand(rng, device, torch.bfloat16, t, k, scale=0.5)
                y = mm(x, q, scale)
                kern = device_ms(lambda: mm(x, q, scale), 50)
                pl = device_ms(lambda: plain(x, q, scale), 20)
                lin = ({"q": q, "scale": scale} if key in ("qc", "qt")
                       else {"q4": q, "scale": scale})
                lib = (int8pack_ms(x, q, scale) if mm_name == "int8_matmul"
                       else int4pack_ms(x, lin, y))
                w = deq_dot(torch.eye(k, device=device), lin).to(x.dtype)
                dense = device_ms(lambda: x @ w, 50)[0]
                nbytes = _nbytes(x, y, q, scale)
                bound = bound_ms(nbytes, 2 * t * k * n)
                log(f"  K4 conv {path} {name} rows={t} K={k} N={n} "
                    f"({conv_route(key, torch.bfloat16, t)}): kernel "
                    f"{kern[0] * 1e3:.2f} us device, plain "
                    f"{pl[0] * 1e3:.2f} us, library "
                    + ("none" if lib is None else f"{lib * 1e3:.2f} us")
                    + f", dense bf16 {dense * 1e3:.2f} us, bound "
                    f"{bound[0] * 1e3:.2f} us ({bound[1]}): "
                    f"{bound[0] / kern[0]:.1%} of it")
                for i in (0, 1):
                    tot["k"][i] += kern[i]
                    tot["plain"][i] += pl[i]
                tot["dense"] += dense
                tot["lib_ok"] = tot["lib_ok"] and lib is not None
                tot["lib"] += lib or 0.0
                tot["bytes"] += nbytes
                tot["flops"] += 2 * t * k * n
            sums[path, b] = tot
            out.setdefault(mm_name, []).append(_row(
                tuple(tot["k"]), tuple(tot["plain"]),
                tot["lib"] if tot["lib_ok"] else None,
                bound_ms(tot["bytes"], tot["flops"]),
                f"{path}: the {len(conv_products(eng.params['mimi']['decoder'], eng.cfg))} "
                f"quantized convs of a frame, {b} lane(s) (sum of calls; "
                f"dense bf16 {tot['dense'] * 1e3:.2f} us)"))
    return sums


def time_kv8_kernels(device, dtype, out):
    """Device time of K1 and K7 over int8 caches (K7 with and without the
    statistics) vs their plain versions at the serving mode's shapes, with
    each call's bound, appended to out[kernel name]. No single PyTorch call
    computes attention over int8 rows with per-row scales (library: none);
    for comparison only, the row's "cmp" is SDPA over bf16 caches of the
    same shape and mask."""
    import torch
    from pocket_tts_tpu_torch.ops.decode_attn import (decode_attention,
                                                      decode_attention_plain)
    from pocket_tts_tpu_torch.ops.insert_attn import (
        decode_insert_attention, decode_insert_attention_plain)
    g = torch.Generator(device="cpu").manual_seed(13)
    dn = _dt_name(dtype)
    isz = torch.tensor([], dtype=dtype).element_size()
    h, d, s, end = 16, 64, 384, 300
    hd = h * d
    k, ks = kv8_rows(g, device, dtype, s, hd)
    v, vs = kv8_rows(g, device, dtype, s, hd)
    q = torch.randn(h, d, generator=g).to(device, dtype)
    pos = torch.arange(s, dtype=torch.int32)
    pos[end + 1:] = -1
    pos = pos.to(device)
    mask = (pos >= 0)[None, None, None, :]
    kb = (k.float() * ks[:, None]).to(torch.bfloat16)
    vb = (v.float() * vs[:, None]).to(torch.bfloat16)
    qb = q.to(torch.bfloat16)
    row = _row(
        device_ms(lambda: decode_attention(q, k, v, pos, end, ks, vs), 200),
        device_ms(lambda: decode_attention_plain(q, k, v, pos, end, ks, vs),
                  50), None,
        # int8 K and V rows of the live slots, their scales and positions
        # read, q in, the output out
        bound_ms(2 * (end + 1) * (hd + 4) + 4 * (end + 1) + 2 * hd * isz,
                 4 * (end + 1) * hd, dn),
        f"int8 KV S={s} end={end} H={h} D={d}")
    row["cmp"] = device_ms(lambda: sdpa_call(qb[None, :, None], _heads(kb, h),
                                             _heads(vb, h), mask), 200)[0]
    out.setdefault("decode_attn_kv8", []).append(row)
    for name, stats in (("decode_insert_attn_kv8", False),
                        ("decode_insert_attn_stats", True)):
        (q, kn, vn, cur, k, v, pos, re_, ws, ks, vs, ksn,
         vsn) = k7_kv8_case(g, device, dtype, "ring")
        b = q.shape[0]
        mask = (torch.arange(pos.shape[1], device=device) <= re_) & (pos >= 0)
        nread = int(mask.sum())
        kw = dict(k_scale=ks, v_scale=vs, ks_new=ksn, vs_new=vsn,
                  stats=stats)
        # this run's data: the int8 rows and scales of the attended slots,
        # the positions, q in and the output out, the new rows and their
        # scales in and written, the statistics out
        nb = (2 * nread * (hd + 4) + 4 * b * (re_ + 1) + 2 * b * hd * isz
              + 4 * b * (hd + 4) + (2 * b * h * 4 if stats else 0))
        kb = (k.float() * ks[..., None]).to(torch.bfloat16)
        vb = (v.float() * vs[..., None]).to(torch.bfloat16)
        qb = q.to(torch.bfloat16)
        row = _row(
            device_ms(lambda: decode_insert_attention(
                q, kn, vn, cur, k, v, pos, re_, ws, **kw), 200),
            device_ms(lambda: decode_insert_attention_plain(
                q, kn, vn, cur, k, v, pos, re_, ws, **kw), 20), None,
            bound_ms(nb, 4 * nread * hd, dn),
            f"int8 KV{' + stats' if stats else ''} ring B={b} "
            f"S={pos.shape[1]} H={h} D={d}")
        row["cmp"] = device_ms(lambda: sdpa_call(
            qb[:, :, None], _heads(kb, h), _heads(vb, h),
            mask[:, None, None, :]), 200)[0]
        out.setdefault(name, []).append(row)
    return out


def time_lane_kernels(pq, cfg, device, dtype, out):
    """Device time of K5a and K5b over the serving mode's rows (32 backbone
    rows, 512 mimi rows) and K6 over 32 rows vs their plain versions, on
    the int4 tree pq, with each call's bound (no single PyTorch call
    computes these functions), appended to out[kernel name]."""
    from pocket_tts_tpu_torch.ops import fused_flow, fused_layer
    from pocket_tts_tpu_torch.ops.basic import slice_layer_params
    dn = _dt_name(dtype)
    rng = np.random.RandomState(9)
    bb = slice_layer_params(pq["layers"], 0)
    mt = slice_layer_params(pq["mimi"]["decoder_transformer"]["layers"], 0)
    for p, b, t, d, eps, name in (
            (bb, LANES, 1, cfg.backbone.d_model, 1e-5, "backbone"),
            (mt, LANES, 16, cfg.mimi.transformer.d_model,
             cfg.mimi.transformer.norm_eps, "mimi")):
        x = _rand(rng, device, dtype, b, t, d, scale=0.5)
        attn = _rand(rng, device, dtype, b, t, d, scale=0.5)
        pre_p = {k: p[k] for k in ("norm1", "in_proj")}
        post_p = {k: v for k, v in p.items() if k not in pre_p}
        rows = b * t
        out.setdefault("fused_pre_lanes", []).append(_row(
            device_ms(lambda: fused_layer.pre_attention(p, x, eps), 50),
            device_ms(lambda: fused_layer.pre_attention_plain(p, x, eps),
                      20), None,
            bound_ms(_tree_bytes(pre_p) + _nbytes(x) * 4,
                     _linear_flops(pre_p, rows), dn),
            f"int4 {name} rows={rows} ({b} lanes x {t}) dm={d}"))
        out.setdefault("fused_post_lanes", []).append(_row(
            device_ms(lambda: fused_layer.post_attention(p, x, attn, eps),
                      20),
            device_ms(lambda: fused_layer.post_attention_plain(p, x, attn,
                                                               eps), 20),
            None,
            bound_ms(_tree_bytes(post_p) + _nbytes(x, attn) * 3 // 2,
                     _linear_flops(post_p, rows), dn),
            f"int4 {name} rows={rows} ({b} lanes x {t}) dm={d}, "
            f"{fused_layer.post_launches(rows, d)} launches"))
    fp, tc = pq["flow_net"], pq["_time_cond"]
    for b in (LANES, 64):
        c = _rand(rng, device, dtype, b, cfg.backbone.d_model)
        x = _rand(rng, device, dtype, b, cfg.latent_dim)
        out.setdefault("fused_flow_lanes", []).append(_row(
            device_ms(lambda: fused_flow.flow_forward(fp, c, x, tc), 100),
            device_ms(lambda: fused_flow.flow_forward_plain(fp, c, x, tc),
                      20),
            None,
            bound_ms(_tree_bytes(fp) + _nbytes(c, tc) + 2 * _nbytes(x),
                     _linear_flops(fp, b), dn),
            f"int4 rows={b} c={cfg.backbone.d_model} x={cfg.latent_dim} "
            f"dim={cfg.flow.dim} depth={cfg.flow.depth}"))
    return out


def time_slice6_kernels(engines, device, dtype, out):
    """Device time of slice 6's kernels vs their plain versions, with each
    call's bound, appended to out[kernel name]: K8 on layer 0 of the int8
    and int4 trees at S = 384, end = 300 (caches of the working type and
    int8), beside the device time of the 3-call path it replaces for the
    same layer (K5a + rope + row quantization + K7 + K5b: backbone._layer
    with the fused insert); K5c on layers (0, 1) of the int4 and q4_0
    trees, beside K5b + K5a; K2-q solo and over 32 lanes; K1 over 32 lanes
    (S = 1024 bf16 caches against SDPA; S = 896 int8 caches with
    statistics). No single PyTorch call computes K8, K5c or attention over
    int8 rows with per-row scales (library: none); beside those, for
    comparison only, SDPA over bf16 caches of the same shape."""
    import torch
    from pocket_tts_tpu_torch.models import backbone as tbb
    from pocket_tts_tpu_torch.ops import fused_layer, fused_step
    from pocket_tts_tpu_torch.ops.attention import ring_cache_bias
    from pocket_tts_tpu_torch.ops.basic import slice_layer_params
    from pocket_tts_tpu_torch.ops.decode_attn import (decode_attention,
                                                      decode_attention_plain)
    from pocket_tts_tpu_torch.ops.ring_attn import (
        ring_insert_attention, ring_insert_attention_plain)
    from pocket_tts_tpu_torch.ops.rope import rope_cos_sin
    g = torch.Generator(device="cpu").manual_seed(25)
    dn = _dt_name(dtype)
    isz = torch.tensor([], dtype=dtype).element_size()
    # K8: (tree, int8 cache, kernel name)
    for path, kvq, name in (("int8", False, "megalayer"),
                            ("int4", False, "megalayer_int4"),
                            ("int4", True, "megalayer_kv8"),
                            ("int8", True, "megalayer")):
        eng = engines[path]
        bb = eng.cfg.backbone
        dm, end = bb.d_model, 300
        p = slice_layer_params(eng.params["layers"], 0)
        x, k, v, ks, vs, pos, cur = k8_case(g, device, dtype, kvq, end=end,
                                            dm=dm)
        cos, sin = rope_cos_sin(cur, bb.head_dim, bb.max_period)
        nread = int(((pos >= 0) & (torch.arange(pos.shape[0], device=device)
                                   < end)).sum())
        row = dm * (1 if kvq else isz) + (4 if kvq else 0)
        nbytes = (_tree_bytes(p) + 2 * nread * row + 4 * (end + 1)
                  + 2 * dm * isz + 2 * row)
        fl = _linear_flops(p, 1) + 4 * nread * dm
        r = _row(
            device_ms(lambda: fused_step.megalayer(
                p, x, cos, sin, cur, k, v, pos, end, end, ks, vs), 200),
            device_ms(lambda: fused_step.megalayer_plain(
                p, x, cos, sin, cur, k, v, pos, end, end, ks, vs), 20),
            None, bound_ms(nbytes, fl, dn),
            f"{path} weights, {'int8' if kvq else dn} cache S=384 "
            f"end={end}, layer 0")
        r["three"] = device_ms(lambda: tbb._layer(
            p, x, k, v, ks, vs, end, cos, sin, None, pos, bb.num_heads,
            False, cur), 200)[0]
        out.setdefault(name, []).append(r)
        phase_marks(f"K8 {path} {'int8' if kvq else dn} cache {dn}",
                    fused_step.MEGA_MARKS,
                    lambda mk: fused_step.megalayer(
                        p, x, cos, sin, cur, k, v, pos, end, end, ks, vs,
                        marks=mk), device)
    # K5c on layers (0, 1)
    for path in ("int4", "q4_0"):
        eng = engines[path]
        dm = eng.cfg.backbone.d_model
        layers = eng.params["layers"]
        p0, p1 = (slice_layer_params(layers, i) for i in (0, 1))
        x = (0.5 * torch.randn(1, dm, generator=g)).to(device, dtype)
        a = (0.5 * torch.randn(1, dm, generator=g)).to(device, dtype)
        post_p = {k: w for k, w in p0.items() if k not in ("norm1",
                                                             "in_proj")}
        pre_p = {k: p1[k] for k in ("norm1", "in_proj")}
        r = _row(
            device_ms(lambda: fused_layer.bilayer_post_pre(p0, p1, x, a),
                      200),
            device_ms(lambda: fused_layer.bilayer_post_pre_plain(p0, p1, x,
                                                                 a), 20),
            None,
            bound_ms(_tree_bytes(post_p) + _tree_bytes(pre_p)
                     + _nbytes(x) * 6, _linear_flops(post_p, 1)
                     + _linear_flops(pre_p, 1), dn),
            f"{path} layers (0, 1) dm={dm}")
        r["two"] = device_ms(lambda: fused_layer.pre_attention(
            p1, fused_layer.post_attention(p0, x, a)), 200)[0]
        out.setdefault("bilayer", []).append(r)
        phase_marks(f"K5c {path} {dn}", fused_layer.BILAYER_MARKS,
                    lambda mk: fused_layer.bilayer_post_pre(p0, p1, x, a,
                                                            marks=mk),
                    device)
    # K2-q at a wrapped ring, solo and over 32 lanes
    h, d, cap, t = 8, 64, 256, 16
    hd = h * d
    ctx = engines["int4"].cfg.mimi.transformer.context
    for b in (1, LANES):
        lead = () if b == 1 else (b,)
        q = torch.randn(*lead, t, hd, generator=g).to(device, dtype)
        kn, ksn = kv8_rows(g, device, dtype, *lead, t, hd)
        vn, vsn = kv8_rows(g, device, dtype, *lead, t, hd)
        kc, ks = kv8_rows(g, device, dtype, *lead, cap, hd)
        vc, vs = kv8_rows(g, device, dtype, *lead, cap, hd)
        if b == 1:
            st = 0
            bias = ring_cache_bias(t, cap, 4096, ctx, device=device)
        else:
            st = (torch.arange(b, dtype=torch.int32) * 64).to(device)
            bias = ring_cache_bias(t, cap, 4096, ctx, start=st[:, None, None],
                                   device=device)[:, None]
        kw = dict(k_scale=ks, v_scale=vs, ks_new=ksn, vs_new=vsn)
        # per lane: the ring's bytes and scales read once, the new rows
        # and scales in and written, q in, the output out
        nb = b * (2 * (cap + 2 * t) * (hd + 4) + 2 * t * hd * isz)
        r = _row(
            device_ms(lambda: ring_insert_attention(
                q, kn, vn, kc, vc, 4096, st, h, ctx, **kw), 200),
            device_ms(lambda: ring_insert_attention_plain(
                q, kn, vn, kc, vc, 4096, st, h, ctx, **kw), 20), None,
            bound_ms(nb, 4 * b * t * (cap + t) * hd, dn),
            f"int8 ring B={b} cap={cap} T={t} H={h} D={d} offset=4096")
        kb = (kc.float() * ks[..., None]).to(torch.bfloat16)
        vb = (vc.float() * vs[..., None]).to(torch.bfloat16)
        r["cmp"] = device_ms(lambda: sdpa_call(
            _heads(q.to(torch.bfloat16), h), _heads(kb, h), _heads(vb, h),
            bias == 0), 200)[0]
        out.setdefault("ring_attn_kv8", []).append(r)
    # K1 over 32 lanes, ring mode: bf16 caches S = 1024 (SDPA the
    # library); int8 caches S = 896 with statistics
    for kvq, s, stats, name in ((False, 1024, False, "decode_attn_lanes"),
                                (True, 896, True, "decode_attn_stats")):
        q, k, v, ks, vs, pos, e = k1_lanes_case(g, device, dtype, kvq, s)
        b, h, d = q.shape
        mask = (pos >= 0)[:, None, None, :]
        nread = int((pos >= 0).sum())
        row = h * d * (1 if kvq else isz) + (4 if kvq else 0)
        nbytes = (2 * nread * row + 4 * b * s + 2 * b * h * d * isz
                  + (2 * b * h * 4 if stats else 0))
        r = _row(
            device_ms(lambda: decode_attention(q, k, v, pos, e, ks, vs,
                                               stats=stats), 200),
            device_ms(lambda: decode_attention_plain(q, k, v, pos, e, ks, vs,
                                                     stats=stats), 20),
            None if kvq else device_ms(lambda: sdpa_call(
                q[:, :, None], _heads(k, h), _heads(v, h), mask), 200)[0],
            bound_ms(nbytes, 4 * nread * h * d, dn),
            f"{'int8' if kvq else dn} caches{' + stats' if stats else ''}, "
            f"ring B={b} S={s} H={h} D={d}")
        if kvq:
            kb = (k.float() * ks[..., None]).to(torch.bfloat16)
            vb = (v.float() * vs[..., None]).to(torch.bfloat16)
            r["cmp"] = device_ms(lambda: sdpa_call(
                q.to(torch.bfloat16)[:, :, None], _heads(kb, h),
                _heads(vb, h), mask), 200)[0]
        out.setdefault(name, []).append(r)
    return out


# the most kernel launches a solo frame may make (profiler, phase 8: what
# each path launched before K1 and K2 were split over clusters, when K3
# was 22 launches a frame; it is 14 now, K3_PER_FRAME); K1 and K2 launch
# once per call
FRAME_LAUNCHES = {"bf16": 647, "int8": 258, "int4": 258, "q4_0": 258,
                  KV8_PATH: 378, "int8_mega": 126, "int4_kv8_mega": 162,
                  "int4_bilayer": 253,
                  # the decoder's chain with quantized convs in place of
                  # K3's 14 launches: 7 K4 launches and the chain's torch
                  # ops (casts, window concats, ELUs, overlap-adds, the
                  # float convs' f32 products), 420 as first measured
                  "int8_convs": 420, "int4_convs": 420}
K1_PER_FRAME = {"int8_mega": 0, "int4_kv8_mega": 0}   # else 6
K3_PER_FRAME = 14   # ten conv-GEMMs, three overlap-adds, the final conv
# the quantized-convs paths launch no K3: the decoder's chain runs its
# torch ops and one K4a / K4b a quantized conv
K3_FRAMES = {path: 0 for path in CONV_PATHS}


# The port's kernels as the profiler names them, by family, beside the
# launch counters (`_counters`) that count the family's launches, each with
# the device launches one count stands for. A counter that counts a launch
# once more (rows_mma, rows_skinny, int8_matmul_wgmma, the statistics,
# megalayer_kv8) is in no family; the row-block kernels, K4a's warpgroup
# kernel and K5b's cooperative kernel are one family since K4a, K4b, K5a
# and K5b share them.
LAUNCH_FAMILIES = {
    "K1": (("decode_attn_kernel",),
           (("decode_attn", 1), ("decode_attn_kv8", 1),
            ("decode_attn_lanes", 1))),
    "K2": (("ring_attn_kernel",), (("ring_attn", 1), ("ring_attn_kv8", 1))),
    "K3": (("seanet_gemm_kernel", "seanet_overlap_kernel",
            "seanet_last_kernel"), (("seanet_frame", K3_PER_FRAME),)),
    "K4/K5a/K5b": (("rows_kernel", "rows_mma_kernel", "skinny_kernel",
                    "fused_post_kernel", "wgmma_int8_kernel"),
                   (("int8_matmul", 1), ("int4_matmul", 1), ("fused_pre", 1),
                     ("fused_pre_int4", 1), ("fused_pre_lanes", 1),
                     ("fused_post", 1), ("fused_post_int4", 1),
                     ("fused_post_lanes", 1))),
    "K5c": (("bilayer_kernel",), (("bilayer", 1),)),
    "K6": (("flow_mods_kernel", "flow_chain_kernel"),
           (("fused_flow", 1), ("fused_flow_int4", 1),
            ("fused_flow_lanes", 1))),
    "K7": (("insert_attn_kernel",), (("decode_insert_attn", 1),
                                     ("decode_insert_attn_kv8", 1))),
    "K8": (("megalayer_kernel",), (("megalayer", 1),
                                   ("megalayer_int4", 1))),
}


def launch_crosscheck(kern, counted):
    """The profiler's launches of each kernel family (kern: [(kernel, us,
    calls)] per frame or step) beside the wrappers' launch counters over
    the same window (counted: {counter: launches} per frame or step):
    ([(family, profiler, counters)] of the families either side saw, the
    text that names each disagreement and its side: "profiler lost" where
    the profiler holds fewer records than the wrappers launched, "counters
    missed" where it holds more)."""
    rows, bad = [], []
    for fam, (syms, ctrs) in LAUNCH_FAMILIES.items():
        prof = sum(c for key, _, c in kern if any(s in key for s in syms))
        cnt = sum(counted.get(name, 0) * m for name, m in ctrs)
        if prof or cnt:
            rows.append((fam, prof, cnt))
            if abs(prof - cnt) > 1e-6:
                side = "profiler lost" if prof < cnt else "counters missed"
                bad.append(f"{fam}: {side} {abs(cnt - prof):.2f} (profiler "
                           f"{prof:.2f}, counters {cnt:.2f})")
    text = ("profiler and launch counters agree on every kernel" if not bad
            else "profiler and launch counters DISAGREE: " + "; ".join(bad))
    return rows, text


def check_frame_launches(label, kern, counted):
    """The profiler's launches per frame of a solo path: 6 K1 (0 on the
    megalayer paths), 2 K2 and K3_PER_FRAME K3 launches, no memset, and no
    more launches in all than FRAME_LAUNCHES. Logged beside the launch
    counters over the same frames (counted: per frame; launch_crosscheck),
    whose verdict a failure's message carries."""
    def calls(name):
        return sum(c for key, _, c in kern if name in key)
    k1, k2 = calls("decode_attn_kernel"), calls("ring_attn_kernel")
    k3 = sum(calls(f"seanet_{k}_kernel") for k in ("gemm", "overlap",
                                                     "last"))
    total = sum(c for _, _, c in kern)
    memset = calls("emset")
    rows, verdict = launch_crosscheck(kern, counted)
    log(f"    launches per frame: K1 {k1:.1f}, K2 {k2:.1f}, K3 {k3:.1f}, "
        f"memset {memset:.1f}, all {total:.1f} (at most "
        f"{FRAME_LAUNCHES[label]})")
    log("    profiler / counters per frame: " + ", ".join(
        f"{fam} {p:.2f} / {c:.2f}" for fam, p, c in rows) + f": {verdict}")
    want_k1 = K1_PER_FRAME.get(label, 6)
    want_k3 = K3_FRAMES.get(label, K3_PER_FRAME)
    if not (abs(k1 - want_k1) < 1e-6 and abs(k2 - 2) < 1e-6
            and abs(k3 - want_k3) < 1e-6 and memset == 0
            and total <= FRAME_LAUNCHES[label] + 1e-6):
        raise AssertionError(f"{label}: launches per frame changed: K1 {k1} "
                             f"(want {want_k1}), K2 {k2} (want 2), K3 {k3} "
                             f"(want {want_k3}), memset {memset} (want "
                             f"0), all {total}; {verdict}")


# Profiled steps before the recorded window (torch.profiler's warm-up:
# tracing on, records dropped). Without them the profiler lost the first
# ~86 kernel records of a window while the launch counters saw every
# launch (on the H100, the int4_kv8 frames: input_linear's, layer 0's and
# layer 1's K5a records missing, launch_crosscheck "profiler lost"; PERF.md
# section 5); the window starts and ends on a synchronised device, so it
# holds whole steps. The profiler's step annotations (ProfilerStep#k, a
# span over each step's device work) are not kernels.
PROFILE_WARMUP = 2


def device_kernels(ka, n):
    """[(kernel, us per step, calls per step)] of the device events of
    key_averages ka over n steps, largest first (the step annotations
    left out)."""
    from torch.autograd import DeviceType
    out = [(e.key, e.self_device_time_total / n, e.count / n) for e in ka
           if e.device_type == DeviceType.CUDA
           and not e.key.startswith("ProfilerStep")]
    return sorted(out, key=lambda r: -r[1])


def profiled_steps(step, n):
    """Run step() PROFILE_WARMUP + n times under torch.profiler, recording
    the last n, with the launch counters set to 0 just before them and
    read just after. Returns (key_averages of the n steps, {counter:
    launches per step})."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=PROFILE_WARMUP, active=n,
                                   repeat=1)) as prof:
        for i in range(PROFILE_WARMUP + n):
            if i == PROFILE_WARMUP:
                time.sleep(0.01)  # the first launches well inside the window
                reset_counters()
            step()
            if i in (PROFILE_WARMUP - 1, PROFILE_WARMUP + n - 1):
                torch.cuda.synchronize()
            prof.step()
    counted = {k: v / n for k, v in read_counters().items()}
    return prof.key_averages(), counted


def profile_frames(engine, voice, path, n_frames=20):
    """Device time by kernel over n_frames of the frame loop
    (torch.profiler, `profiled_steps`), beside the launch counters over
    the same frames. Returns (device busy us per frame, [(kernel, us per
    frame, calls per frame)] largest first, {counter: launches per
    frame}); the table goes to `path` when one is given."""
    import torch
    from pocket_tts_tpu_torch.text.preprocess import prepare_text_prompt
    from pocket_tts_tpu_torch.models import tts
    prepared, _ = prepare_text_prompt(BENCH_TEXT)
    state, _ = engine._prefill_sentence(engine.prime_voice(voice), prepared)
    zero = torch.zeros(engine.cfg.latent_dim, dtype=engine.dtype,
                       device=engine.device)
    torch.cuda.synchronize()

    def step():
        with torch.no_grad():
            tts.frame_step(engine.params, engine.cfg, state, zero, 10 ** 6,
                           10 ** 6, engine.seanet_weights)

    ka, counted = profiled_steps(step, n_frames)
    if path:
        with open(path, "w") as f:
            f.write(ka.table(sort_by="self_cuda_time_total", row_limit=60))
    kernels = device_kernels(ka, n_frames)
    return sum(r[1] for r in kernels), kernels, counted


# ---------------------------------------------------------------- phase 7 --

# requests of different lengths (random weights never fire EOS, so each
# runs to its max_steps = (words + 2) * 12.5 frames)
SERVE_TEXTS = (
    "Hello there.",
    "The quick brown fox jumped over the sleeping dog.",
    "Short one here.",
    "A somewhat longer request that keeps its lane busy for a while.",
    "Two words.",
    "Serving many streams on one card at once.",
)


def counted_lane_steps():
    """Wrap models.tts.frame_step_lanes and models.flow_lm.prefill_lanes to
    count the batch frame steps (one frame of every lane) and the batched
    prefill calls (one per admission group) the servers run."""
    from pocket_tts_tpu_torch.models import flow_lm, tts
    real, real_prefill = tts.frame_step_lanes, flow_lm.prefill_lanes
    count = {"steps": 0, "prefills": 0}

    def frame_step_lanes(*args, **kw):
        count["steps"] += 1
        return real(*args, **kw)

    def prefill_lanes(*args, **kw):
        count["prefills"] += 1
        return real_prefill(*args, **kw)

    tts.frame_step_lanes = frame_step_lanes
    flow_lm.prefill_lanes = prefill_lanes
    return count


def serve_vs_solo(device, voice, path="bf16", share_prefix=False,
                  steps=None, lanes=4):
    """f32, `lanes` lanes, the 6 SERVE_TEXTS at temp 0: at 4 lanes the last
    two are admitted mid-decode, into lanes the short ones freed; at more
    lanes than requests all are admitted at once and the lane kernels run
    with most lanes idle. Each request's pcm
    must match the solo engine's (the same weights and KV cache, path
    ENGINE_KW[path] with PATH_CFG[path]) on the card within TOL e2e
    (relative to max |pcm|). steps (counted_lane_steps): the counters are
    set to 0 just before the serving run and read just after, and checked
    against expected_serving; returns the launches."""
    import torch
    from pocket_tts_tpu_torch.config import DEFAULT_CONFIG
    from pocket_tts_tpu_torch.runtime.server import ContinuousBatchingServer
    from pocket_tts_tpu_torch.text.preprocess import prepare_text_prompt
    engine = make_engine(path_cfg(DEFAULT_CONFIG, path), device,
                         torch.float32, **ENGINE_KW[path])
    srv = ContinuousBatchingServer(engine, lanes=lanes,
                                   share_prefix=share_prefix)
    srv.register_voices({"v": voice})
    reqs = [srv.submit(t, "v", temp=0.0) for t in SERVE_TEXTS]
    if steps is not None:
        steps0, prefills0 = steps["steps"], steps["prefills"]
        reset_counters()
    srv.run_pending()
    launches = None
    if steps is not None:
        sync(device)
        launches = read_counters()
        n = steps["steps"] - steps0
        want = expected_serving(engine.cfg, path, n,
                                steps["prefills"] - prefills0, lanes=lanes,
                                dtype=torch.float32)
        log(f"  {path}, {lanes} lanes: launches {launches}; expected {want}"
            f" (expected_serving, {n} batch frame steps)")
        for name in KERNELS:
            if launches[name] != want.get(name, 0):
                raise AssertionError(
                    f"{path} serving {name}: {launches[name]} launches for "
                    f"{n} batch frame steps (want {want.get(name, 0)})")
    late = [r for r in reqs if r.admit_step]
    if len(late) < min(2, len(reqs) - lanes):
        raise AssertionError(f"only {len(late)} requests admitted mid-decode")
    vstate = engine.prime_voice(voice)
    worst = 0.0
    for r in reqs:
        prepared, guess = prepare_text_prompt(r.text)
        want = engine.synthesize_sentence(vstate, prepared, 0.0, guess + 2)
        if r.pcm.shape != want.shape:
            raise AssertionError(f"served {r.pcm.shape} vs solo {want.shape}"
                                 f" samples for {r.text!r}")
        rel = float(np.abs(r.pcm - want).max()) / max(
            float(np.abs(want).max()), 1e-30)
        worst = max(worst, rel)
    tol = TOL[("e2e", "f32")]
    log(f"  f32 {path}{', shared prefix' if share_prefix else ''}, {lanes} "
        f"lanes, {len(reqs)} requests ({len(late)} admitted "
        f"mid-decode, at chunks {[r.admit_step for r in late]}), "
        f"{srv.steps} chunks: max |served - solo| relative to max |solo| "
        f"{worst:.3e} (tol {tol})")
    if not worst <= tol:
        raise AssertionError(f"served pcm differs from solo: {worst}")
    return launches


def expected_serving(cfg, mode, n, prefills, lanes=LANES, dtype=None):
    """Launches by kernel for n batch frame steps and `prefills` admission
    prefill calls at `lanes` lanes: "bf16" (slice 4's server), "int4_kv8"
    (int4 weights, int8 KV, shared prefix: K7's int8 variant with
    statistics, K5a/K5b over the lanes' rows, K6 over the lanes, K4b for
    input_linear and the prefill linears) or K1_SERVE (int8 weights, int8
    KV, shared prefix, the int8 mimi ring, no fused insert: K1 over lanes
    with statistics, K2-q, K4a)."""
    from pocket_tts_tpu_torch.ops.fused_layer import post_launches
    nb, nm = cfg.backbone.num_layers, cfg.mimi.transformer.num_layers
    if ENGINE_KW[mode].get("quantize_convs"):
        # the counterpart mode's launches, with one K4 launch a quantized
        # conv in place of the K3 sequence each batch frame step (K4b: no
        # warpgroup route)
        base = {SERVE_CONVS: KV8_PATH}[mode]
        want = expected_serving(cfg, base, n, prefills, lanes, dtype)
        del want["seanet_frame"]
        want["int4_matmul"] += len(conv_shapes(cfg)) * n
        return want
    want = {"seanet_frame": n}
    if mode == K1_SERVE:
        want.update(decode_attn_lanes=nb * n, decode_attn_stats=nb * n,
                    ring_attn_kv8=nm * n)
    else:
        want["ring_attn"] = nm * n
    if mode == "bf16":
        want["decode_insert_attn"] = nb * n
        return want
    if mode != K1_SERVE:
        want.update(decode_insert_attn_kv8=nb * n,
                    decode_insert_attn_stats=nb * n)
    tpf = cfg.mimi.upsample_stride
    mm = "int8_matmul" if ENGINE_KW[mode]["quantize"] == "int8" \
        else "int4_matmul"
    import torch
    from pocket_tts_tpu_torch.ops.fused_flow import LAUNCHES
    from pocket_tts_tpu_torch.ops.fused_layer import rows_route
    post_b = post_launches(lanes, cfg.backbone.d_model)
    post_m = post_launches(lanes * tpf, cfg.mimi.transformer.d_model)
    want.update(
        fused_pre_lanes=(nb + nm) * n, fused_flow_lanes=n * LAUNCHES,
        fused_post_lanes=n * (nb * post_b + nm * post_m),
        **{mm: n + 4 * nb * prefills})
    # K5a and the row-block K5b launches on the tensor cores
    dt = torch.bfloat16 if dtype is None else dtype
    mma = 0
    for layers, rows, post in ((nb, lanes, post_b), (nm, lanes * tpf, post_m)):
        if rows_route(dt, rows) == "mma":
            mma += layers * (1 + (post if post > 1 else 0))
    if mma:
        want["rows_mma"] = mma * n
    return want


def serve_throughput(engine, voice, steps, lanes=LANES, n_requests=48,
                     mode="bf16"):
    """`lanes` lanes, n_requests of the SERVE_TEXTS at temp 0, counters set
    to 0 just before the run and read just after: per batch frame step 6
    K7, 2 K2, one K3 sequence, and in the serving mode ("int4_kv8": shared
    prefix) the K5a/K5b/K6 launches over the lanes (expected_serving) and
    nothing else. Returns (launches, frame steps, stats)."""
    import torch
    from pocket_tts_tpu_torch.runtime.server import ContinuousBatchingServer
    srv = ContinuousBatchingServer(engine, lanes=lanes,
                                   share_prefix=mode != "bf16")
    srv.register_voices({"v": voice})
    steps0, prefills0 = steps["steps"], steps["prefills"]
    for i in range(n_requests):
        srv.submit(SERVE_TEXTS[i % len(SERVE_TEXTS)], "v", temp=0.0)
    reset_counters()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    srv.run_pending()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counters()
    n = steps["steps"] - steps0
    st = srv.stats()
    want = expected_serving(engine.cfg, mode, n,
                            steps["prefills"] - prefills0, lanes)
    log(f"  {mode}, {lanes} lanes, {n_requests} requests: {st['frames']} "
        f"frames emitted in {srv.steps} chunks ({n} batch frame steps), "
        f"wall {wall:.3f} s: {st['frames'] / wall:.1f} frames/s aggregate; "
        f"TTFA p50 {st['p50_ttfa_s'] * 1e3:.1f} ms, p95 "
        f"{st['p95_ttfa_s'] * 1e3:.1f} ms (host clock from submission; "
        f"requests beyond {lanes} wait for a lane); latency p50 "
        f"{st['p50_latency_s']:.3f} s, p95 {st['p95_latency_s']:.3f} s")
    log(f"  launches {launches}; expected {want} (per batch frame step 6 "
        f"K7, 2 K2, 1 K3, 0 K1)")
    if st["requests"] != n_requests or st["frames"] < 1:
        raise AssertionError(f"served {st}")
    for name in KERNELS:
        if launches[name] != want.get(name, 0):
            raise AssertionError(f"serving {name}: {launches[name]} launches "
                                 f"for {n} batch frame steps (want "
                                 f"{want.get(name, 0)})")
    st.update(wall_s=wall, frame_steps=n, frames_per_s=st["frames"] / wall)
    return launches, n, st


def busy_server(engine, voice, lanes, share_prefix=False):
    """A ContinuousBatchingServer with `lanes` long requests (SERVE_TEXTS[3],
    175 frames each), after two chunks that admit them and warm up."""
    from pocket_tts_tpu_torch.runtime.server import ContinuousBatchingServer
    srv = ContinuousBatchingServer(engine, lanes=lanes,
                                   share_prefix=share_prefix)
    srv.register_voices({"v": voice})
    for _ in range(lanes):
        srv.submit(SERVE_TEXTS[3], "v", temp=0.0)
    srv.step()
    srv.step()
    return srv


def chunk_walls(srv, n):
    """Host wall (us) of each of n chunks, each synchronized."""
    import torch
    walls = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        srv.step()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e6)
    return walls


def profile_serving(engine, voice, path, lanes=LANES, n_steps=4,
                    share_prefix=False):
    """Device busy share of steady serving: `lanes` long requests, two
    chunks to admit them and warm up, then 2 * n_steps chunks each timed
    on the host clock (synchronized) and n_steps more recorded by
    torch.profiler (`profiled_steps`), beside the launch counters over the
    same chunks. Returns (busy us per chunk, [wall us of each timed chunk],
    frames per chunk, [(kernel, us per chunk, calls per chunk)],
    {counter: launches per chunk})."""
    srv = busy_server(engine, voice, lanes, share_prefix)
    walls = chunk_walls(srv, 2 * n_steps)
    ka, counted = profiled_steps(srv.step, n_steps)
    if any(r is None for r in srv._live):
        raise AssertionError("a lane finished inside the profiled window")
    if path:
        with open(path, "w") as f:
            f.write(ka.table(sort_by="self_cuda_time_total", row_limit=60))
    kernels = device_kernels(ka, n_steps)
    return (sum(r[1] for r in kernels), walls, lanes * srv.chunk_frames,
            kernels, counted)


def run_cli(args, timeout=600):
    """`python -m pocket_tts_tpu_torch.cli --random-weights ARGS` on the
    card in a subprocess, which builds the full-width model anew and loads
    the kernel library phase 2 built. Returns (stdout lines, wall s); a
    non-zero exit raises."""
    t0 = time.perf_counter()
    res = subprocess.run(
        [sys.executable, "-m", "pocket_tts_tpu_torch.cli", "--random-weights",
         *args], capture_output=True, text=True, timeout=timeout,
        cwd=os.path.dirname(os.path.abspath(__file__)))
    wall = time.perf_counter() - t0
    if res.returncode != 0:
        raise AssertionError(f"cli {' '.join(args)} failed:\n"
                             f"{res.stdout[-3000:]}\n{res.stderr[-3000:]}")
    return res.stdout.strip().splitlines(), wall


def serve_cli(tmp, extra=()):
    """`python -m pocket_tts_tpu_torch.cli --random-weights --serve FILE
    --serve-out DIR [extra]` on the card: one wav per request."""
    reqs = os.path.join(tmp, "reqs.txt")
    with open(reqs, "w") as f:
        f.write("Hello from the command line.\n"
                + json.dumps({"text": "A second request. It has two "
                              "sentences.", "id": "second"}) + "\n"
                + "Third.\n")
    out = os.path.join(tmp, "wavs" + "".join(extra).replace("-", "_"))
    lines, wall = run_cli(["-t", "0", "--lanes", "8", "--serve", reqs,
                           "--serve-out", out, *extra])
    wavs = sorted(os.listdir(out))
    log(f"  cli --serve {' '.join(extra)}: {wavs} in {wall:.1f} s (process "
        f"start, weights, serving); last line {lines[-1]}")
    if wavs != ["req_0000.wav", "req_0002.wav", "second.wav"]:
        raise AssertionError(f"cli --serve wrote {wavs}")


# ---------------------------------------------------------------- phase 9 --

# the JSON keys of the JAX package's CLI: solo (pocket_tts_tpu/cli.py:
# 433-438) and --batch (:350-352)
CLI_SOLO_KEYS = {"metric", "value", "unit", "frames", "total_s", "rtf",
                 "ttfa_ms"}
CLI_BATCH_KEYS = {"metric", "value", "unit", "batch"}
# bench.py's backbone KV slot budget for its roofline shares
KV_SLOTS = 384
# the kernels a --profile trace of the bf16 stream must name (K1, K2, and
# K3's family: seanet_gemm_kernel, seanet_overlap_kernel, ...)
TRACE_KERNELS = ("decode_attn_kernel", "ring_attn_kernel", "seanet_")
# the serving mode's widest lane count checked (the CLI's --lanes)
WIDE_LANES = 128


def cli_bench(extra=()):
    """CLI --bench --json [extra]: the JSON line has the JAX CLI's keys and
    frames > 0. Returns it."""
    lines, wall = run_cli(["--bench", "--json", *extra])
    rep = json.loads(lines[-1])
    if not (set(rep) == CLI_SOLO_KEYS and rep["frames"] > 0
            and rep["value"] > 0 and rep["ttfa_ms"] > 0):
        raise AssertionError(f"cli --bench --json {extra}: {lines[-1]}")
    log(f"  cli --bench --json {' '.join(extra)}: {rep['frames']} frames, "
        f"frames_per_second {rep['value']}, rtf {rep['rtf']}, ttfa_ms "
        f"{rep['ttfa_ms']} (host clock: ttfa from the stream's start to its "
        f"first frame, prefill included), total_s {rep['total_s']}; "
        f"process {wall:.1f} s")
    return rep


def stream_rows(engines, voice):
    """Each solo path's engine (warm: phases 4-8 ran it) through the CLI's
    own stream loop (`cli.feed`: BENCH_TEXT in 15-character chunks, each
    `receive` a FrameMeter step) at temp 0, in process: frames/s, RTF and
    ttfa_ms of a lone request without the process's start-up. Returns
    {path: FrameMeter report}."""
    from pocket_tts_tpu_torch.cli import feed
    from pocket_tts_tpu_torch.utils.profiling import FrameMeter
    out = {}
    for label, eng in engines.items():
        stream = eng.open_stream(voice, 0.0)
        meter = FrameMeter(eng.cfg.mimi.frame_rate)
        frames = feed(stream, meter, BENCH_TEXT)
        rep = out[label] = meter.report()
        log(f"  {label}, the CLI's stream loop in process (warm): {frames} "
            f"frames, {rep['frames_per_second']} frames/s, rtf "
            f"{rep['rtf']}, ttfa_ms {rep['ttfa_ms']}, wall_s "
            f"{rep['wall_s']}")
        if not (frames > 0 and rep["frames"] == frames
                and rep["ttfa_ms"] > 0):
            raise AssertionError(f"{label} stream loop: {rep}")
    return out


def roofline_rows(engines, ms_per_frame, kind):
    """hbm_bw_util and mfu of each solo path's decode frames/s (phase 6's
    median with the EOS sync) from decode_frame_costs on its engine's
    params at KV_SLOTS slots and the card's published peaks
    (device_peaks). Returns {path: (frames/s, bytes, flops, util, mfu)}."""
    from pocket_tts_tpu_torch.utils.roofline import (decode_frame_costs,
                                                     device_peaks)
    peak_flops, peak_bw = device_peaks(kind)
    out = {}
    for label, eng in engines.items():
        fps = 1e3 / ms_per_frame[label]
        nbytes, flops = decode_frame_costs(eng.params, eng.cfg, KV_SLOTS)
        out[label] = (fps, nbytes, flops, fps * nbytes / peak_bw,
                      fps * flops / peak_flops)
        log(f"  {label}: {fps:.1f} frames/s (phase 6), {nbytes / 1e6:.3f} "
            f"MB and {flops / 1e9:.4f} GFLOP a frame at {KV_SLOTS} KV slots:"
            f" hbm_bw_util {out[label][3]:.5f}, mfu {out[label][4]:.6f} "
            f"(peaks {peak_bw / 1e12:.2f} TB/s, {peak_flops / 1e12:.0f} "
            f"TFLOP/s bf16)")
    return out


def cli_profile(tmp):
    """CLI --profile DIR on bf16: the Chrome trace exists, parses and
    names K1, K2 and K3's kernels (by family, not by count). Returns
    {family: records}."""
    d = os.path.join(tmp, "trace")
    lines, wall = run_cli(["-t", "0", "--json", "--profile", d,
                           "Hello there, profiled."])
    path = os.path.join(d, "trace.json")
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    names = [e.get("name", "") for e in events if e.get("cat") == "kernel"]
    found = {fam: sum(fam in n for n in names) for fam in TRACE_KERNELS}
    frames = json.loads(lines[-1])["frames"]
    log(f"  cli --profile: {os.path.getsize(path) / 2**20:.1f} MiB trace, "
        f"{len(events)} events, {len(names)} kernel records over {frames} "
        f"frames; records by family {found}; process {wall:.1f} s")
    if not all(found.values()):
        raise AssertionError(f"the --profile trace lacks kernels: {found}")
    return found


def cli_batch(tmp, extra=()):
    """CLI --bench --batch 4 --json -o x.flac --out-rate 16000 [extra]: the
    JAX CLI's batched JSON line, and the FLAC reads back with the port's
    load_audio at 16 kHz, 1280 samples a frame of one stream."""
    from pocket_tts_tpu_torch.io.audio_in import load_audio
    path = os.path.join(tmp, "batch.flac")
    lines, wall = run_cli(["--bench", "--batch", "4", "--json", "-o", path,
                           "--out-rate", "16000", *extra])
    rep = json.loads(lines[-1])
    line = next(x for x in lines if x.startswith("batch 4: "))
    frames = int(line.split()[2])
    pcm, sr = load_audio(path)
    log(f"  cli --batch 4 --json -o .flac --out-rate 16000 "
        f"{' '.join(extra)}: {line}; "
        f"{lines[-1]}; flac {sr} Hz, {pcm.size} samples; process "
        f"{wall:.1f} s")
    if not (set(rep) == CLI_BATCH_KEYS and rep["batch"] == 4
            and rep["value"] > 0 and frames > 0 and frames % 4 == 0
            and sr == 16000 and pcm.size == frames // 4 * 1280
            and np.isfinite(pcm).all() and np.abs(pcm).max() > 0):
        raise AssertionError(f"cli --batch: {rep}, {frames} frames, flac "
                             f"{sr} Hz {pcm.size} samples")


def check_exact(device, voice, counts, path):
    """The reference-exact mode on `path`, as phase 5 checks a path:
    EXACT_FRAMES f32 frames (past the mimi ring's wrap) on the card vs the
    port on the CPU within TOL e2e, with the
    counters set to 0 just before the card's run and read just after:
    expected_exact (no K1, K2, K7, K8, K5; one K3 sequence a frame).
    Returns the launches."""
    import torch
    from pocket_tts_tpu_torch.config import DEFAULT_CONFIG
    cfg = path_cfg(DEFAULT_CONFIG, path)
    steps = EXACT_FRAMES * cfg.mimi.upsample_stride
    if steps <= cfg.mimi.transformer.capacity:
        raise AssertionError(f"{path}: {steps} mimi steps do not wrap the "
                             f"{cfg.mimi.transformer.capacity}-slot ring")
    eng = make_engine(cfg, device, torch.float32, **ENGINE_KW[path])
    frames0, prefills0 = counts["frames"], counts["prefills"]
    reset_counters()
    pcm_gpu = first_frames(eng, voice, EXACT_FRAMES)
    sync(device)
    launches = read_counters()
    frames = counts["frames"] - frames0
    prefills = counts["prefills"] - prefills0
    per_frame, per_prefill = expected_launches(eng.cfg, path)
    del eng
    log(f"  {path}: {frames} frames, {prefills} prefill calls; launches "
        f"{ {k: v for k, v in launches.items() if v} }; expected per frame "
        f"{per_frame}, per prefill call {per_prefill}")
    for name in list(KERNELS) + ["rows_mma", "rows_skinny"]:
        want = (per_frame.get(name, 0) * frames
                + per_prefill.get(name, 0) * prefills)
        if launches[name] != want:
            raise AssertionError(f"{path} {name}: {launches[name]} launches "
                                 f"(want {want})")
    eng_cpu = make_engine(cfg, "cpu", torch.float32, **ENGINE_KW[path])
    pcm_cpu = first_frames(eng_cpu, voice, EXACT_FRAMES)
    del eng_cpu
    scale = float(np.abs(pcm_cpu).max())
    err = float(np.abs(pcm_gpu - pcm_cpu).max())
    tol = TOL[("e2e", "f32")]
    log(f"  {path} (reference-exact, f32): max |pcm card - pcm cpu| "
        f"{err:.3e}, max |pcm| {scale:.3e}, relative "
        f"{err / max(scale, 1e-30):.3e} (tol {tol})")
    if not (np.isfinite(pcm_gpu).all() and scale > 0
            and err <= tol * scale):
        raise AssertionError(f"reference-exact card vs CPU pcm differ "
                             f"({path})")
    return launches


def check_gguf(device, voice, tmp):
    """Phase 4c, the GGUF container on the card: an engine (bf16) loaded
    from a model directory holding tts_b6369a24.gguf only (written here by
    the port's io/gguf.py from random_flat(DEFAULT_CONFIG, seed 0)) gives
    the pcm of one loaded from tts_b6369a24.safetensors of the same flat
    dict, bit for bit; then CLI --quantize int8 --save-cache x.gguf
    --gguf-quantize q8_0, and CLI --load-cache x.gguf synthesizes (a wav
    of finite, non-silent frames)."""
    import torch
    from pocket_tts_tpu_torch.config import DEFAULT_CONFIG
    from pocket_tts_tpu_torch.io.gguf import write_gguf
    from pocket_tts_tpu_torch.io.params import random_flat
    from pocket_tts_tpu_torch.io.safetensors_io import save_safetensors
    from pocket_tts_tpu_torch.io.wav import load_wav
    from pocket_tts_tpu_torch.runtime.engine import TTSEngine
    from pocket_tts_tpu_torch.text.tokenizer import MockTokenizer
    flat = random_flat(DEFAULT_CONFIG, seed=0)
    pcms = {}
    for ext in ("safetensors", "gguf"):
        d = os.path.join(tmp, "model_" + ext)
        os.makedirs(d)
        path = os.path.join(d, "tts_b6369a24." + ext)
        t0 = time.perf_counter()
        if ext == "gguf":
            write_gguf(path, flat)
        else:
            save_safetensors(flat, path)
        t1 = time.perf_counter()
        eng = TTSEngine(model_path=d, dtype=torch.bfloat16, device=device,
                        seed=0,
                        tokenizer=MockTokenizer(DEFAULT_CONFIG.lut.n_bins))
        t2 = time.perf_counter()
        pcms[ext] = eng.synthesize(BENCH_TEXT, voice, temp=0.0)
        del eng
        log(f"  {ext} checkpoint: {os.path.getsize(path) / 2**20:.1f} MiB "
            f"written in {t1 - t0:.2f} s, engine loaded in {t2 - t1:.2f} s, "
            f"{pcms[ext].size} samples")
    a, b = pcms["safetensors"], pcms["gguf"]
    if not (a.size > 0 and a.shape == b.shape and np.array_equal(a, b)
            and np.isfinite(a).all()):
        raise AssertionError("the .gguf checkpoint's pcm differs from the "
                             ".safetensors one's")
    log("  the engine from tts_b6369a24.gguf gives the .safetensors "
        "engine's pcm bit for bit")
    cache = os.path.join(tmp, "x.gguf")
    lines, wall = run_cli(["--quantize", "int8", "--save-cache", cache,
                           "--gguf-quantize", "q8_0"])
    wav = os.path.join(tmp, "gguf.wav")
    lines2, wall2 = run_cli(["--load-cache", cache, "-t", "0", "-o", wav,
                             "Hello from a GGUF params cache."])
    pcm, sr = load_wav(wav)
    log(f"  cli --save-cache x.gguf --gguf-quantize q8_0: "
        f"{os.path.getsize(cache) / 2**20:.1f} MiB in {wall:.1f} s; cli "
        f"--load-cache x.gguf: {pcm.size} samples at {sr} Hz in "
        f"{wall2:.1f} s; {lines2[-1]}")
    if not (pcm.size > 0 and pcm.size % 1920 == 0 and np.isfinite(pcm).all()
            and np.abs(pcm).max() > 0):
        raise AssertionError("cli --load-cache x.gguf gave no audio")


def ab_fixture(root):
    """A model directory in the release layout at tiny_config: random
    weights (port's random_flat, seed 61), the voice `cosette` and an
    ASCII SentencePiece tokenizer.model (the JAX package's test fixture's
    pieces, built with the port's text/spm.py)."""
    import string
    from pocket_tts_tpu_torch.config import tiny_config
    from pocket_tts_tpu_torch.io.params import random_flat
    from pocket_tts_tpu_torch.io.safetensors_io import save_safetensors
    from pocket_tts_tpu_torch.text.spm import (CONTROL, NORMAL, UNKNOWN,
                                               SentencePieceModel)
    cfg = tiny_config()
    os.makedirs(os.path.join(root, "embeddings"))
    save_safetensors(random_flat(cfg, seed=61),
                     os.path.join(root, "tts_b6369a24.safetensors"))
    prompt = (np.random.RandomState(0).randn(1, 14, cfg.backbone.d_model)
              * 0.05).astype(np.float32)
    save_safetensors({"voice.audio_prompt": prompt},
                     os.path.join(root, "embeddings", "cosette.safetensors"))
    m = SentencePieceModel()
    pieces = ([("<unk>", 0.0, UNKNOWN), ("<s>", 0.0, CONTROL),
               ("</s>", 0.0, CONTROL), ("\u2581", -3.0, NORMAL)]
              + [(p, -3.0, NORMAL) for p in ("...", ".", "!", "?", ",",
                                             ";", ":")]
              + [("\u2581" + w, -4.0, NORMAL)
                 for w in ("the", "quick", "brown", "fox", "hello")]
              + [(c, -10.0, NORMAL)
                 for c in string.ascii_letters + string.digits + "'\"-()"])
    for piece, score, ptype in pieces:
        m.pieces.append(piece)
        m.scores.append(score)
        m.types.append(ptype)
    with open(os.path.join(root, "tokenizer.model"), "wb") as f:
        f.write(m.serialize())
    return cfg


def check_ab(tmp):
    """`pocket_tts_tpu_torch.ab` on `ab_fixture`'s directory, in process,
    on the card and on the CPU (-d cpu): each exits 0 and writes its wav
    and probes; the card's probe sums (voice and prefill KV per layer,
    each frame's latent and pcm) are within 1e-3 of the CPU's, relative
    to the CPU's, its EOS flags and quantization-error reports equal.
    Without --no-verify the fixture fails the manifest check (exit 2)."""
    from pocket_tts_tpu_torch import ab
    root = os.path.join(tmp, "ab_model")
    ab_fixture(root)
    probes = {}
    for dev in ("cuda", "cpu"):
        out = os.path.join(tmp, "ab_" + dev)
        t0 = time.perf_counter()
        rc = ab.main(["--model-dir", root, "-o", out, "--no-verify", "-d",
                      dev, "--text", "Hi there.", "--frames", "4"])
        if rc != 0 or not os.path.exists(os.path.join(out, "ab_out.wav")):
            raise AssertionError(f"ab -d {dev} exit {rc}")
        with open(os.path.join(out, "ab_probes.json")) as f:
            probes[dev] = json.load(f)
        log(f"  ab -d {dev}: {time.perf_counter() - t0:.1f} s")
    g, c = probes["cuda"], probes["cpu"]
    pairs = (list(zip(g["voice_kv_sum"], c["voice_kv_sum"]))
             + list(zip(g["prefill_kv_sum"], c["prefill_kv_sum"]))
             + [(fg[k], fc[k]) for fg, fc in zip(g["frame"], c["frame"])
                for k in ("latent_sum", "pcm_sum")])
    worst = max(abs(a - b) / max(abs(b), 1e-30) for a, b in pairs)
    same = (len(g["frame"]) == len(c["frame"]) == 4
            and [f["eos"] for f in g["frame"]] == [f["eos"] for f in
                                                   c["frame"]]
            and all(g[k] == c[k] for k in ("quant_rel_error_int4",
                                           "quant_rel_error_int8",
                                           "quant_rel_error_q4_0")))
    log(f"  ab probes, card vs CPU: {len(pairs)} sums, largest relative "
        f"difference {worst:.3e} (tol 1e-3); EOS flags and quantization "
        f"reports ({len(g['quant_rel_error_int4'])} weights) equal: {same}")
    if not (worst <= 1e-3 and same):
        raise AssertionError("ab probes differ between the card and the CPU")
    if ab.main(["--model-dir", root, "-o", os.path.join(tmp, "ab_v"),
                "-d", "cpu"]) != 2:
        raise AssertionError("ab passed the manifest check on a fixture")


def wide_chunk_walls(engine, voice, lanes=WIDE_LANES, n=8):
    """The wall per chunk with all `lanes` lanes busy in the serving mode
    (shared prefix; the engine's int4 weights and int8 KV), on the host
    clock, each chunk synchronized: reported, not checked. Returns the
    walls (us)."""
    srv = busy_server(engine, voice, lanes, share_prefix=True)
    walls = chunk_walls(srv, n)
    wall = float(np.median(walls))
    frames = lanes * srv.chunk_frames
    log(f"  serving mode, {lanes} lanes busy: wall per {srv.chunk_frames}-"
        f"frame chunk median {wall:.1f} us, range {min(walls):.1f}-"
        f"{max(walls):.1f} over {n} chunks: {frames / wall * 1e6:.1f} "
        f"frames/s aggregate (host clock; after phase 8's profiler "
        f"runs)")
    return walls


# ------------------------------------------------------------------- main --

# ------------------------------------------------ phase 10: dormant modules --

# the modules a checkpoint switches on (the shipped checkpoints carry
# none): SwiGLU gating in the mimi layers with RMSNorm alphas
# ("gated_rms"; hidden GATING_HIDDEN, linear_in 512 -> 2048 and linear_out
# 1024 -> 512 at full width, a width K4's layouts take), and
# cross-attention in the backbone and mimi layers over a COND_ROWS-row
# conditioning ("cross")
GATING_HIDDEN = 1024
COND_ROWS = 64
DORMANT_PATHS = ("gated_rms", "cross")
# frames a cross run decodes (no engine entry point: frame by frame)
CROSS_FRAMES = 40
# the encoder check: 25 calls of one frame's samples
ENCODER_FRAMES = 25


def dormant_extras(cfg, seed=0):
    """numpy weights of the dormant modules at cfg's widths from
    RandomState(seed), stacked over the layers in the loader's layouts
    (linear w as (in, out)): the mimi norms' alphas, the gating, the
    backbone's and the mimi's cross sub-blocks, and the two conditioning
    sequences."""
    rng = np.random.RandomState(seed)
    bb, mt = cfg.backbone, cfg.mimi.transformer
    lm, md, h = mt.num_layers, mt.d_model, GATING_HIDDEN

    def w(*shape):
        return (rng.randn(*shape) / np.sqrt(shape[-2])).astype(np.float32)

    def cross(n, d):
        return {"norm_cross": {
                    "scale": (1 + 0.1 * rng.randn(n, d)).astype(np.float32),
                    "bias": (0.1 * rng.randn(n, d)).astype(np.float32)},
                "cross_attention": {"in_proj": {"w": w(n, d, 3 * d)},
                                    "out_proj": {"w": w(n, d, d)}}}

    return {"alpha": [(1 + 0.1 * rng.randn(lm, md)).astype(np.float32)
                      for _ in range(2)],
            "gating": {"linear_in": {"w": w(lm, md, 2 * h)},
                       "linear_out": {"w": w(lm, h, md)}},
            "bb_cross": cross(bb.num_layers, bb.d_model),
            "mimi_cross": cross(lm, md),
            "cond_bb": (0.5 * rng.randn(COND_ROWS, bb.d_model)).astype(
                np.float32),
            "cond_mimi": (0.5 * rng.randn(COND_ROWS, md)).astype(
                np.float32)}


def dormant_params(params, path, ex, quantize=None):
    """A copy of an engine's params tree with the modules of `path` added
    from `dormant_extras` ex, in the tree's float type and on its device:
    "gated_rms" (the mimi norms as alphas, and gating), "cross" (the
    backbone's and the mimi's cross sub-blocks); the new linears quantized
    as quantize_params quantizes them (QUANTIZE[quantize]) when quantize
    is given (the tree's own linears are left as they are)."""
    import torch
    from pocket_tts_tpu_torch.io.quant import quantize_params
    ref = params["bos_emb"]

    def put(tree):
        if isinstance(tree, dict):
            return {k: put(v) for k, v in tree.items()}
        return torch.from_numpy(tree).to(ref.device, ref.dtype)

    def lin(tree):
        tree = put(tree)
        return (quantize_params(tree, **QUANTIZE[quantize]) if quantize
                else tree)

    p = dict(params)
    mimi = dict(p["mimi"])
    lay = dict(mimi["decoder_transformer"]["layers"])
    if path == "gated_rms":
        lay["norm1"], lay["norm2"] = ({"alpha": put(a)} for a in ex["alpha"])
        lay["gating"] = lin(ex["gating"])
    else:
        bbl = dict(p["layers"])
        for layers, key in ((bbl, "bb_cross"), (lay, "mimi_cross")):
            layers["norm_cross"] = put(ex[key]["norm_cross"])
            layers["cross_attention"] = lin(ex[key]["cross_attention"])
        p["layers"] = bbl
    mimi["decoder_transformer"] = {"layers": lay}
    p["mimi"] = mimi
    return p


def dormant_launches(cfg, path, quantize=None):
    """Launches per decoded frame of a dormant path (bf16 or int8
    weights): K1 on every backbone layer (a cross state runs no K7, K8 or
    bilayer loop), K2 on every mimi layer, one K3 sequence. With int8
    weights gated_rms adds the int8 path's backbone kernels (K5a/K5b on
    the backbone layers only, K5a of T = 1 on the skinny kernel), K6, and
    K4a for input_linear and the four linears of each mimi layer (in_proj,
    out_proj, gating's two); cross fuses no layer: K4a on input_linear
    and the six linears of each backbone and mimi layer."""
    import torch
    from pocket_tts_tpu_torch.ops.fused_flow import LAUNCHES
    from pocket_tts_tpu_torch.ops.fused_layer import rows_route
    nb, nm = cfg.backbone.num_layers, cfg.mimi.transformer.num_layers
    per = {"decode_attn": nb, "ring_attn": nm, "seanet_frame": 1}
    if quantize is None:
        return per
    if quantize != "int8":
        raise ValueError(f"dormant paths run bf16 or int8, not {quantize}")
    per["fused_flow"] = LAUNCHES
    if path == "gated_rms":
        per.update(int8_matmul=1 + 4 * nm, fused_pre=nb, fused_post=nb)
        if rows_route(torch.bfloat16, 1) == "skinny":
            per["rows_skinny"] = nb
    else:
        per["int8_matmul"] = 1 + 6 * nb + 6 * nm
    return per


def cross_stream(engine, voice, ex, text=BENCH_TEXT):
    """A StreamState of `text` (temp 0) whose backbone and mimi states hold
    cross KV: backbone.init_cross on a full-capacity state, the voice
    prompt primed through it, the sentence prefilled with the mimi's
    conditioning (tts.sentence_prefill(mimi_cond=)). Returns (state,
    max_steps)."""
    import torch
    from pocket_tts_tpu_torch.models import backbone, tts
    from pocket_tts_tpu_torch.runtime.engine import _bucket
    from pocket_tts_tpu_torch.text.preprocess import (count_words,
                                                      prepare_text_prompt)
    p, cfg, dev, dt = engine.params, engine.cfg, engine.device, engine.dtype
    prepared, _ = prepare_text_prompt(text)
    ids = engine.tokenizer.encode(prepared)
    tokens = torch.zeros(_bucket(len(ids)), dtype=torch.long, device=dev)
    tokens[:len(ids)] = torch.as_tensor(ids, dtype=torch.long)
    prompt = torch.from_numpy(np.asarray(voice, np.float32)).to(dev, dt)
    n = prompt.shape[0]
    prompt = torch.cat([prompt, prompt.new_zeros(-n % 16, prompt.shape[1])])
    with torch.no_grad():
        state = backbone.init_cross(
            p, cfg.backbone, backbone.init_state(cfg.backbone, dt, dev),
            torch.from_numpy(ex["cond_bb"]).to(dev, dt))
        tts.prime_voice(p, cfg, state, prompt, n)
        st = tts.sentence_prefill(
            p, cfg, state, tokens, len(ids),
            mimi_cond=torch.from_numpy(ex["cond_mimi"]).to(dev, dt))
    if st.flow.xk is None or st.mimi.transformer.xk is None:
        raise AssertionError("cross stream without cross KV")
    return st, int((count_words(prepared) + 2.0) * cfg.mimi.frame_rate)


def dormant_stream(engine, voice, path, ex):
    """(StreamState, max_steps) of BENCH_TEXT at temp 0 on a dormant path:
    the engine's own prefill for gated_rms, `cross_stream` for cross."""
    if path == "cross":
        return cross_stream(engine, voice, ex)
    from pocket_tts_tpu_torch.text.preprocess import prepare_text_prompt
    prepared, _ = prepare_text_prompt(BENCH_TEXT)
    return engine._prefill_sentence(engine.prime_voice(voice), prepared)


def stream_frames(engine, state, n):
    """pcm of n frames of `state` at temp 0 (zero noise), (n, frame) on
    the host."""
    import torch
    from pocket_tts_tpu_torch.models import tts
    zero = torch.zeros(engine.cfg.latent_dim, dtype=engine.dtype,
                       device=engine.device)
    out = []
    with torch.no_grad():
        for _ in range(n):
            pcm, _ = tts.frame_step(engine.params, engine.cfg, state, zero,
                                    10 ** 6, 10 ** 6, engine.seanet_weights)
            out.append(pcm.cpu())
    return torch.stack(out).numpy()


def check_cross_run(engine, voice, ex, label, quantize=None):
    """CROSS_FRAMES frames of a cross stream with the counters set to 0
    just before and read just after: finite, audible pcm and the launches
    of `dormant_launches` per frame (so 0 K7, K8, K5a, K5b, K5c). Returns
    the counters."""
    state, _ = cross_stream(engine, voice, ex)
    sync(engine.device)
    reset_counters()
    t0 = time.perf_counter()
    pcm = stream_frames(engine, state, CROSS_FRAMES)
    sync(engine.device)
    wall = time.perf_counter() - t0
    launches = read_counters()
    per = dormant_launches(engine.cfg, "cross", quantize)
    log(f"  {label}: {CROSS_FRAMES} frames in {wall:.3f} s; launches "
        f"{ {k: v for k, v in launches.items() if v} }; expected per frame "
        f"{per}")
    if not (np.isfinite(pcm).all() and np.abs(pcm).max() > 0):
        raise AssertionError(f"{label}: non-finite or silent pcm")
    for name in list(KERNELS) + ["rows_mma", "rows_skinny"]:
        if launches[name] != per.get(name, 0) * CROSS_FRAMES:
            raise AssertionError(f"{label} {name}: {launches[name]} "
                                 f"launches for {CROSS_FRAMES} frames")
    return launches


def check_native():
    """The native library built from the repo's source on this machine:
    the splitter equals StrProcessor on BENCH_TEXT (twice, so it splits)
    fed in 15-character chunks, and a FIFO round trip returns its
    samples."""
    from pocket_tts_tpu_torch import native
    from pocket_tts_tpu_torch.text.preprocess import StrProcessor
    t0 = time.perf_counter()
    native.library()
    built = time.perf_counter() - t0
    text = BENCH_TEXT + " " + BENCH_TEXT.lower() + " and more"
    py, nat = StrProcessor(), native.make_str_processor()
    for i in range(0, len(text), 15):
        py.ingest(text[i:i + 15])
        nat.ingest(text[i:i + 15])
    py.flush()
    nat.flush()
    a, b = list(nat.sentences), list(py.sentences)
    if a != b or len(a) < 2:
        raise AssertionError(f"native splitter {a} vs StrProcessor {b}")
    fifo = native.PcmFifo(3 * 1920)
    pcm = np.random.RandomState(0).randn(4 * 1920).astype(np.float32)
    took = fifo.push(pcm)
    back = fifo.pop(4 * 1920)
    if took != 3 * 1920 or not np.array_equal(back, pcm[:took]) or len(fifo):
        raise AssertionError("native PcmFifo round trip")
    log(f"  native library {native._state['path']}: built and loaded in "
        f"{built:.2f} s; splitter == StrProcessor on {len(a)} sentences; "
        f"FIFO round trip of {took} samples")


def encoder_weights(cfg, seed=0):
    """numpy SEANet encoder convs at cfg's widths from RandomState(seed),
    in the loader's tree (`io.params._encoder`)."""
    sc = cfg.mimi.seanet
    rng = np.random.RandomState(seed)

    def conv(cout, cin, k):
        return {"w": (rng.randn(cout, cin, k) / np.sqrt(cin * k)).astype(
                    np.float32),
                "b": (0.05 * rng.randn(cout)).astype(np.float32)}

    n = len(sc.stages)
    enc = {"model_0": conv(sc.stages[-1].out_ch, sc.out_ch,
                           sc.first_kernel)}
    for gi, st in enumerate(reversed(sc.stages)):
        c = st.out_ch
        enc[f"model_{3 * gi + 1}"] = {
            "block_1": conv(c // 2, c, sc.resnet_kernel),
            "block_3": conv(c, c // 2, 1)}
        enc[f"model_{3 * gi + 3}"] = conv(st.in_ch, st.out_ch, st.kernel)
    enc[f"model_{3 * n + 2}"] = conv(sc.in_ch, sc.stages[0].in_ch,
                                     sc.last_kernel)
    return enc


def encoder_conv_shapes(cfg):
    """[(module, K, N, rows a call)] of the encoder convs that
    quantize_params(convs=True) quantizes, from the cfg's dims alone, for
    one call of frame_size samples: a conv1d named as a conv module
    (model_0, the resnets' block_1 / block_3, the final conv) of at least
    _MIN_CONV_QUANT_SIZE elements, as its window product (K*Cin, Cout)
    over the rows the strides before it leave."""
    from pocket_tts_tpu_torch.io.quant import _MIN_CONV_QUANT_SIZE
    sc = cfg.mimi.seanet
    rows = cfg.mimi.frame_size
    out = []

    def add(name, cin, cout, k, n_rows):
        if cin * cout * k >= _MIN_CONV_QUANT_SIZE:
            out.append((name, k * cin, cout, n_rows))

    add("model_0", sc.out_ch, sc.stages[-1].out_ch, sc.first_kernel, rows)
    for gi, st in enumerate(reversed(sc.stages)):
        c, ri = st.out_ch, f"model_{3 * gi + 1}"
        add(f"{ri}.block_1", c, c // 2, sc.resnet_kernel, rows)
        add(f"{ri}.block_3", c // 2, c, 1, rows)
        rows //= st.stride
    add(f"model_{3 * len(sc.stages) + 2}", sc.stages[0].in_ch, sc.in_ch,
        sc.last_kernel, rows)
    return out


def encoder_products(enc, cfg):
    """[(module, key, weight, scale, rows a call)] of the quantized convs
    (qc / qc4) of an encoder tree, in the chain's order, for one call of
    frame_size samples."""
    sc = cfg.mimi.seanet
    rows = cfg.mimi.frame_size
    out = []

    def add(name, mod, n_rows):
        for key in ("qc", "qc4"):
            if key in mod:
                out.append((name, key, mod[key], mod["scale"], n_rows))

    add("model_0", enc["model_0"], rows)
    for gi, st in enumerate(reversed(sc.stages)):
        ri = f"model_{3 * gi + 1}"
        for blk in ("block_1", "block_3"):
            add(f"{ri}.{blk}", enc[ri][blk], rows)
        add(f"model_{3 * gi + 3}", enc[f"model_{3 * gi + 3}"], rows)
        rows //= st.stride
    fi = f"model_{3 * len(sc.stages) + 2}"
    add(fi, enc[fi], rows)
    return out


def gating_products(gating):
    """[(name, key, weight, scale, rows)] of one mimi layer's quantized
    gating linears (q / q4) at 16 rows (solo) and LANES x 16 (lanes)."""
    from pocket_tts_tpu_torch.ops.basic import slice_layer_params
    g = slice_layer_params(gating, 0)
    return [(f"gating.{name}", key, g[name][key], g[name]["scale"], rows)
            for name in ("linear_in", "linear_out")
            for key in ("q", "q4") if key in g[name]
            for rows in (16, LANES * 16)]


def check_dormant_kernels(cfg, device, results):
    """K4a and K4b vs their plain versions at the encoder's quantized
    convs (`encoder_products` of int8 and int4 trees quantized with
    convs, which must be `encoder_conv_shapes`) and at the gating linears,
    f32 and bf16, inputs from RandomState(12); the route of each shape
    logged. Returns {bits: the quantized encoder tree (f32 on the
    card)}."""
    import torch
    from pocket_tts_tpu_torch.io.quant import quantize_params
    ex = dormant_extras(cfg)
    enc32 = _to_tree(encoder_weights(cfg), device, torch.float32)
    want = encoder_conv_shapes(cfg)
    rng = np.random.RandomState(12)
    trees = {}
    for bits in (8, 4):
        q = quantize_params(enc32, bits=bits, convs=True)
        trees[bits] = q
        prods = encoder_products(q, cfg)
        got = [(name, w.shape[0] * (2 if key.endswith("4") else 1),
                w.shape[1], rows) for name, key, w, _, rows in prods]
        if got != want:
            raise AssertionError(f"encoder convs {got}, expected {want}")
        gq = quantize_params(_to_tree(ex["gating"], device,
                                      torch.float32), bits=bits)
        prods += gating_products(gq)
        for dtype in (torch.float32, torch.bfloat16):
            pairs, routes = [], []
            for name, key, w, scale, rows in prods:
                mm_name, mm, plain = conv_matmul_fns(
                    "qc" if key in ("q", "qc") else "qc4")
                k = w.shape[0] * (2 if key.endswith("4") else 1)
                x = _rand(rng, device, dtype, rows, k, scale=0.5)
                sc = scale.to(device)
                pairs.append((mm(x, w, sc), plain(x, w, sc)))
                routes.append((name, rows, k, w.shape[1],
                               conv_route(key if key != "q" else "qc",
                                          dtype, rows)))
            sync(device)
            _rel_check(mm_name, "quant", dtype, pairs, results,
                       " [encoder convs, gating]")
            log(f"    routes (module, rows, K, N, kernel): {routes}")
    return trees


def _to_tree(tree, device, dtype):
    import torch
    if isinstance(tree, dict):
        return {k: _to_tree(v, device, dtype) for k, v in tree.items()}
    return torch.from_numpy(np.asarray(tree)).to(device, dtype)


def _rel_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    if got.shape != want.shape or not np.isfinite(got).all():
        return float("inf")
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def check_encoder(cfg, device, qtrees):
    """The SEANet encoder on ENCODER_FRAMES frames of samples
    (RandomState(13)): on the card in f32 the frame-sized calls equal one
    call over all samples within 1e-5 (relative to the largest latent),
    the card equals the CPU within 1e-4, bf16 equals f32 within SEANet's
    bf16 tolerance, and the int8 and int4 encoders (quantized convs, one
    K4a / K4b launch a quantized conv a call, counted) equal their CPU
    runs within the f32 quant tolerance."""
    import torch
    from pocket_tts_tpu_torch.models import seanet
    sc, fs = cfg.mimi.seanet, cfg.mimi.frame_size
    x = (0.3 * np.random.RandomState(13).randn(ENCODER_FRAMES * fs, 1)
         ).astype(np.float32)

    def run(enc, dev, dtype, chunk):
        st = seanet.encoder_init_state(sc, dtype, dev)
        xt = torch.from_numpy(x).to(dev, dtype)
        with torch.no_grad():
            ys = [seanet.encoder_forward(enc, sc, st, xt[i:i + chunk])[1]
                  for i in range(0, xt.shape[0], chunk)]
        return torch.cat(ys).float().cpu().numpy()

    enc_np = encoder_weights(cfg)
    e32 = _to_tree(enc_np, device, torch.float32)
    streamed = run(e32, device, torch.float32, fs)
    checks = [("streamed vs one call, card f32", _rel_err(
                   streamed, run(e32, device, torch.float32, x.shape[0])),
               1e-5),
              ("card vs CPU, f32", _rel_err(streamed, run(
                   _to_tree(enc_np, "cpu", torch.float32), "cpu",
                   torch.float32, fs)), 1e-4),
              ("bf16 vs f32, card", _rel_err(run(
                   _to_tree(enc_np, device, torch.bfloat16), device,
                   torch.bfloat16, fs), streamed), TOL[("seanet", "bf16")])]
    for bits, q in qtrees.items():
        mm = "int8_matmul" if bits == 8 else "int4_matmul"
        reset_counters()
        got = run(q, device, torch.float32, fs)
        launches = read_counters()[mm]
        n_q = len(encoder_products(q, cfg))
        if launches != n_q * ENCODER_FRAMES:
            raise AssertionError(f"int{bits} encoder: {launches} {mm} "
                                 f"launches for {ENCODER_FRAMES} calls")
        checks.append((f"int{bits} convs, card vs CPU, f32", _rel_err(
            got, run(_tree_cpu(q), "cpu", torch.float32, fs)),
            TOL[("quant", "f32")]))
    for label, err, tol in checks:
        log(f"  encoder {label}: {ENCODER_FRAMES * fs} samples -> "
            f"{streamed.shape} latents, max error relative to max|ref| "
            f"{err:.3e} (tol {tol})")
        if not err <= tol:
            raise AssertionError(f"encoder {label}: {err} > {tol}")


def _tree_cpu(tree):
    if isinstance(tree, dict):
        return {k: _tree_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_cpu(v) for v in tree)
    return tree.cpu()


def check_weights_per_step(cfg, device):
    """weights_per_step_gating with M = 4 stacked modules and a schedule at
    the mimi's widths (GATING_HIDDEN, 16 rows, offset 3), f32, card vs
    CPU within 1e-4 of the largest output."""
    import torch
    from pocket_tts_tpu_torch.ops.gating import weights_per_step_gating
    md = cfg.mimi.transformer.d_model
    rng = np.random.RandomState(14)
    g = {"linear_in": {"w": (rng.randn(4, md, 2 * GATING_HIDDEN)
                             / np.sqrt(md)).astype(np.float32),
                       "b": (0.1 * rng.randn(4, 2 * GATING_HIDDEN)).astype(
                           np.float32)},
         "linear_out": {"w": (rng.randn(4, GATING_HIDDEN, md)
                              / np.sqrt(GATING_HIDDEN)).astype(np.float32)}}
    x = (0.5 * rng.randn(16, md)).astype(np.float32)
    schedule = (3, 0, 1, 1, 2, 3, 0, 2, 1, 3, 3, 0, 2, 2, 1, 0, 3, 1, 2, 0)
    got, want = (weights_per_step_gating(
        _to_tree(g, dev, torch.float32), torch.from_numpy(x).to(dev),
        offset=3, schedule=schedule).cpu().numpy() for dev in (device, "cpu"))
    err = _rel_err(got, want)
    log(f"  weights-per-step gating, M = 4, schedule, 16 rows: card vs CPU "
        f"f32, max error relative to max|CPU| {err:.3e} (tol 1e-4)")
    if not err <= 1e-4:
        raise AssertionError(f"weights-per-step gating card vs CPU {err}")


def dormant_engines(engines, cfg, device, dtype):
    """{label: engine} of the dormant paths in `dtype` on the card:
    gated_rms and cross on the bf16 engine's weights, gated_rms_int8 and
    cross_int8 on the int8 engine's (engines: phase 3's, keyed (path,
    dtype)); the extras from `dormant_extras`."""
    ex = dormant_extras(cfg)
    out = {}
    for path in DORMANT_PATHS:
        for quant in (None, "int8"):
            base = engines["bf16" if quant is None else quant, dtype]
            label = path if quant is None else f"{path}_{quant}"
            out[label] = make_engine(base.cfg, device, dtype,
                                     params=dormant_params(
                                         base.params, path, ex, quant))
    return out, ex


def check_dormant_card_vs_cpu(cfg, device, voice, ex):
    """Both dormant paths with float weights: 12 frames of f32 on the card
    vs the CPU (the CPU engine's tree a copy of the card's) within
    TOL e2e f32 of the largest |pcm|."""
    import torch
    from pocket_tts_tpu_torch.io.params import random_params
    base, cfg = random_params(cfg, seed=0, dtype=torch.float32,
                              device=device)
    for path in DORMANT_PATHS:
        p = dormant_params(base, path, ex)
        pcm = []
        for dev, tree in ((device, p), ("cpu", _tree_cpu(p))):
            eng = make_engine(cfg, dev, torch.float32, params=tree)
            state, _ = dormant_stream(eng, voice, path, ex)
            pcm.append(stream_frames(eng, state, 12))
            del eng
        err = _rel_err(*pcm)
        tol = TOL[("e2e", "f32")]
        log(f"  {path}: 12 f32 frames card vs CPU, max error relative to "
            f"max|pcm cpu| {err:.3e} (tol {tol})")
        if not (err <= tol and np.abs(pcm[1]).max() > 0):
            raise AssertionError(f"{path}: card vs CPU {err}")


def time_dormant(engines, voice, ex, n_frames=40, rounds=2, n_prof=10):
    """Frames/s of each of `engines` ({label: engine}; "cross" labels on
    cross streams) with the per-frame EOS sync, in rounds whose order
    flips; then under torch.profiler (`profiled_steps`, n_prof frames)
    the device busy us a frame, the kernel launches a frame and the launch
    counters a frame. Returns {label: (median frames/s, busy us,
    launches, counted)}."""
    import torch
    from pocket_tts_tpu_torch.models import tts
    labels = list(engines)
    fps = {k: [] for k in labels}

    def fresh(label):
        eng = engines[label]
        path = "cross" if label.startswith("cross") else "gated_rms"
        return dormant_stream(eng, voice, path, ex)[0]

    for r in range(rounds):
        for label in (labels if r % 2 == 0 else labels[::-1]):
            eng = engines[label]
            state = fresh(label)
            zero = torch.zeros(eng.cfg.latent_dim, dtype=eng.dtype,
                               device=eng.device)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with torch.no_grad():
                for _ in range(n_frames):
                    tts.frame_step(eng.params, eng.cfg, state, zero,
                                   10 ** 6, 10 ** 6, eng.seanet_weights)
            torch.cuda.synchronize()
            fps[label].append(n_frames / (time.perf_counter() - t0))
    out = {}
    for label in labels:
        eng = engines[label]
        state = fresh(label)
        zero = torch.zeros(eng.cfg.latent_dim, dtype=eng.dtype,
                           device=eng.device)

        def step():
            with torch.no_grad():
                tts.frame_step(eng.params, eng.cfg, state, zero, 10 ** 6,
                               10 ** 6, eng.seanet_weights)

        torch.cuda.synchronize()
        ka, counted = profiled_steps(step, n_prof)
        kern = device_kernels(ka, n_prof)
        out[label] = (float(np.median(fps[label])), sum(r[1] for r in kern),
                      sum(r[2] for r in kern),
                      {k: v for k, v in counted.items() if v})
        wall = 1e6 / out[label][0]
        log(f"  {label}: frames/s ({n_frames}-frame rounds, EOS sync) "
            + ", ".join(f"{f:.1f}" for f in fps[label])
            + f"; device busy {out[label][1]:.1f} us a frame in "
            f"{out[label][2]:.0f} kernel launches (device idle "
            f"{1 - out[label][1] / wall:.1%} of the median wall "
            f"{wall:.1f} us), counters a frame {out[label][3]}")
    return out


def time_encoder_kernels(qtrees, cfg, device):
    """Device time of K4a / K4b at each quantized encoder conv (bf16 x,
    one call's rows) beside the plain version, the library call and the
    bound, logged."""
    import torch
    from pocket_tts_tpu_torch.ops.quant_matmul import deq_dot
    rng = np.random.RandomState(15)
    for bits, q in qtrees.items():
        for name, key, w, scale, rows in encoder_products(q, cfg):
            mm_name, mm, plain = conv_matmul_fns(key)
            k, n = w.shape[0] * (2 if key.endswith("4") else 1), w.shape[1]
            x = _rand(rng, device, torch.bfloat16, rows, k, scale=0.5)
            y = mm(x, w, scale)
            kern = device_ms(lambda: mm(x, w, scale), 50)
            pl = device_ms(lambda: plain(x, w, scale), 20)
            lin = ({"q": w, "scale": scale} if key == "qc"
                   else {"q4": w, "scale": scale})
            lib = (int8pack_ms(x, w, scale) if key == "qc"
                   else int4pack_ms(x, lin, y))
            wd = deq_dot(torch.eye(k, device=device), lin).to(x.dtype)
            dense = device_ms(lambda: x @ wd, 50)[0]
            bound = bound_ms(_nbytes(x, y, w, scale), 2 * rows * k * n)
            log(f"  K4 encoder int{bits} {name} rows={rows} K={k} N={n} "
                f"({conv_route(key, torch.bfloat16, rows)}): kernel "
                f"{kern[0] * 1e3:.2f} us device, {kern[1] * 1e3:.2f} us "
                f"host; plain {pl[0] * 1e3:.2f} us; library "
                + ("none" if lib is None else f"{lib * 1e3:.2f} us")
                + f"; dense bf16 {dense * 1e3:.2f} us; bound "
                f"{bound[0] * 1e3:.2f} us ({bound[1]}): "
                f"{bound[0] / kern[0]:.1%} of it")


# ---------------------------------------------------------------------------
# phase 11: sharded serving over a ("data", "model") mesh of gloo ranks on
# the one card; phase 12 (--cards 4): meshes over NCCL, one rank a card
# ---------------------------------------------------------------------------

# data x model of phase 11's mesh: four ranks share the one card over gloo
# (NCCL refuses two ranks on one device)
MESH_SHAPE = (2, 2)
# one rank's kernel shapes at model 2: backbone and mimi heads, and the
# lanes a rank holds of a 32-lane server at data 2
MESH_HEADS = (8, 4)
MESH_RANK_LANES = LANES // 2
# phases 11b/c/e: six short requests on 4 lanes (at temp 0 the random
# weights never fire EOS, so each runs its (words + 2) * 12.5 frames: the
# last two are admitted mid-decode at step 50, the run ends near step
# 115); gloo's all-reduces make a sharded step ~100 ms on one card
MESH_TEXTS = ("Hello there.", "Short one here.", "Two words.",
              "Serving many streams.", "A fifth one.", "And a sixth.")
_MESH = {}   # a rank's engines and step counter, kept across its jobs
# sharded vs unsharded bf16 serving, relative to max |pcm|. The pcm of a
# bf16 engine is rounded to bf16, so one ulp at the peak is already 2^-8 to
# 2^-7 of max |pcm|, above the f32 bound of phase 7 (1e-3); the sharded run
# rounds at the same points, but cuBLAS picks other kernels for the halved
# widths, and a sum can round one ulp apart. 2^-6 is two to four ulps at
# the peak, by where the peak lies in its binade (about 2.2 at the peak
# these weights give, where one ulp is 7.246e-3 of it)
MESH_BF16_TOL = 2.0 ** -6

# phase 12: the cards it needs, one NCCL rank a card
CARDS = 4
# one rank's kernel shapes at model 4: 4 of the 16 backbone heads (one K7
# block), 2 of the 8 mimi heads, over the 32 lanes of a 1 x 4 server (and
# the 32 a rank holds of 12d's 128 at data 4)
CARDS_HEADS = (4, 2)
# K3 over a data rank's lanes: 8 (a 32-lane server at data 4), 32 (12d)
CARDS_K3_LANES = (LANES // 4, LANES)
# K4a / K4b rows at a model-4 rank: 2 and 16 as phase 11f, 32 (the 1 x 4
# server's backbone and flow net rows), 256 (a prefill's)
CARDS_K4_ROWS = (2, 16, LANES, 256)
# 12c: phase 7's 48 requests (SERVE_TEXTS in turn) on 32 lanes; 12d: 128
# lanes, each with SERVE_TEXTS[3] (175 frames), all busy to the end
SERVE48 = tuple(SERVE_TEXTS[i % len(SERVE_TEXTS)] for i in range(48))
WIDE_TEXTS = (SERVE_TEXTS[3],) * WIDE_LANES
# 12c and 12d: (data, model), dtype, weights, lanes, requests, label; the
# server of phase 11 otherwise (int8 KV, int8 mimi ring, shared prefix).
# 1 x 1 is the mesh's route (no fused kernel, `sharding.fusable`) on one
# card with no collective: what that route costs apart from the cards
CARDS_SERVE_RUNS = (
    ((1, 1), "bf16", "int4", LANES, SERVE48,
     "12c serving mode, 1 x 1 (the mesh route, one card)"),
    ((1, 4), "bf16", "int4", LANES, SERVE48, "12c serving mode, 1 x 4"),
    ((1, 4), "f32", None, LANES, SERVE48, "12c f32 float weights, 1 x 4"),
    ((4, 1), "bf16", "int4", LANES, SERVE48, "12c serving mode, 4 x 1"),
    ((4, 1), "bf16", "int4", WIDE_LANES, WIDE_TEXTS,
     f"12d serving mode, 4 x 1, {WIDE_LANES} lanes"),
)


def check_mesh_kernels(device, dtype, results, heads=MESH_HEADS,
                       b=MESH_RANK_LANES):
    """K1 over lanes with statistics (caches of the working type and
    int8), K7 with statistics (caches of the working type and int8) and K2
    (rings of the working type and int8) at one rank's shapes (`heads`:
    backbone and mimi heads a rank; b lanes) vs their plain versions; the
    caches (and scale rows) after each insert equal."""
    import torch
    from pocket_tts_tpu_torch.ops.decode_attn import (decode_attention,
                                                      decode_attention_plain)
    from pocket_tts_tpu_torch.ops.insert_attn import (
        decode_insert_attention, decode_insert_attention_plain)
    from pocket_tts_tpu_torch.ops.ring_attn import (
        ring_insert_attention, ring_insert_attention_plain)
    hb, hm = heads
    g = torch.Generator(device="cpu").manual_seed(31)
    worst = {}

    def stats_err(got, want):
        live = torch.isfinite(want[1])
        if not torch.equal(live, torch.isfinite(got[1])):
            raise AssertionError("mesh kernels: m masks differ")
        return max((got[0].float() - want[0].float()).abs().max().item(),
                   (got[1][live] - want[1][live]).abs().max().item(),
                   ((got[2][live] - want[2][live]).abs()
                    / want[2][live]).max().item())

    for kvq in (False, True):
        name = f"K1 lanes + stats{' int8' if kvq else ''}, H={hb}"
        for s, end in ((1024, None), (896, 700)):
            q, k, v, ks, vs, pos, end = k1_lanes_case(g, device, dtype, kvq,
                                                      s, b, end, h=hb)
            got = decode_attention(q, k, v, pos, end, ks, vs, stats=True)
            want = decode_attention_plain(q, k, v, pos, end, ks, vs,
                                          stats=True)
            sync(device)
            worst[name] = max(worst.get(name, 0.0), stats_err(got, want))
    for kvq in (False, True):
        name = f"K7{' int8' if kvq else ''} + stats, H={hb}"
        for mode in ("ring", "linear"):
            if kvq:
                (q, kn, vn, cur, k, v, pos, re_, ws, ks, vs, ksn,
                 vsn) = k7_kv8_case(g, device, dtype, mode, b, h=hb)
                caches = (k, v, ks, vs)
            else:
                q, kn, vn, cur, k, v, pos, re_, ws = k7_case(
                    g, device, dtype, mode, b, h=hb)
                caches = (k, v)
            runs = []
            for fn in (decode_insert_attention,
                       decode_insert_attention_plain):
                c = [t.clone() for t in caches]
                kw = (dict(k_scale=c[2], v_scale=c[3], ks_new=ksn,
                           vs_new=vsn) if kvq else {})
                runs.append((fn(q, kn, vn, cur, c[0], c[1], pos, re_, ws,
                                stats=True, **kw), c))
            sync(device)
            (got, c1), (want, c2) = runs
            if not all(torch.equal(x, y) for x, y in zip(c1, c2)):
                raise AssertionError(f"{name}: caches differ ({mode})")
            worst[name] = max(worst.get(name, 0.0), stats_err(got, want))
    cap, t, ctx, hd = 256, 16, 250, hm * 64
    for kvq in (False, True):
        name = f"K2{'-q' if kvq else ''} lanes, H={hm}"
        for off in (240, 4096):
            starts = torch.tensor([(i * 97) % (off + 1) // t * t
                                   for i in range(b)], dtype=torch.int32)
            starts[0], starts[1] = 0, off
            st = starts.to(device)
            q = torch.randn(b, t, hd, generator=g).to(device, dtype)
            if kvq:
                (kn, ksn), (vn, vsn) = (kv8_rows(g, device, dtype, b, t, hd)
                                        for _ in range(2))
                (k, ks), (v, vs) = (kv8_rows(g, device, dtype, b, cap, hd)
                                    for _ in range(2))
            else:
                kn, vn, k, v = (torch.randn(b, n, hd, generator=g).to(
                    device, dtype) for n in (t, t, cap, cap))
            runs = []
            for fn in (ring_insert_attention, ring_insert_attention_plain):
                c = [k.clone(), v.clone()] + ([ks.clone(), vs.clone()]
                                              if kvq else [])
                kw = (dict(k_scale=c[2], v_scale=c[3], ks_new=ksn,
                           vs_new=vsn) if kvq else {})
                runs.append((fn(q, kn, vn, c[0], c[1], off, st, hm, ctx,
                                **kw), c))
            sync(device)
            (got, c1), (want, c2) = runs
            if not all(torch.equal(x, y) for x, y in zip(c1, c2)):
                raise AssertionError(f"{name}: rings differ at {off}")
            worst[name] = max(worst.get(name, 0.0), (
                got.float() - want.float()).abs().max().item())
    tol = TOL[("attn", _dt_name(dtype))]
    for name, err in worst.items():
        log(f"  {name}, {b} lanes, {_dt_name(dtype)}: max_abs_err "
            f"{err:.3e} (tol {tol}; m absolute, l relative)")
        if not err <= tol:
            raise AssertionError(f"{name} {_dt_name(dtype)} error {err}")
        results.setdefault(name, {})[_dt_name(dtype)] = err


def time_mesh_kernels(device, dtype, heads=MESH_HEADS, b=MESH_RANK_LANES):
    """Device time of K1 over lanes with statistics, K7 int8 with
    statistics, K2 and K2-q at one rank's shapes (`heads`, b lanes) vs
    their plain versions, the library call (SDPA with the kernel's mask;
    none for int8 caches, for which SDPA over bf16 caches of the same
    shape is timed for comparison) and each call's bound: [(name, row)]."""
    import torch
    from pocket_tts_tpu_torch.ops.attention import ring_cache_bias
    from pocket_tts_tpu_torch.ops.decode_attn import (decode_attention,
                                                      decode_attention_plain)
    from pocket_tts_tpu_torch.ops.insert_attn import (
        decode_insert_attention, decode_insert_attention_plain)
    from pocket_tts_tpu_torch.ops.ring_attn import (
        ring_insert_attention, ring_insert_attention_plain)
    g = torch.Generator(device="cpu").manual_seed(37)
    dn = _dt_name(dtype)
    isz = torch.tensor([], dtype=dtype).element_size()
    hb, hm = heads
    rows = []
    # K1 over lanes with statistics, every slot read (ring mode), S = 1024
    q, k, v, _, _, pos, end = k1_lanes_case(g, device, dtype, False, 1024, b,
                                            h=hb)
    hd = hb * 64
    mask = (torch.arange(pos.shape[1], device=device) <= end) & (pos >= 0)
    nread = int(mask.sum())
    rows.append((f"K1 lanes + stats H={hb}", _row(
        device_ms(lambda: decode_attention(q, k, v, pos, end, stats=True),
                  200),
        device_ms(lambda: decode_attention_plain(q, k, v, pos, end,
                                                 stats=True), 20),
        device_ms(lambda: sdpa_call(q[:, :, None], _heads(k, hb),
                                    _heads(v, hb), mask[:, None, None, :]),
                  200)[0],
        # the live slots' K and V rows and all positions read, q in, the
        # output and the statistics out
        bound_ms(2 * nread * hd * isz + 4 * b * pos.shape[1]
                 + 2 * b * hd * isz + 2 * b * hb * 4, 4 * nread * hd, dn),
        f"B={b} S={pos.shape[1]} end={end} H={hb} D=64")))
    # K7 int8 with statistics, ring mode, S = 896
    (q, kn, vn, cur, k, v, pos, re_, ws, ks, vs, ksn,
     vsn) = k7_kv8_case(g, device, dtype, "ring", b, h=hb)
    mask = (torch.arange(pos.shape[1], device=device) <= re_) & (pos >= 0)
    nread = int(mask.sum())
    kw = dict(k_scale=ks, v_scale=vs, ks_new=ksn, vs_new=vsn, stats=True)
    kb = (k.float() * ks[..., None]).to(torch.bfloat16)
    vb = (v.float() * vs[..., None]).to(torch.bfloat16)
    row = _row(
        device_ms(lambda: decode_insert_attention(
            q, kn, vn, cur, k, v, pos, re_, ws, **kw), 200),
        device_ms(lambda: decode_insert_attention_plain(
            q, kn, vn, cur, k, v, pos, re_, ws, **kw), 20), None,
        bound_ms(2 * nread * (hd + 4) + 4 * b * (re_ + 1) + 2 * b * hd * isz
                 + 4 * b * (hd + 4) + 2 * b * hb * 4, 4 * nread * hd, dn),
        f"ring B={b} S={pos.shape[1]} H={hb} D=64")
    row["cmp"] = device_ms(lambda: sdpa_call(
        q.to(torch.bfloat16)[:, :, None], _heads(kb, hb), _heads(vb, hb),
        mask[:, None, None, :]), 200)[0]
    rows.append((f"K7 int8 + stats H={hb}", row))
    # K2 and K2-q over the lanes at a wrapped ring
    cap, t, ctx, hd = 256, 16, 250, hm * 64
    st = (torch.arange(b, dtype=torch.int32) * 64).to(device)
    bias = ring_cache_bias(t, cap, 4096, ctx, start=st[:, None, None],
                           device=device)[:, None]
    mask = bias == 0
    for kvq in (False, True):
        q = torch.randn(b, t, hd, generator=g).to(device, dtype)
        if kvq:
            (kn, ksn), (vn, vsn) = (kv8_rows(g, device, dtype, b, t, hd)
                                    for _ in range(2))
            (kc, ks), (vc, vs) = (kv8_rows(g, device, dtype, b, cap, hd)
                                  for _ in range(2))
            kw = dict(k_scale=ks, v_scale=vs, ks_new=ksn, vs_new=vsn)
            # int8 ring and new rows with their scales read, the new rows
            # and scales written, q in, the output out
            nb = b * (2 * (cap + t) * (hd + 4) + 2 * t * (hd + 4)
                      + 2 * t * hd * isz)
        else:
            kn, vn, kc, vc = (torch.randn(b, n, hd, generator=g).to(
                device, dtype) for n in (t, t, cap, cap))
            kw = {}
            nb = b * (2 * (cap + t) + 2 * t + 2 * t) * hd * isz
        lib = (None if kvq else device_ms(lambda: sdpa_call(
            _heads(q, hm), _heads(kc, hm), _heads(vc, hm), mask), 200)[0])
        row = _row(
            device_ms(lambda: ring_insert_attention(
                q, kn, vn, kc, vc, 4096, st, hm, ctx, **kw), 200),
            device_ms(lambda: ring_insert_attention_plain(
                q, kn, vn, kc, vc, 4096, st, hm, ctx, **kw), 20), lib,
            bound_ms(nb, 4 * b * t * (cap + t) * hd, dn),
            f"B={b} cap={cap} T={t} H={hm} D=64 offset=4096")
        if kvq:
            kb = (kc.float() * ks[..., None]).to(torch.bfloat16)
            vb = (vc.float() * vs[..., None]).to(torch.bfloat16)
            row["cmp"] = device_ms(lambda: sdpa_call(
                _heads(q.to(torch.bfloat16), hm), _heads(kb, hm),
                _heads(vb, hm), mask), 200)[0]
        rows.append((f"K2{'-q' if kvq else ''} lanes H={hm}", row))
    return rows


# phase 11f: the rows a rank's K4a / K4b calls take: 2 (the 4-lane
# server's backbone and flow net rows at data 2), 16 (32 lanes' at data 2,
# and one lane's mimi rows) and 256 (16 lanes' mimi rows; a prefill's)
MESH_K4_ROWS = (2, 16, 256)


def mesh_k4_cases(device, rng, model=MESH_SHAPE[1]):
    """[(kind, name, K, N, weight tree)] of phases 11f and 12a: each of
    `mesh_k4_shapes` at `model` quantized for int8, int4 and q4_0 from
    random weights (io/quant.py's rule: q4_0 keeps per-channel scales at K
    = 32), on the card."""
    from pocket_tts_tpu_torch.config import DEFAULT_CONFIG
    from pocket_tts_tpu_torch.io.quant import _quantize_weight
    out = []
    for kind, kw in QUANTIZE.items():
        for name, k, n in mesh_k4_shapes(DEFAULT_CONFIG, model):
            w = (rng.randn(k, n) * 0.05).astype(np.float32)
            lin = _quantize_weight(w, kw["bits"], kw.get("group", 0))
            out.append((kind, name, k, n,
                        {key: t.to(device) for key, t in lin.items()}))
    return out


def check_mesh_k4(device, results, model=MESH_SHAPE[1], rows=MESH_K4_ROWS):
    """Phases 11f and 12a: K4a (int8) and K4b (int4, q4_0) vs their plain
    versions at one rank's shapes (`mesh_k4_shapes` at `model`) over each
    of `rows` rows, f32 and bf16, inputs from RandomState(41); the route
    each call took logged. Returns the cases (for `time_mesh_k4`)."""
    import torch
    from pocket_tts_tpu_torch.ops.quant_matmul import int8_route
    from pocket_tts_tpu_torch.ops.fused_layer import rows_route
    rng = np.random.RandomState(41)
    cases = mesh_k4_cases(device, rng, model)
    for dtype in (torch.float32, torch.bfloat16):
        for kind in QUANTIZE:
            mm_name, mm, plain, key = quant_matmul_fns(kind)
            pairs, routes = [], set()
            for _, name, k, n, lin in (c for c in cases if c[0] == kind):
                for nrows in rows:
                    x = _rand(rng, device, dtype, nrows, k, scale=0.5)
                    pairs.append((mm(x, lin[key], lin["scale"]),
                                  plain(x, lin[key], lin["scale"])))
                    routes.add((nrows, int8_route(dtype, nrows)
                                if kind == "int8" else rows_route(dtype,
                                                                  nrows)))
            sync(device)
            _rel_check(mm_name, "quant", dtype, pairs, results,
                       f" [mesh rank, model {model}, {kind}]")
            log(f"    routes (rows, kernel): {sorted(routes)}")
    return cases


def time_mesh_k4(cases, device, rows=MESH_K4_ROWS):
    """Phases 11f and 12a: device time of each K4a / K4b case at each of
    `rows` rows, bf16, beside the plain version, the library call
    (`_weight_int8pack_mm` / `_weight_int4pack_mm`, where one takes the
    shape) and the bound; [(label, row)]."""
    import torch
    rng = np.random.RandomState(43)
    rows_out, int8_lib = [], [True]
    for kind, name, k, n, lin in cases:
        _, mm, plain, key = quant_matmul_fns(kind)
        for nrows in rows:
            x = _rand(rng, device, torch.bfloat16, nrows, k, scale=0.5)
            y = mm(x, lin[key], lin["scale"])
            lib = None
            if kind != "int8":
                lib = int4pack_ms(x, lin, y)
            elif int8_lib[0]:
                lib = int8pack_ms(x, lin[key], lin["scale"])
                int8_lib[0] = lib is not None
            rows_out.append((f"K4 mesh {kind} {name}", _row(
                device_ms(lambda: mm(x, lin[key], lin["scale"]), 50),
                device_ms(lambda: plain(x, lin[key], lin["scale"]), 10),
                lib, bound_ms(_nbytes(x, y) + _tree_bytes(lin),
                              2 * nrows * k * n),
                f"rows={nrows} K={k} N={n}")))
    return rows_out


def _mesh_engine(dtype, fuse_insert=None, kv8=True, quantize=None):
    """The engine of a phase-11 or phase-12 run, made once per process on
    this process's card: DEFAULT_CONFIG on random weights from seed 0;
    kv8: the int8 backbone KV cache and the int8 mimi ring; fuse_insert:
    the backbone's (None: the serving default, K7); quantize: the weights'
    (TTSEngine's option)."""
    import dataclasses
    import torch
    from pocket_tts_tpu_torch.config import DEFAULT_CONFIG
    key = (dtype, fuse_insert, kv8, quantize)
    if key not in _MESH:
        device = torch.device("cuda", torch.cuda.current_device())
        cfg = DEFAULT_CONFIG
        if kv8:
            cfg = dataclasses.replace(cfg, mimi=dataclasses.replace(
                cfg.mimi, transformer=dataclasses.replace(
                    cfg.mimi.transformer, quantize_kv=True)))
        cfg = dataclasses.replace(cfg, backbone=dataclasses.replace(
            cfg.backbone, fuse_insert=fuse_insert))
        if ("params", dtype) not in _MESH:
            from pocket_tts_tpu_torch.io.params import random_params
            _MESH["params", dtype] = random_params(
                cfg, seed=0, dtype=dtype, device=device)[0]
        _MESH[key] = make_engine(cfg, device, dtype, quantize,
                                 quantize_kv=kv8,
                                 params=_MESH["params", dtype])
    return _MESH[key]


def _lane_steps():
    if "steps" not in _MESH:
        _MESH["steps"] = counted_lane_steps()
    return _MESH["steps"]


def mesh_batched_run(mesh, texts, quantize=None):
    """Phases 11a and 11h: BatchedEngine over len(texts) streams, f32, at
    temp 0 to each sentence's frame budget, on `mesh` (None: one process),
    float weights or `quantize`'s: each stream's pcm, and the launches,
    batch frame steps and prefill calls of the run (counters set to 0
    just before it) with the K4 calls a step and a prefill
    (`mesh_k4_calls`, None with float weights); the run's wall seconds
    (host clock, synchronized), frames and the peak device memory."""
    import torch
    from pocket_tts_tpu_torch.io.params import random_voice_prompt
    from pocket_tts_tpu_torch.runtime.batched import BatchedEngine
    steps = _lane_steps()
    eng = _mesh_engine(torch.float32, kv8=False, quantize=quantize)
    torch.cuda.reset_peak_memory_stats()
    be = BatchedEngine(eng, mesh)
    prompts = [random_voice_prompt(eng.cfg, 40 + 16 * i, seed=10 + i)
               for i in range(len(texts))]
    voices = be.prime_voices(prompts)
    torch.cuda.synchronize()
    steps0, prefills0 = steps["steps"], steps["prefills"]
    reset_counters()
    t0 = time.perf_counter()
    pcm = be.synthesize_batch(texts, voices, temp=0.0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return dict(pcm=pcm, launches={k: v for k, v in read_counters().items()
                                   if v},
                steps=steps["steps"] - steps0,
                prefills=steps["prefills"] - prefills0,
                k4=None if quantize is None else mesh_k4_calls(eng.params),
                wall=wall, frames=sum(a.size for a in pcm)
                / eng.cfg.mimi.frame_size,
                peak=torch.cuda.max_memory_allocated())


def profile_chunks(srv, lanes, n_walls=4, n_prof=3):
    """Steady serving on `srv` (a drained server, its voice "v"): `lanes`
    long requests (SERVE_TEXTS[3], 175 frames), two chunks to admit them,
    n_walls chunks on the host clock (each synchronized), then n_prof
    under torch.profiler (`profiled_steps`). Returns the median wall (us),
    device busy and NCCL kernel time (us) a chunk, the other kernels'
    launches a chunk, and frames a chunk. An NCCL kernel's time includes
    its wait for the other ranks' kernels, and kernels of two streams
    may overlap: NCCL time can exceed the wall."""
    for _ in range(lanes):
        srv.submit(SERVE_TEXTS[3], "v", temp=0.0)
    srv.step()
    srv.step()
    walls = chunk_walls(srv, n_walls)
    ka, _ = profiled_steps(srv.step, n_prof)
    if any(r is None for r in srv._live):
        raise AssertionError("a lane finished inside the profiled window")
    kern = device_kernels(ka, n_prof)
    nccl = [r for r in kern if "nccl" in r[0].lower()]
    return dict(wall_us=float(np.median(walls)),
                busy_us=sum(r[1] for r in kern),
                nccl_us=sum(r[1] for r in nccl),
                launches=sum(r[2] for r in kern) - sum(r[2] for r in nccl),
                chunk_frames=srv.chunk_frames, lanes=lanes)


def mesh_serve_run(mesh, dtype_name, fuse_insert, voice, quantize=None,
                   lanes=4, texts=MESH_TEXTS, profile=False):
    """Phases 11b, 11c, 11e, 11g, 12c and 12d: a ContinuousBatchingServer
    with `lanes` lanes, the int8 KV cache, the int8 mimi ring and the
    shared prefix on `mesh` (None: one process), float weights or
    `quantize`'s (the serving mode: int4), the `texts` at temp 0, counters
    and collectives set to 0 just before the run and read just after, each
    chunk synchronized and timed on the host clock. Returns each
    request's pcm and admission chunk, the launches, batch frame steps,
    prefill calls, chunks, all-reduces, all-gathers, the K4 calls a step
    and a prefill (`mesh_k4_calls` of the engine's tree), the walls, the
    frames and the peak device memory; with profile, the steady figures of
    `profile_chunks` after the run."""
    import torch
    from pocket_tts_tpu_torch.parallel import sharding
    from pocket_tts_tpu_torch.runtime.server import ContinuousBatchingServer
    dtype = {"f32": torch.float32, "bf16": torch.bfloat16}[dtype_name]
    steps = _lane_steps()
    eng = _mesh_engine(dtype, fuse_insert, quantize=quantize)
    torch.cuda.reset_peak_memory_stats()
    srv = ContinuousBatchingServer(eng, lanes=lanes, share_prefix=True,
                                   mesh=mesh)
    srv.register_voices({"v": voice})
    reqs = [srv.submit(t, "v", temp=0.0) for t in texts]
    steps0, prefills0 = steps["steps"], steps["prefills"]
    torch.cuda.synchronize()
    reset_counters()
    sharding.collectives.update(all_reduce=0, all_gather=0)
    walls = []
    while srv._queue or any(r is not None for r in srv._live):
        if len(walls) == 10_000:
            raise AssertionError("the server did not drain its queue")
        t0 = time.perf_counter()
        srv.step()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    out = dict(pcm=[r.pcm for r in reqs], admit=[r.admit_step for r in reqs],
               launches=read_counters(), steps=steps["steps"] - steps0,
               prefills=steps["prefills"] - prefills0,
               reduces=sharding.collectives["all_reduce"],
               gathers=sharding.collectives["all_gather"], wall=sum(walls),
               walls=walls, chunks=srv.steps,
               frames=sum(r.pcm.size for r in reqs) / eng.cfg.mimi.frame_size,
               k4=None if quantize is None else mesh_k4_calls(eng.params))
    if profile:
        out["prof"] = profile_chunks(srv, lanes)
    out["peak"] = torch.cuda.max_memory_allocated()
    return out


def _mesh_rel(got, want, what):
    """max |got - want| / max |want| over the streams; shapes must match."""
    worst = 0.0
    for i, (a, w) in enumerate(zip(got, want)):
        if a.shape != w.shape or not np.isfinite(a).all():
            raise AssertionError(f"{what}: stream {i} has {a.shape} samples "
                                 f"(want {w.shape}), finite "
                                 f"{bool(np.isfinite(a).all())}")
        worst = max(worst, float(np.abs(a - w).max())
                    / max(float(np.abs(w).max()), 1e-30))
    return worst


def _mesh_same_bits(outs, what):
    """Every rank returned the same audio bit for bit (each
    gathers its "data" column's lanes, so this holds the ranks of each
    "model" group to one another)."""
    for r, o in enumerate(outs[1:], 1):
        for a, b in zip(o, outs[0]):
            if not np.array_equal(a, b):
                raise AssertionError(f"{what}: rank {r}'s pcm differs from "
                                     "rank 0's")


def mesh_expected(fuse_insert, n, prefills, chunks, k4=None, data=2,
                  model=2):
    """A rank's launches for n batch frame steps of a phase-11 or phase-12
    server on a data x model mesh: 6 K7 int8 with statistics (without the
    fused insert 6 K1 over lanes with statistics), 2 K2-q, one K3
    sequence a step; with quantized weights (k4: (counter, (calls a step,
    calls a prefill))) the K4 calls `mesh_k4_calls` derives from the
    tree, and no fused kernel; nothing else. And its all-reduces and
    all-gathers (DEFAULT_CONFIG's heads, 16 and 8, divide every "model"
    up to 8, so both transformers split)."""
    from pocket_tts_tpu_torch.config import DEFAULT_CONFIG
    nb = DEFAULT_CONFIG.backbone.num_layers
    nm = DEFAULT_CONFIG.mimi.transformer.num_layers
    want = {"ring_attn_kv8": nm * n, "seanet_frame": n}
    if fuse_insert is False:
        want.update(decode_attn_lanes=nb * n, decode_attn_stats=nb * n)
    else:
        want.update(decode_insert_attn_kv8=nb * n,
                    decode_insert_attn_stats=nb * n)
    # on a "model" group of 2 or more, every layer: one max (the new int8
    # rows' absmax) and, for out_proj and linear2, two sums (float
    # weights) or two gathers of the input (quantized weights, whole on
    # every rank); an admission prefill call runs the backbone's layers.
    # On a "data" group of 2 or more each chunk's host read gathers pcm,
    # valid and done.
    layers = (nb + nm) * n + nb * prefills if model > 1 else 0
    gathers = 3 * chunks if data > 1 else 0
    if k4 is None:
        return want, 3 * layers, gathers
    name, (step, prefill) = k4
    want[name] = step * n + prefill * prefills
    return want, layers, gathers + 2 * layers


def mesh_k4_shapes(cfg, model=MESH_SHAPE[1]):
    """[(name, K, N)] of the linears a rank of a mesh with "model" of
    `model` runs through K4a / K4b: the column shards of in_proj (its
    heads' q | k | v) and linear1 (N / model), the whole out_proj and
    linear2 on the gathered input, and the flow net's linears, whole and
    one call each (no K6 on a mesh); input_linear is K4 without a mesh
    too."""
    out = []
    for part, c in (("backbone", cfg.backbone),
                    ("mimi", cfg.mimi.transformer)):
        dm, hid = c.d_model, c.hidden_dim
        out += [(f"{part} in_proj/{model}", dm, 3 * dm // model),
                (f"{part} linear1/{model}", dm, hid // model),
                (f"{part} out_proj", dm, dm), (f"{part} linear2", hid, dm)]
    f = cfg.flow.dim
    return out + [("flow input_proj", cfg.latent_dim, f),
                  ("flow cond_embed", cfg.backbone.d_model, f),
                  ("flow adaln", f, 3 * f), ("flow mlp", f, f),
                  ("flow final adaln", f, 2 * f),
                  ("flow final linear", f, cfg.latent_dim)]


def mesh_k4_calls(params):
    """(per batch frame step, per backbone prefill call) the K4a / K4b
    calls of a rank on a mesh, derived from a quantized tree: on a mesh no
    fused kernel runs (K5a / K5b, K6), so every quantized linear (a dict
    holding "q" or "q4") that a step runs is one call, times the layers of
    a stacked (L, K, N) leaf. A step runs input_linear, the backbone's
    layers, out_eos, the flow net but its time_embed (folded into
    _time_cond at load) and the mimi transformer's layers; a prefill call
    the backbone's layers."""
    def count(tree):
        if isinstance(tree, dict):
            for key in ("q", "q4"):
                if key in tree:
                    return tree[key].shape[0] if tree[key].dim() == 3 else 1
            return sum(count(v) for k, v in tree.items()
                       if k != "time_embed")
        if isinstance(tree, (list, tuple)):
            return sum(count(v) for v in tree)
        return 0

    step = (count(params["input_linear"]) + count(params["layers"])
            + count(params["out_eos"]) + count(params["flow_net"])
            + count(params["mimi"]["decoder_transformer"]["layers"]))
    return step, count(params["layers"])


# phase 11's server runs: (dtype, backbone fuse_insert, weights) -> label
MESH_SERVE_RUNS = {("f32", None, None): "11b", ("bf16", None, None): "11c",
                   ("f32", False, None): "11e", ("bf16", None, "int4"): "11g"}
# the kernels a mesh never launches: the fused layer kernels (K5a / K5b,
# K5c, K8) and K6, counted by any of their counters
MESH_NEVER = ("fused_pre", "fused_post", "fused_flow", "megalayer",
              "bilayer", "rows_mma", "rows_skinny")


def _log_mesh_row(name, r):
    (ms, host), (plain_ms, _) = r["k"], r["plain"]
    lib = "none" if r["lib"] is None else f"{r['lib'] * 1e3:.2f} us"
    cmp = ("" if "cmp" not in r else f" (SDPA over bf16 caches of the "
           f"same shape, for comparison: {r['cmp'] * 1e3:.2f} us)")
    log(f"  {name} ({r['shape']}), bf16: kernel {ms * 1e3:.2f} us "
        f"device, {host * 1e3:.2f} us host; plain {plain_ms * 1e3:.2f} "
        f"us; library {lib}{cmp}; bound {r['bound'][0] * 1e3:.2f} us "
        f"({r['bound'][1]}): {r['bound'][0] / ms:.1%} of it")


def _check_mesh_launches(label, r, o, want):
    """A rank's launches equal `want` by name, every other counter 0."""
    for name in set(o["launches"]) | set(want):
        if o["launches"].get(name, 0) != want.get(name, 0):
            raise AssertionError(
                f"{label} rank {r} {name}: {o['launches'].get(name, 0)} "
                f"launches for {o['steps']} steps (want "
                f"{want.get(name, 0)})")


def _run_figures(o):
    """A run's figures on one line (reported, not checked): wall and
    frames/s, peak device memory; a server's collectives a step and, when
    profiled, its steady chunk wall, device busy share and NCCL time."""
    out = (f"wall {o['wall']:.3f} s, {o['frames'] / o['wall']:.1f} "
           f"frames/s, peak {o['peak'] / 2 ** 20:.0f} MiB")
    if "walls" in o:
        out += (f", wall a chunk median "
                f"{1e3 * float(np.median(o['walls'])):.2f} ms over "
                f"{len(o['walls'])} chunks; {o['reduces'] / o['steps']:.2f}"
                f" all-reduces, {o['gathers'] / o['steps']:.2f} all-gathers"
                " a step")
    p = o.get("prof")
    if p:
        busy = p["busy_us"] - p["nccl_us"]
        out += (f"; {p['lanes']} lanes busy: wall a chunk "
                f"{p['wall_us'] / 1e3:.2f} ms, device busy without NCCL "
                f"{busy / 1e3:.2f} ms ({busy / p['wall_us']:.1%}) in "
                f"{p['launches']:.0f} kernels; NCCL kernels "
                f"{p['nccl_us'] / p['chunk_frames']:.1f} us a step (waits "
                "for the other ranks included)")
    return out


def _log_run_figures(label, outs, ref):
    log(f"    {label}, one card: {_run_figures(ref)}")
    for r, o in enumerate(outs):
        log(f"    {label}, rank {r}: {_run_figures(o)}")


def check_serve_outs(label, outs, ref, fuse, quant, dtype_name, data, model,
                     min_late=2):
    """One sharded server run (every rank's mesh_serve_run) against its
    one-card reference: the ranks' audio equal bit for bit, within f32
    2e-3 / bf16 MESH_BF16_TOL of max |pcm|, the same admission chunks
    (at least min_late mid-decode), and each rank's launches,
    all-reduces and all-gathers as `mesh_expected` derives them."""
    _mesh_same_bits([o["pcm"] for o in outs], label)
    tol = 2e-3 if dtype_name == "f32" else MESH_BF16_TOL
    err = _mesh_rel(outs[0]["pcm"], ref["pcm"], label)
    late = [a for a in outs[0]["admit"] if a]
    diff = np.concatenate([np.abs(a - w).ravel() for a, w in
                           zip(outs[0]["pcm"], ref["pcm"])])
    log(f"  {label}: {len(ref['pcm'])} requests ({len(late)} admitted "
        f"mid-decode), max |sharded - unsharded| relative to max |pcm| "
        f"{err:.3e} (tol {tol:.3e}); samples that differ "
        f"{np.mean(diff > 0):.3%}; ranks equal bit for bit")
    if outs[0]["admit"] != ref["admit"] or len(late) < min_late:
        raise AssertionError(f"{label}: admissions {outs[0]['admit']} vs "
                             f"unsharded {ref['admit']}")
    if not err <= tol:
        raise AssertionError(f"{label}: sharded pcm differs: {err}")
    for r, o in enumerate(outs):
        n, pf = o["steps"], o["prefills"]
        k4 = None if quant is None else (quant_matmul_fns(quant)[0], o["k4"])
        want, reduces, gathers = mesh_expected(fuse, n, pf, o["chunks"], k4,
                                               data, model)
        got = {k: v for k, v in o["launches"].items() if v}
        log(f"    rank {r}: {n} batch frame steps, {pf} admission "
            f"prefills, {o['chunks']} chunks, launches {got} (want "
            f"{want}); {o['reduces']} all-reduces (want {reduces}), "
            f"{o['gathers']} all-gathers (want {gathers}); wall "
            f"{1e3 * o['wall'] / max(n, 1):.2f} ms a step (unsharded "
            f"{1e3 * ref['wall'] / max(ref['steps'], 1):.2f})")
        _check_mesh_launches(label, r, o, want)
        if (o["reduces"], o["gathers"]) != (reduces, gathers):
            raise AssertionError(
                f"{label} rank {r}: {o['reduces']} all-reduces, "
                f"{o['gathers']} all-gathers (want {reduces}, {gathers})")


def mesh_refs(voice, profile=False):
    """The unsharded references of phase 11's runs, on this process's
    card: 11a and 11h (BatchedEngine, f32, float and int8 weights) and
    each of MESH_SERVE_RUNS."""
    texts = list(MESH_TEXTS[:4])
    refs = {"a": mesh_batched_run(None, texts),
            "h": mesh_batched_run(None, texts, "int8")}
    refs.update({key: mesh_serve_run(None, *key[:2], voice, key[2],
                                     profile=profile)
                 for key in MESH_SERVE_RUNS})
    return refs


def check_mesh_runs(grp, voice, refs, tag="11", profile=False):
    """Phase 11's runs on the rank group `grp` (phase 11: gloo on one card;
    12b: NCCL, one rank a card), each against its reference in `refs`
    (mesh_refs): (a) BatchedEngine over 4 streams, f32; (b, c, e, g) the
    4-lane servers of MESH_SERVE_RUNS; (h) BatchedEngine, int8 weights.
    profile: log each run's figures (`_run_figures`) beside its
    reference's."""
    from pocket_tts_tpu_torch.config import DEFAULT_CONFIG

    def name(letter):
        return f"11{letter}" if tag == "11" else f"{tag} (11{letter})"

    texts = list(MESH_TEXTS[:4])
    outs = grp.run(mesh_batched_run, texts)
    _mesh_same_bits([o["pcm"] for o in outs], "BatchedEngine")
    err = _mesh_rel(outs[0]["pcm"], refs["a"]["pcm"], "BatchedEngine")
    tol = TOL[("e2e", "f32")]
    frames = [a.size // DEFAULT_CONFIG.mimi.frame_size
              for a in refs["a"]["pcm"]]
    log(f"  {name('a')} BatchedEngine on the mesh, 4 streams, f32, frames "
        f"{frames}: max |sharded - unsharded| relative to max |pcm| "
        f"{err:.3e} (tol {tol}); ranks equal bit for bit")
    if not err <= tol:
        raise AssertionError(f"{name('a')} sharded BatchedEngine differs: "
                             f"{err}")
    if profile:
        _log_run_figures(name("a"), outs, refs["a"])
    for key, letter in MESH_SERVE_RUNS.items():
        dtype_name, fuse, quant = key
        label = (f"{name(letter[-1])} server {dtype_name}"
                 + (f", {quant} weights" if quant else "")
                 + ", int8 KV + int8 ring + shared prefix"
                 + (", no fused insert" if fuse is False else ""))
        outs = grp.run(mesh_serve_run, dtype_name, fuse, voice, quant, 4,
                       MESH_TEXTS, profile)
        check_serve_outs(label, outs, refs[key], fuse, quant, dtype_name,
                         grp.data, grp.model)
        if profile:
            _log_run_figures(label, outs, refs[key])
    outs = grp.run(mesh_batched_run, texts, "int8")
    _mesh_same_bits([o["pcm"] for o in outs], name("h"))
    err = _mesh_rel(outs[0]["pcm"], refs["h"]["pcm"], name("h"))
    log(f"  {name('h')} BatchedEngine on the mesh, int8 weights, 4 "
        f"streams, f32: max |sharded - unsharded| relative to max |pcm| "
        f"{err:.3e} (tol {tol}); ranks equal bit for bit")
    if not err <= tol:
        raise AssertionError(f"{name('h')} sharded int8 BatchedEngine "
                             f"differs: {err}")
    for r, o in enumerate(outs):
        step, prefill = o["k4"]
        k4 = step * o["steps"] + prefill * o["prefills"]
        log(f"    rank {r}: {o['steps']} batch frame steps, "
            f"{o['prefills']} prefill calls, launches {o['launches']} "
            f"(int8_matmul want {k4})")
        never = {k: v for k, v in o["launches"].items()
                 if k.startswith(MESH_NEVER)}
        if o["launches"].get("int8_matmul", 0) != k4 or never:
            raise AssertionError(f"{name('h')} rank {r}: {o['launches']}, "
                                 f"int8_matmul want {k4}")
    if profile:
        _log_run_figures(name("h"), outs, refs["h"])


def run_mesh_phase(voice, device, errs):
    """Phase 11 (see the module docstring)."""
    import torch
    from pocket_tts_tpu_torch.parallel.dryrun import dryrun_multichip
    from pocket_tts_tpu_torch.parallel.launch import RankGroup
    t11 = time.perf_counter()
    for dtype in (torch.float32, torch.bfloat16):
        check_mesh_kernels(device, dtype, errs)
    for name, r in time_mesh_kernels(device, torch.bfloat16):
        _log_mesh_row(name, r)
    log("  11f K4a / K4b at one rank's shapes (model 2), rows "
        f"{MESH_K4_ROWS}:")
    k4_cases = check_mesh_k4(device, errs)
    for name, r in time_mesh_k4(k4_cases, device):
        _log_mesh_row(name, r)
    log(f"  11f: {time.perf_counter() - t11:.1f} s into phase 11")
    refs = mesh_refs(voice)
    t_ranks = time.perf_counter()
    # gloo, named here: NCCL refuses two ranks on one device
    with RankGroup(*MESH_SHAPE, backend="gloo", device="cuda", threads=2,
                   timeout=900) as grp:
        log(f"  {grp.world} ranks (data {MESH_SHAPE[0]} x model "
            f"{MESH_SHAPE[1]}, gloo) up in "
            f"{time.perf_counter() - t_ranks:.1f} s")
        check_mesh_runs(grp, voice, refs)
    log(f"  11i dryrun_multichip(4, 'cuda', backend='gloo'): "
        f"{dryrun_multichip(4, 'cuda', backend='gloo')}")
    log(f"  phase 11: {time.perf_counter() - t11:.1f} s")


def warm_collectives(mesh):
    """One all-reduce over the world, then over this rank's "data" and
    "model" groups, outside the counters: a group's NCCL communicator
    initializes at its first collective, which no timed run should pay.
    Returns this rank's card (index, name) and the reduced value (world
    ** 2)."""
    import torch
    import torch.distributed as dist
    t = torch.ones(1, device=mesh.device_type)
    dist.all_reduce(t)
    for dim in ("data", "model"):
        dist.all_reduce(t, group=mesh.get_group(dim))
    torch.cuda.synchronize()
    return (torch.cuda.current_device(), torch.cuda.get_device_name(),
            float(t[0]))


def time_collectives(mesh, lanes, iters=50):
    """Device time (us) of one collective of each kind a serving step
    issues, at the shapes of a `lanes`-lane server's rank on `mesh`,
    outside the counters: "model" sums of a layer's float32 rows
    (backbone: a row a lane; mimi: a frame's 16 rows a lane), the max of
    the new int8 rows' absmax, gathers of a quantized layer's bf16 input
    columns, and the chunk's pcm gathered over "data"; CUDA events around
    `iters` calls issued back to back by every rank after a barrier, so
    that little of it is a wait for a late rank. {name: us}."""
    import torch
    import torch.distributed as dist
    from pocket_tts_tpu_torch.config import DEFAULT_CONFIG as cfg
    from pocket_tts_tpu_torch.parallel.sharding import axis_size
    data, model = axis_size(mesh, "data"), axis_size(mesh, "model")
    own, tpf = lanes // data, cfg.mimi.upsample_stride
    bd, md = cfg.backbone.d_model, cfg.mimi.transformer.d_model
    cases = []
    if model > 1:
        g = mesh.get_group("model")
        cases += [
            (f"sum f32 ({own}, {bd})", dist.ReduceOp.SUM, (own, bd),
             torch.float32, g),
            (f"sum f32 ({own * tpf}, {md})", dist.ReduceOp.SUM,
             (own * tpf, md), torch.float32, g),
            (f"max f32 (2, {own})", dist.ReduceOp.MAX, (2, own),
             torch.float32, g),
            (f"gather bf16 ({own}, {bd // model})", None,
             (own, bd // model), torch.bfloat16, g),
            (f"gather bf16 ({own * tpf}, {md // model})", None,
             (own * tpf, md // model), torch.bfloat16, g)]
    if data > 1:
        cases.append((f"gather pcm f32 ({own}, {5 * cfg.mimi.frame_size})",
                      None, (own, 5 * cfg.mimi.frame_size), torch.float32,
                      mesh.get_group("data")))
    out = {}
    for name, op, shape, dtype, g in cases:
        t = torch.zeros(shape, dtype=dtype, device=mesh.device_type)
        parts = [torch.empty_like(t) for _ in range(dist.get_world_size(g))]

        def call():
            if op is None:
                dist.all_gather(parts, t, group=g)
            else:
                dist.all_reduce(t, op=op, group=g)

        for _ in range(5):
            call()
        torch.cuda.synchronize()
        dist.barrier()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(iters):
            call()
        b.record()
        torch.cuda.synchronize()
        out[name] = a.elapsed_time(b) * 1e3 / iters
    return out


def run_cards_phase(voice, device, errs, backend=None):
    """Phase 12 (see the module docstring): backend None is NCCL, one rank
    a card; "gloo" puts the four ranks on one card (a rehearsal)."""
    import torch
    from pocket_tts_tpu_torch.parallel.dryrun import dryrun_multichip
    from pocket_tts_tpu_torch.parallel.launch import RankGroup
    t12 = time.perf_counter()
    hb, hm = CARDS_HEADS
    log(f"  12a the kernels at one rank's shapes on a model-4 mesh ({hb} "
        f"backbone heads, {hm} mimi heads, {LANES} lanes; K3 over "
        f"{CARDS_K3_LANES} lanes; K4a / K4b at rows {CARDS_K4_ROWS}):")
    for dtype in (torch.float32, torch.bfloat16):
        check_mesh_kernels(device, dtype, errs, CARDS_HEADS, LANES)
        eng = _mesh_engine(dtype, kv8=False)
        check_k3_lanes(eng.params["mimi"]["decoder"], eng.cfg, device, dtype,
                       errs, eng.seanet_weights, CARDS_K3_LANES)
    rows = time_mesh_kernels(device, torch.bfloat16, CARDS_HEADS, LANES)
    k4_cases = check_mesh_k4(device, errs, CARDS, CARDS_K4_ROWS)
    for name, r in rows + time_mesh_k4(k4_cases, device, CARDS_K4_ROWS):
        _log_mesh_row(name, r)
    log(f"  12a: {time.perf_counter() - t12:.1f} s into phase 12")
    refs = mesh_refs(voice, profile=True)
    serve_refs = {}
    for _, dtype_name, quant, lanes, texts, _ in CARDS_SERVE_RUNS:
        if (dtype_name, quant, lanes) not in serve_refs:
            serve_refs[dtype_name, quant, lanes] = mesh_serve_run(
                None, dtype_name, None, voice, quant, lanes, texts, True)
    log(f"  the unsharded references on card 0: "
        f"{time.perf_counter() - t12:.1f} s into phase 12")
    for shape in ((2, 2), (1, 1), (1, 4), (4, 1)):
        t0 = time.perf_counter()
        with RankGroup(*shape, backend=backend, device="cuda", threads=2,
                       timeout=900) as grp:
            cards = grp.run(warm_collectives)
            log(f"  {grp.world} ranks (data {shape[0]} x model {shape[1]}, "
                f"{grp.backend}) up and warm in "
                f"{time.perf_counter() - t0:.1f} s; rank -> card "
                f"{[c[:2] for c in cards]}")
            if any(c[2] != grp.world ** 2 for c in cards) or (
                    grp.backend == "nccl"
                    and [c[0] for c in cards] != list(range(grp.world))):
                raise AssertionError(f"warm-up collectives: {cards}")
            for lanes in sorted({r[3] for r in CARDS_SERVE_RUNS
                                 if r[0] == shape} | {LANES}):
                rows = grp.run(time_collectives, lanes)
                for r, row in enumerate(rows if rows[0] else []):
                    log(f"    collectives at a {lanes}-lane server's rank "
                        f"shapes, rank {r} (us each, CUDA events): "
                        + ", ".join(f"{k} {v:.1f}" for k, v in row.items()))
            if shape == (2, 2):
                check_mesh_runs(grp, voice, refs, "12b", profile=True)
            for run in CARDS_SERVE_RUNS:
                mesh_shape, dtype_name, quant, lanes, texts, label = run
                if mesh_shape != shape:
                    continue
                ref = serve_refs[dtype_name, quant, lanes]
                outs = grp.run(mesh_serve_run, dtype_name, None, voice,
                               quant, lanes, texts, True)
                check_serve_outs(label, outs, ref, None, quant, dtype_name,
                                 *shape, min(2, len(texts) - lanes))
                _log_run_figures(label, outs, ref)
        log(f"  data {shape[0]} x model {shape[1]}: "
            f"{time.perf_counter() - t0:.1f} s")
    log(f"  12e dryrun_multichip(4, 'cuda'): "
        f"{dryrun_multichip(4, 'cuda', backend)}")
    log(f"  phase 12: {time.perf_counter() - t12:.1f} s")


# ---------------------------------------------------------------------------
# [13] the lane frame from CUDA graphs (models/frame_graph.py)
# ---------------------------------------------------------------------------

FG_LANES = 256
FG_CHUNKS = 10     # 50 frames: the 48-slot backbone ring wraps at 48
FG_RING = 48       # ring slots (one-word turns need 45)
FG_TEXT = "Hello."  # one word: 37 frames


def frame_graph_engine(kind, device):
    """The benchmark's two configurations at full width on random weights:
    "int4kv8" (int4 weights, int8 KV and Mimi ring, shared prefix) or
    "bf16" (bf16 weights and KV)."""
    import dataclasses
    import torch
    from pocket_tts_tpu_torch.config import DEFAULT_CONFIG
    if kind == "bf16":
        return make_engine(DEFAULT_CONFIG, device, torch.bfloat16)
    cfg = dataclasses.replace(DEFAULT_CONFIG, mimi=dataclasses.replace(
        DEFAULT_CONFIG.mimi, transformer=dataclasses.replace(
            DEFAULT_CONFIG.mimi.transformer, quantize_kv=True)))
    return make_engine(cfg, device, torch.bfloat16, quantize="int4",
                       quantize_kv=True)


def frame_graph_serve(engine, voice, share_prefix, graphs,
                      lanes=FG_LANES, chunks=FG_CHUNKS):
    """Serve one-word turns through `lanes` lanes for `chunks` chunks of 5
    frames, the backbone ring cut to FG_RING slots (it wraps) and the Mimi
    ring wrapping every 16 frames: half the lanes admitted at the first
    chunk, the rest at the second, then a queue of as many more, which
    joins as lanes finish. graphs False runs the frame eagerly (the
    graph path switched off). Returns a dict: "latents" (frames, B,
    latent), "pcm" (each request's, in submission order), "modes" (the
    ptt.frame spans' `graph`), "host_s" (host seconds of each frame's
    call, unsynchronized), "walls" (synchronized seconds of each chunk),
    "k7" / "k2" (launches of each a frame), "segments"."""
    import torch
    from pocket_tts_tpu_torch.models import frame_graph, tts
    from pocket_tts_tpu_torch.ops import insert_attn, ring_attn
    from pocket_tts_tpu_torch.runtime.server import ContinuousBatchingServer
    from pocket_tts_tpu_torch.utils import profiling
    prefix = 64 if share_prefix else 128 + 64
    srv = ContinuousBatchingServer(engine, lanes=lanes, text_bucket=64,
                                   capacity=prefix + FG_RING,
                                   share_prefix=share_prefix)
    srv.register_voices({"v": voice})
    assert srv.capacity - srv.prefix_slots == FG_RING
    real, graphable = tts.frame_step_lanes, frame_graph.graphable
    latents, host_s = [], []

    def frame(p, cfg, state, *a, **k):
        t0 = time.perf_counter()
        out = real(p, cfg, state, *a, **k)
        host_s.append(time.perf_counter() - t0)
        latents.append(state.prev_latent.clone())
        return out

    def counts():
        return (insert_attn.decode_insert_attention.launches
                + insert_attn.decode_insert_attention.launches_kv8,
                ring_attn.ring_insert_attention.launches
                + ring_attn.ring_insert_attention.launches_kv8)

    tts.frame_step_lanes = frame
    if not graphs:
        frame_graph.graphable = lambda cfg, state: False
    reqs, walls = [], []
    try:
        k0 = counts()
        with profiling.recording():
            t_rec = time.perf_counter()
            for c in range(chunks):
                if c < 2:
                    reqs += [srv.submit(FG_TEXT, "v", temp=0.6,
                                        seed=1000 + len(reqs))
                             for _ in range(lanes // 2)]
                if c == 2:
                    reqs += [srv.submit(FG_TEXT, "v", temp=0.6,
                                        seed=1000 + len(reqs))
                             for _ in range(lanes)]
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                srv.step()
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
        k1 = counts()
        modes = [s.attrs.get("graph") for s in profiling.recorded_spans()
                 if s.name == "ptt.frame" and s.start_ns * 1e-9 > t_rec]
    finally:
        tts.frame_step_lanes = real
        frame_graph.graphable = graphable
    n = len(latents)
    assert n == 5 * chunks, n
    done = [r for r in reqs if r.pcm is not None]
    return dict(latents=torch.stack(latents), modes=modes, host_s=host_s,
                walls=walls, pcm=[r.pcm for r in done], done=len(done),
                k7=(k1[0] - k0[0]) / n, k2=(k1[1] - k0[1]) / n,
                segments=frame_graph.run_frame.segments if graphs else 0,
                offset=srv.batch.mimi.transformer.offset)


def check_frame_graphs(device, voice):
    """[13]: at 256 lanes on both configurations, the frames from CUDA
    graphs against the same frames run eagerly: latents and PCM equal bit
    for bit, the ptt.frame spans "capture" then "replay", K7 and K2 one
    launch a call (6 and 2 a frame) on both paths. Logs the host ms of a
    frame's call and the ms of a synchronized chunk on both paths, and the
    graph segments a frame. Returns {kind: row}."""
    import numpy as np
    import torch
    rows = {}
    for kind in ("int4kv8", "bf16"):
        eng = frame_graph_engine(kind, device)
        share = kind == "int4kv8"
        eager = frame_graph_serve(eng, voice, share, graphs=False)
        graphed = frame_graph_serve(eng, voice, share, graphs=True)
        lat_diff = float((graphed["latents"].float()
                          - eager["latents"].float()).abs().max())
        pcm_same = (len(eager["pcm"]) == len(graphed["pcm"]) and all(
            np.array_equal(a, b) for a, b in zip(eager["pcm"],
                                                 graphed["pcm"])))
        # steady chunks: after the two admissions and the capture
        row = dict(
            host_ms_frame_eager=1e3 * float(np.median(eager["host_s"][10:])),
            host_ms_frame_graphs=1e3 * float(np.median(
                graphed["host_s"][10:])),
            capture_ms=1e3 * graphed["host_s"][0],
            chunk_ms_eager=1e3 * float(np.median(eager["walls"][3:])),
            chunk_ms_graphs=1e3 * float(np.median(graphed["walls"][3:])),
            segments=graphed["segments"], k7=graphed["k7"],
            k2=graphed["k2"], latents_equal=lat_diff == 0.0,
            latent_max_diff=lat_diff, pcm_equal=pcm_same,
            requests_done=graphed["done"])
        rows[kind] = row
        log(f"  {kind}, {FG_LANES} lanes: " + ", ".join(
            f"{k} {v:.3f}" if isinstance(v, float) else f"{k} {v}"
            for k, v in row.items()))
        if not (5 * FG_CHUNKS > FG_RING and graphed["offset"] > 256):
            raise AssertionError(f"{kind}: the rings did not wrap")
        if set(eager["modes"]) != {"eager"} or graphed["modes"] != (
                ["capture"] + ["replay"] * (len(graphed["modes"]) - 1)):
            raise AssertionError(f"{kind}: frame spans {graphed['modes']}")
        if (eager["k7"], eager["k2"], graphed["k7"], graphed["k2"]) != (
                6, 2, 6, 2):
            raise AssertionError(f"{kind}: K7 / K2 launches a frame "
                                 f"{eager['k7']} / {eager['k2']} eager, "
                                 f"{graphed['k7']} / {graphed['k2']} graphs")
        if not (row["latents_equal"] and pcm_same and graphed["done"] > 0):
            raise AssertionError(f"{kind}: graphed frames differ from the "
                                 f"eager ones ({row})")
        del eng
        torch.cuda.empty_cache()
    return rows


# --------------------------------------------------------------- phase 14 --

MOSHI_LANES = 32
# the bound of a call: its bytes at the card's bandwidth or its operations
# at its bf16 peak, whichever takes longer (PERF.md, section 6)
HBM_BYTES_S, BF16_FLOPS_S = 3.35e12, 989e12


def _bound_us(flops, nbytes):
    return 1e6 * max(flops / BF16_FLOPS_S, nbytes / HBM_BYTES_S)


def k7_moshi_case(device, dtype, d=128, h=32, s=3072, context=3000, ws=1000,
                  b=MOSHI_LANES, seed=71):
    """K7's inputs at Moshi's shapes (or Pocket TTS's with d=64, h=16,
    s=1024): a ring of s slots whose write slot is ws, lane i holding the
    last L_i positions before its new row, those more than `context` back
    left out (-1), lanes from 1 slot to past the window; lane 1 an idle
    lane (cur_pos -1). Returns (q, k_new, v_new, cur_pos, k_cache,
    v_cache, pos, read_end, write_slot)."""
    import torch
    g = torch.Generator(device=device).manual_seed(seed)
    hd = h * d
    kc = torch.randn(b, s, hd, generator=g, device=device).to(dtype)
    vc = torch.randn(b, s, hd, generator=g, device=device).to(dtype)
    q = torch.randn(b, h, d, generator=g, device=device).to(dtype)
    kn = torch.randn(b, 1, hd, generator=g, device=device).to(dtype)
    vn = torch.randn(b, 1, hd, generator=g, device=device).to(dtype)
    pos = torch.full((b, s), -1, dtype=torch.int32)
    cur = torch.zeros(b, dtype=torch.int32)
    for i in range(b):
        fill = 1 + (i * 331) % (s + 100)
        cur[i] = fill
        for j in range(1, min(fill + 1, s)):
            if j < context:
                pos[i, (ws - j) % s] = fill - j
    cur[1] = -1
    pos[:, ws] = cur
    return (q, kn, vn, cur.to(device), kc, vc, pos.to(device), s - 1, ws)


def _k7_cost(q, kc, pos):
    b, h, d = q.shape
    valid = int((pos >= 0).sum())
    row = kc.shape[-1] * kc.element_size()
    nbytes = 2 * valid * row + pos.numel() * 4 + 4 * q.numel() * \
        q.element_size()
    return 4.0 * valid * h * d, nbytes


def check_k7_moshi(device, d=128):
    """K7 at D = 128 (Moshi: 32 heads, a 3,072-slot ring, a 3,000-slot
    window, 32 lanes) or at D = 64 (Pocket TTS: 16 heads, 1,024 slots),
    bf16, against its plain version: the output, and the caches after the
    insert. Returns the row (us, bound_us, plain_us, err)."""
    import torch
    from pocket_tts_tpu_torch.ops.insert_attn import (
        decode_insert_attention, decode_insert_attention_plain)
    dt = torch.bfloat16
    case = (k7_moshi_case(device, dt) if d == 128 else
            k7_moshi_case(device, dt, d=64, h=16, s=1024, context=1024,
                          ws=300))
    q, kn, vn, cur, kc, vc, pos, re_, ws = case
    kc2, vc2 = kc.clone(), vc.clone()
    got = decode_insert_attention(q, kn, vn, cur, kc, vc, pos, re_, ws)
    want = decode_insert_attention_plain(q, kn, vn, cur, kc2, vc2, pos, re_,
                                         ws)
    err = float((got.float() - want.float()).abs().max())
    if not (torch.equal(kc, kc2) and torch.equal(vc, vc2)):
        raise AssertionError(f"K7 D={d}: the caches differ from the plain "
                             "insert")
    # two bf16 ulps of an output below 4 in magnitude
    if err > 3.2e-2 or not torch.isfinite(got).all():
        raise AssertionError(f"K7 D={d}: max abs err {err}")
    us = 1e3 * device_ms(lambda: decode_insert_attention(
        q, kn, vn, cur, kc, vc, pos, re_, ws), 100)[0]
    plain_us = 1e3 * device_ms(lambda: decode_insert_attention_plain(
        q, kn, vn, cur, kc2, vc2, pos, re_, ws), 5)[0]
    return dict(us=us, bound_us=_bound_us(*_k7_cost(q, kc, pos)),
                plain_us=plain_us, err=err)


def check_k2_moshi(device, t=2, layers=8):
    """K2 at t new rows a frame over `layers` layers' rings (Moshi's Mimi:
    2 rows, 8 layers; Pocket TTS's: 16 rows), 8 heads of 64, 256 slots,
    a 250-step window, 32 lanes with their own starts, bf16, the ring
    wrapped: each layer's output against the plain version, and the
    rings after the insert equal to the plain insert's (the kernel's
    padding rows of the MMA never write). Returns the row."""
    import torch
    from pocket_tts_tpu_torch.ops.ring_attn import (
        ring_insert_attention, ring_insert_attention_plain)
    dt = torch.bfloat16
    g = torch.Generator(device=device).manual_seed(72 + t)
    b, cap, h, d, ctx, off = MOSHI_LANES, 256, 8, 64, 250, 608
    hd = h * d
    start = torch.tensor([max(0, off - (i * 37) % 420) // t * t
                          for i in range(b)], dtype=torch.int32,
                         device=device)
    calls, err = [], 0.0
    for _ in range(layers):
        q, kn, vn = (torch.randn(b, t, hd, generator=g, device=device)
                     .to(dt) for _ in range(3))
        kc, vc = (torch.randn(b, cap, hd, generator=g, device=device)
                  .to(dt) for _ in range(2))
        kc2, vc2 = kc.clone(), vc.clone()
        got = ring_insert_attention(q, kn, vn, kc, vc, off, start, h, ctx)
        want = ring_insert_attention_plain(q, kn, vn, kc2, vc2, off, start,
                                           h, ctx)
        err = max(err, float((got.float() - want.float()).abs().max()))
        if not (torch.equal(kc, kc2) and torch.equal(vc, vc2)):
            raise AssertionError(f"K2 T={t}: the rings differ from the "
                                 "plain insert")
        calls.append((q, kn, vn, kc, vc, kc2, vc2))
    if err > 3.2e-2:
        raise AssertionError(f"K2 T={t}: max abs err {err}")
    q, kn, vn, kc, vc, kc2, vc2 = calls[0]
    us = 1e3 * device_ms(lambda: ring_insert_attention(
        q, kn, vn, kc, vc, off, start, h, ctx), 200)[0]
    plain_us = 1e3 * device_ms(lambda: ring_insert_attention_plain(
        q, kn, vn, kc2, vc2, off, start, h, ctx), 10)[0]
    # keys a query sees: its window, fenced by the lane's start
    seen = sum(min(ctx, off + i - int(s0) + 1) for s0 in start.tolist()
               for i in range(t))
    rows = sum(min(cap, off + t - int(s0)) for s0 in start.tolist())
    nbytes = 2 * rows * hd * 2 + 4 * b * t * hd * 2
    return dict(us=us, bound_us=_bound_us(4.0 * seen * h * d, nbytes),
                plain_us=plain_us, err=err)


def check_k3_moshi(device, moshi_shape=True, frames=3):
    """K3 over 32 lanes at Moshi's SEANet (2 rows a frame, a first conv
    512 -> 1024 whose 6-row carry moves up by 2 rows a frame, four stages
    8, 6, 5, 4) or Pocket TTS's (16 rows, three stages), bf16, against the
    plain chain over `frames` frames (the carries across them). Returns
    the row."""
    import dataclasses
    import torch
    from pocket_tts_tpu_torch.config import DEFAULT_CONFIG, MoshiConfig
    from pocket_tts_tpu_torch.io import moshi_params
    from ptts_bench.moshi import weights as moshi_weights
    from pocket_tts_tpu_torch.io.params import random_params
    from pocket_tts_tpu_torch.models import mimi, seanet
    from pocket_tts_tpu_torch.ops.seanet_frame import (frame_shapes,
                                                       prep_weights,
                                                       seanet_frame)
    dt = torch.bfloat16
    if moshi_shape:
        cfg = MoshiConfig()
        dec = moshi_params.mimi_from_flat(moshi_weights.draw(
            dataclasses.asdict(cfg), 73, device, dt, prefix="mimi."), cfg,
            dt, device)["decoder"]
        mcfg = cfg.mimi
    else:
        p, pcfg = random_params(DEFAULT_CONFIG, seed=0, dtype=dt,
                                device=device)
        dec, mcfg = p["mimi"]["decoder"], pcfg.mimi
    sc, tpf = mcfg.seanet, mcfg.upsample_stride
    w = prep_weights(dec, sc)
    st = mimi.init_state_lanes(mcfg, MOSHI_LANES, dt, device).seanet
    st2 = {k: v.clone() for k, v in st.items()}
    g = torch.Generator(device=device).manual_seed(74)
    err = 0.0
    for _ in range(frames):
        z = torch.randn(MOSHI_LANES, tpf, sc.in_ch, generator=g,
                        device=device).to(dt)
        got = seanet_frame(dec, sc, st, z, w)
        new, want = seanet.forward_plain(dec, sc, st2, z)
        for k in st2:
            st2[k].copy_(new[k])
        err = max(err, float((got.float() - want.float()).abs().max()))
        for k in st:
            cerr = float((st[k].float() - st2[k].float()).abs().max())
            if cerr > 0.1:
                raise AssertionError(f"K3: carry {k} off by {cerr}")
    if err > 5e-2 or not torch.isfinite(got).all():
        raise AssertionError(f"K3 ({len(sc.stages)} stages): max abs err "
                             f"{err}")
    us = 1e3 * device_ms(lambda: seanet_frame(dec, sc, st, z, w), 30)[0]
    plain_us = 1e3 * device_ms(lambda: seanet.forward_plain(dec, sc, st2,
                                                            z), 5)[0]
    flops = sum(2.0 * m * n * k for _, kind, m, n, k in frame_shapes(
        sc, MOSHI_LANES, tpf) if kind != "overlap")
    nbytes = (sum(v.numel() * v.element_size() for pair in w.values()
                  for v in pair if v is not None)
              + z.numel() * 2 + 2 * sum(v.numel() * 2 for v in st.values())
              + got.numel() * 2)
    return dict(us=us, bound_us=_bound_us(flops, nbytes), plain_us=plain_us,
                err=err)


def check_moshi_frames(device, frames=12, capacity=256):
    """Moshi's lane frame at full width, bf16, 32 lanes (a 256-slot ring
    here, so that two batches fit): the frames replayed from CUDA graphs
    against the same frames run eagerly, bit for bit (PCM, text and audio
    logits), through an admission mid-run; the `ptt.frame` spans
    "capture" then "replay"; 32 K7, 8 K2 and 1 K3 a frame; the spans
    ptt.temporal, ptt.depth and ptt.mimi inside every frame. Returns the
    row (host and device ms a frame both ways)."""
    import dataclasses
    import torch
    from pocket_tts_tpu_torch.config import MoshiConfig
    from pocket_tts_tpu_torch.io import moshi_params
    from pocket_tts_tpu_torch.models import moshi
    from pocket_tts_tpu_torch.ops.insert_attn import decode_insert_attention
    from ptts_bench.moshi import weights as moshi_weights
    from pocket_tts_tpu_torch.ops.ring_attn import ring_insert_attention
    from pocket_tts_tpu_torch.ops.seanet_frame import (prep_weights,
                                                       seanet_frame)
    from pocket_tts_tpu_torch.utils import profiling
    cfg = dataclasses.replace(MoshiConfig(), kv_capacity=capacity,
                              context=capacity - 8)
    dt = torch.bfloat16
    p = moshi_params.params_from_flat(moshi_weights.draw(
        dataclasses.asdict(cfg), 75, device, dt), cfg, dt, device)
    w = prep_weights(p["mimi"]["decoder"], cfg.mimi.seanet)
    b = MOSHI_LANES
    g = torch.Generator(device=device).manual_seed(76)
    noise = torch.rand(b, capacity, 1 + cfg.n_q, generator=g, device=device)
    user = torch.randint(0, cfg.card, (b, capacity, cfg.n_q), generator=g,
                         device=device)
    out = {}
    for mode in ("eager", "graphs"):
        st = moshi.empty_lanes(cfg, b, dt, device)
        moshi.admit(cfg, st, range(0, b, 2), [frames - 2] * (b // 2))
        step = (moshi.frame_step_lanes if mode == "graphs"
                else moshi.frame_step_lanes_eager)
        rec = dict(pcm=[], text=[], audio=[], modes=[], host=[], k7=[],
                   k2=[], k3=[], spans=0)
        for i in range(frames):
            if i == 3:
                moshi.admit(cfg, st, range(1, b, 2), [frames] * (b // 2))
            n7, n2, n3 = (decode_insert_attention.launches,
                          ring_insert_attention.launches,
                          seanet_frame.launches)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with profiling.recording():
                pcm, valid = step(p, cfg, st, noise, user, w)
            torch.cuda.synchronize()
            rec["host"].append(time.perf_counter() - t0)
            rec["k7"].append(decode_insert_attention.launches - n7)
            rec["k2"].append(ring_insert_attention.launches - n2)
            rec["k3"].append(seanet_frame.launches - n3)
            rec["modes"].append(moshi.frame_mode(st) if mode == "graphs"
                                else "eager")
            rec["pcm"].append((pcm * valid[:, None]).cpu())
            rec["text"].append(st.text_logits.float().cpu())
            rec["audio"].append(st.audio_logits.float().cpu())
        names = [sp.name for sp in profiling.recorded_spans()[-40:]]
        rec["spans"] = sum(names.count(n) for n in (
            "ptt.temporal", "ptt.depth", "ptt.mimi"))
        out[mode] = rec
        del st
        torch.cuda.empty_cache()
    e, gr = out["eager"], out["graphs"]
    same = all(torch.equal(a, c) for key in ("pcm", "text", "audio")
               for a, c in zip(e[key], gr[key]))
    row = dict(
        frames_equal=same,
        host_ms_frame_eager=1e3 * float(np.median(e["host"][4:])),
        host_ms_frame_graphs=1e3 * float(np.median(gr["host"][4:])),
        capture_ms=1e3 * gr["host"][0], modes=gr["modes"][:3],
        launches=(gr["k7"][-1], gr["k2"][-1], gr["k3"][-1]),
        eager_launches=(e["k7"][-1], e["k2"][-1], e["k3"][-1]),
        spans_last_frames=gr["spans"])
    log("  moshi frame, 32 lanes: " + ", ".join(f"{k} {v}" for k, v in
                                               row.items()))
    want = (cfg.num_layers, cfg.mimi.transformer.num_layers, 1)
    if gr["modes"] != ["capture"] + ["replay"] * (frames - 1):
        raise AssertionError(f"moshi frame modes {gr['modes']}")
    if row["launches"] != want or row["eager_launches"] != want:
        raise AssertionError(f"moshi K7 / K2 / K3 launches a frame "
                             f"{row['launches']}, eager "
                             f"{row['eager_launches']}, want {want}")
    if not same:
        raise AssertionError("moshi: graphed frames differ from the eager "
                             "ones")
    if not gr["spans"]:
        raise AssertionError("moshi: no ptt.temporal / depth / mimi spans "
                             "in the replayed frames")
    return row


def check_moshi(device):
    """[14]: the kernels Moshi forces (K7 at D = 128, K2 at 2 rows, K3 at
    four stages), each against its plain version and timed beside Pocket
    TTS's instantiations of the same kernels (K7 at D = 64, K2 at 16 rows,
    K3 at three stages), then Moshi's lane frame from graphs against the
    eager frame. Returns {label: row}."""
    import torch
    rows = {}
    for label, fn in (
            ("K7 bf16 D=128 H=32 B=32 S=3072 window 3000",
             lambda: check_k7_moshi(device, 128)),
            ("K7 bf16 D=64 H=16 B=32 S=1024 ring",
             lambda: check_k7_moshi(device, 64)),
            ("K2 bf16 T=2 B=32 cap 256 (8 layers)",
             lambda: check_k2_moshi(device, 2)),
            ("K2 bf16 T=16 B=32 cap 256",
             lambda: check_k2_moshi(device, 16, layers=2)),
            ("K3 bf16 four stages B=32 T=2",
             lambda: check_k3_moshi(device, True)),
            ("K3 bf16 three stages B=32 T=16",
             lambda: check_k3_moshi(device, False))):
        rows[label] = fn()
        log(f"  {label}: " + ", ".join(f"{k} {v:.4g}" for k, v in
                                       rows[label].items()))
        torch.cuda.empty_cache()
    rows["moshi frame"] = check_moshi_frames(device)
    return rows


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description="PyTorch port smoke test on "
                                 "one CUDA GPU (or four, --cards 4)")
    ap.add_argument("--out", default=None,
                    help="directory for the nvcc report and profiler table")
    ap.add_argument("--kernel-times", action="store_true",
                    help="only time K3, K4b, K5a-K5c, K6, K7 and K8 through "
                    "their public wrappers (kernel_times) and print them as "
                    "one JSON line")
    ap.add_argument("--frame-graphs", action="store_true",
                    help="only [1] environment, [2] build and [13] the lane "
                    "frame from CUDA graphs against the eager frame")
    ap.add_argument("--moshi", action="store_true",
                    help="only [1] environment, [2] build and [14] Moshi's "
                    "kernels (K7 at D = 128, K2 at 2 rows, K3 at four "
                    "stages) and its lane frame from CUDA graphs")
    ap.add_argument("--cards", type=int, choices=(1, CARDS), default=1,
                    help=f"{CARDS}: only [1] environment, [2] build and [12] "
                    "the mesh over NCCL, one rank a card (2 x 2, 1 x 4 and "
                    "4 x 1); needs that many cards")
    args = ap.parse_args(argv)
    out_dir = args.out
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
    if args.kernel_times:
        from pocket_tts_tpu_torch.ops import cuda_lib
        cuda_lib.library()
        print(json.dumps({"kernel_times_us": kernel_times(
            torch.device("cuda:0")), "card": nvidia_smi(), "root": root}))
        return 0
    from pocket_tts_tpu_torch.config import DEFAULT_CONFIG
    from pocket_tts_tpu_torch.io.params import random_voice_prompt
    from pocket_tts_tpu_torch.ops import cuda_lib

    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        _LOG.append(open(os.path.join(out_dir, "chip_smoke.log"), "w"))
    device = torch.device("cuda:0")
    card = nvidia_smi()
    kind = torch.cuda.get_device_name(0)
    phase = "environment"
    try:
        header("[1] environment")
        log(f"  python {sys.version.split()[0]}, torch {torch.__version__}, "
            f"CUDA {torch.version.cuda}, device {kind}, "
            f"count {torch.cuda.device_count()}")
        log(f"  nvidia-smi: {card}")
        log(f"  matmul allow_tf32={torch.backends.cuda.matmul.allow_tf32}")
        if torch.cuda.device_count() < args.cards:
            raise AssertionError(f"--cards {args.cards} needs {args.cards} "
                                 f"cards; this machine has "
                                 f"{torch.cuda.device_count()}")

        phase = "build"
        header("[2] build")
        cuda_lib.library()
        log(f"  kernel library {cuda_lib._state['path']}: "
            f"{cuda_lib.build_seconds():.1f} s to build and load")
        if out_dir:
            with open(os.path.join(out_dir, "nvcc_ptxas.txt"), "w") as f:
                f.write(cuda_lib.build_log())
        for line in cuda_lib.build_log().splitlines():
            if "registers" in line or "spill" in line:
                log("  " + line.strip())
        for label, names, fname in (
                ("K1 and K2", ("decode_attn_kernel", "ring_attn_kernel"),
                 "ptxas_k1_k2.txt"),
                ("K3 and K7", ("seanet_gemm_kernel", "seanet_overlap_kernel",
                               "seanet_last_kernel", "insert_attn_kernel"),
                 "ptxas_k3_k7.txt")):
            rows = kernel_ptxas(cuda_lib.build_log(), names)
            log(f"  {label} (registers, shared memory, spills):")
            for line in rows:
                log("    " + line)
            if out_dir:
                with open(os.path.join(out_dir, fname), "w") as f:
                    f.write("\n".join(rows) + "\n")

        if args.moshi:
            phase = "moshi"
            header("[14] Moshi's kernels and lane frame")
            rows = check_moshi(device)
            print(json.dumps({"moshi": rows}))
            header("[done]")
            return _result(card, kind)

        if args.frame_graphs:
            phase = "frame graphs"
            header(f"[13] the lane frame from CUDA graphs, {FG_LANES} lanes")
            rows = check_frame_graphs(
                device, random_voice_prompt(DEFAULT_CONFIG, 120))
            print(json.dumps({"frame_graphs": rows}))
            header("[done]")
            return _result(card, kind)

        if args.cards > 1:
            phase = "mesh over NCCL"
            header(f"[12] the mesh over NCCL: {args.cards} ranks, one a card "
                   "(data 2 x model 2, 1 x 4, 4 x 1)")
            run_cards_phase(random_voice_prompt(DEFAULT_CONFIG, 120), device,
                            {})
            header("[done]")
            return _result(card, kind)

        phase = "kernels"
        header("[3] kernels vs plain versions (3c: K7, K2 and K3 over 32 "
            "lanes; 3d: the serving mode's int8-KV K1 and K7, K7 with "
            "statistics, K5a/K5b/K6 over many rows; 3e: K8, K5c, K2-q, K1 "
            "over lanes)")
        errs = {}
        engines = {}   # (path, dtype) -> engine
        paths = (("bf16",) + QUANT_PATHS + (KV8_PATH,) + MEGA_PATHS
                 + CONV_PATHS)
        for dtype in (torch.float32, torch.bfloat16):
            check_k1(device, dtype, errs)
            check_k2(device, dtype, errs)
            eng = make_engine(DEFAULT_CONFIG, device, dtype)
            engines["bf16", dtype] = eng
            check_k3(eng.params["mimi"]["decoder"], eng.cfg, device, dtype,
                     errs, eng.seanet_weights)
            phase = "kernels at batch"
            check_k7(device, dtype, errs)
            check_k2_lanes(device, dtype, errs)
            check_k3_lanes(eng.params["mimi"]["decoder"], eng.cfg, device,
                           dtype, errs, eng.seanet_weights)
            phase = "kernels"
            for path in QUANT_PATHS:
                qeng = make_engine(DEFAULT_CONFIG, device, dtype, path)
                engines[path, dtype] = qeng
                check_quant_kernels(qeng.params, qeng.cfg, device, dtype,
                                    errs, path)
            phase = "kernels, quantized convs"
            for path in CONV_PATHS:
                base = engines[CONV_COUNTERPART[path], dtype]
                engines[path, dtype] = make_engine(
                    base.cfg, device, dtype, params=base.params,
                    **ENGINE_KW[path])
                check_conv_kernels(engines[path, dtype], device, dtype,
                                   errs, path)
            phase = "kernels, serving mode"
            check_k1_kv8(device, dtype, errs)
            check_k7_kv8(device, dtype, errs)
            for path in QUANT_PATHS:
                check_quant_lanes(engines[path, dtype].params,
                                  engines[path, dtype].cfg, device, dtype,
                                  errs, path)
            check_quant_narrow(device, dtype)
            # the int4 engine's weights with the int8 KV cache
            engines[KV8_PATH, dtype] = make_engine(
                engines["int4", dtype].cfg, device, dtype, quantize_kv=True,
                params=engines["int4", dtype].params)
            phase = "kernels, slice 6"
            check_k8(engines, device, dtype, errs)
            check_k5c(engines, device, dtype, errs)
            check_k2q(device, dtype, errs)
            check_k1_lanes(device, dtype, errs)
            # slice 6's solo paths on the int8 and int4 engines' weights
            for path in MEGA_PATHS:
                base = engines[ENGINE_KW[path]["quantize"], dtype]
                engines[path, dtype] = make_engine(
                    path_cfg(base.cfg, path), device, dtype,
                    quantize_kv=ENGINE_KW[path].get("quantize_kv", False),
                    params=base.params)

        phase = "end to end"
        header("[4] end to end, DEFAULT_CONFIG, temp 0: bf16, int8, int4, "
            "q4_0, int4 weights + int8 KV cache, int8 + megalayer, int4 + "
            "int8 KV + megalayer + int8 mimi ring, int4 + bilayer")
        counts = counted_frame_steps()
        engine = engines["bf16", torch.bfloat16]
        voice = random_voice_prompt(engine.cfg, 120)
        runs = {path: end_to_end(engines[path, torch.bfloat16], voice, counts,
                                 path) for path in paths}

        phase = "params cache"
        header("[4b] q4_0 engine again from a params cache")
        check_cache(engines["q4_0", torch.bfloat16], voice, runs["q4_0"][2])

        phase = "gguf"
        header("[4c] the GGUF checkpoint and params cache on the card")
        with tempfile.TemporaryDirectory() as tmp:
            check_gguf(device, voice, tmp)

        phase = "card vs cpu"
        header("[5] end to end, card vs CPU, f32, first 12 frames")
        for path in paths:
            eng_cpu = make_engine(path_cfg(DEFAULT_CONFIG, path), "cpu",
                                  torch.float32, **ENGINE_KW[path])
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
        header(f"[6] timing on {card} (CUDA events, bf16, warm L2)")
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
        for path, other in COUNTERPART.items():
            log(f"  {path} vs its 3-call counterpart {other}, same rounds: "
                f"{1e3 / med[path]:.1f} vs {1e3 / med[other]:.1f} frames/s "
                "(medians with the EOS sync)")
        for path, other in CONV_COUNTERPART.items():
            log(f"  {path} vs {other} (float convs, K3), same rounds: "
                f"{1e3 / med[path]:.1f} vs {1e3 / med[other]:.1f} frames/s, "
                f"{1e3 * med[path]:.1f} vs {1e3 * med[other]:.1f} us a frame "
                "(medians with the EOS sync)")
        for label, (chosen, row) in time_splits(device,
                                                torch.bfloat16).items():
            log(f"  {label}, device us by split count (* the wrappers'): "
                + ", ".join(f"{sp}{'*' if sp == chosen else ''} {us:.2f}"
                            for sp, us in row.items()))
        from pocket_tts_tpu_torch.ops.fused_layer import MMA_ROWS
        for (path, name, rows, k, n, simt, plan, plans, sks,
             skinny) in time_rows_plans(bf, device):
            best = min(plans, key=plans.get)
            log(f"  K5 rows plans {path} {name} rows={rows} K={k} N={n}: "
                f"rows_kernel {simt:.2f} us; rows_mma (bm, splits) "
                + ", ".join(f"{bm}x{sp}{'*' if (bm, sp) == plan[:2] else ''}"
                            f" {us:.2f}" for (bm, sp), us in plans.items())
                + f"; fastest {best} {plans[best]:.2f}, the plan's "
                f"{plan[:2]} {plans.get(plan[:2], float('nan')):.2f}"
                + ("" if not skinny else "; skinny (slices) " + ", ".join(
                    f"{ks}{'*' if ks == sks else ''} {us:.2f}"
                    for ks, us in skinny.items()))
                + f" (R_min = MMA_ROWS = {MMA_ROWS})")
        from pocket_tts_tpu_torch.ops.quant_matmul import WGMMA_ROWS
        for (name, rows, k, n, plan, plans, mma, dense,
             lib_us) in time_k4a_plans(device, bf["int8"].params):
            best = min(plans, key=plans.get)
            log(f"  K4a plans {name} rows={rows} K={k} N={n}: wgmma (bt, "
                f"splits) " + ", ".join(
                    f"{bt}x{sp}{'*' if (bt, sp) == plan else ''} {us:.2f}"
                    for (bt, sp), us in plans.items())
                + f"; fastest {best} {plans[best]:.2f}, the plan's {plan} "
                f"{plans[plan]:.2f}; rows_mma {mma:.2f}; dense bf16 "
                f"{dense:.2f}; _weight_int8pack_mm "
                + ("none" if lib_us is None else f"{lib_us:.2f}")
                + f" us (WGMMA_ROWS = {WGMMA_ROWS})")
        for name, (plan, row) in k4a_marks(device,
                                           bf["int8"].params).items():
            log(f"  K4a marks {name} rows=128 plan {plan}: " + ", ".join(
                f"{key} {v:.2f}" for key, v in row.items())
                + " us (per block, mean over the grid; span: the grid's)")
        for label, row in time_flow_clusters(bf, device).items():
            log(f"  K6 {label} by cluster size: " + ", ".join(
                f"{cs} blocks {us:.2f} us" for cs, us in row.items()))
        times = time_kernels(engine, device, torch.bfloat16)
        for path in QUANT_PATHS:
            time_quant_kernels(bf[path].params, bf[path].cfg, device,
                               torch.bfloat16, path, times)
        time_kv8_kernels(device, torch.bfloat16, times)
        time_lane_kernels(bf[KV8_PATH].params, bf[KV8_PATH].cfg, device,
                          torch.bfloat16, times)
        time_slice6_kernels(bf, device, torch.bfloat16, times)
        for (path, b), tot in time_conv_kernels(bf, device, times).items():
            log(f"  K4 convs {path}, {b} lane(s), a frame's convs: kernels "
                f"{tot['k'][0] * 1e3:.2f} us device, plain "
                f"{tot['plain'][0] * 1e3:.2f} us, library "
                + (f"{tot['lib'] * 1e3:.2f} us" if tot["lib_ok"] else "none")
                + f", dense bf16 {tot['dense'] * 1e3:.2f} us, bound "
                f"{bound_ms(tot['bytes'], tot['flops'])[0] * 1e3:.2f} us")
        for name, rows in times.items():
            for r in rows:
                (ms, host), (plain_ms, plain_host) = r["k"], r["plain"]
                lib = ("none" if r["lib"] is None
                       else f"{r['lib'] * 1e3:.2f} us")
                cmp = ("" if "cmp" not in r else
                       f" (for comparison, SDPA over bf16 caches of the "
                       f"same shape: {r['cmp'] * 1e3:.2f} us)")
                if "three" in r:
                    cmp += (f"; the 3-call path it replaces (K5a, rope, "
                            f"row quantization, K7, K5b): "
                            f"{r['three'] * 1e3:.2f} us device")
                if "two" in r:
                    cmp += (f"; K5b then K5a: {r['two'] * 1e3:.2f} us "
                            "device")
                log(f"  {name} ({r['shape']}): kernel {ms * 1e3:.2f} us "
                    f"device, {host * 1e3:.2f} us host per call; plain "
                    f"{plain_ms * 1e3:.2f} us device, {plain_host * 1e3:.2f}"
                    f" us host; library {lib}{cmp}; bound "
                    f"{r['bound'][0] * 1e3:.2f} us ({r['bound'][1]}): "
                    f"{r['bound'][0] / ms:.1%} of it")

        phase = "serving"
        header("[7] serving, DEFAULT_CONFIG, ContinuousBatchingServer (prefix+"
            "ring), temp 0")
        lane_steps = counted_lane_steps()
        serve_vs_solo(device, voice)
        serve_vs_solo(device, voice, "int8_kv8", share_prefix=True)
        phase = "serving without the fused insert (K1 over lanes)"
        k1_serve_launches = serve_vs_solo(device, voice, K1_SERVE,
                                          share_prefix=True,
                                          steps=lane_steps)
        phase = "serving with quantized convs"
        serve_vs_solo(device, voice, SERVE_CONVS, share_prefix=True,
                      steps=lane_steps, lanes=LANES)
        phase = "serving"
        # the two modes in turns (bf16, serving mode, serving mode, bf16):
        # host timing drifts within a call; every run checks its launches
        serve_launches, _, _ = serve_throughput(engine, voice, lane_steps)
        phase = "serving, int4 + int8 KV + shared prefix"
        serve_kv8_launches, _, _ = serve_throughput(
            bf[KV8_PATH], voice, lane_steps, mode=KV8_PATH)
        serve_throughput(bf[KV8_PATH], voice, lane_steps, mode=KV8_PATH)
        phase = "serving"
        serve_throughput(engine, voice, lane_steps)
        phase = "serving: cli"
        with tempfile.TemporaryDirectory() as tmp:
            serve_cli(tmp)
            serve_cli(tmp, ("--quantize", "int4", "--quantize-kv",
                            "--share-prefix"))

        # the profilers run last, so that no profiler session precedes a
        # host-clock measurement
        header("[8] profiler (torch.profiler, device time by kernel)")
        for label, eng in bf.items():
            phase = f"profiler, {label}"
            busy, kern, counted = profile_frames(
                eng, voice,
                os.path.join(out_dir, f"profile_frames_{label}.txt")
                if out_dir else None)
            launches = sum(r[2] for r in kern)
            log(f"  {label} profiler: device busy {busy:.1f} us per "
                f"frame in {launches:.0f} kernel "
                f"launches, {1e3 * med[label]:.1f} us wall per frame "
                f"(phase 6): device idle {1 - busy / (1e3 * med[label]):.1%}")
            check_frame_launches(label, kern, counted)
            for key, us, calls in kern[:12]:
                log(f"    {us:9.1f} us/frame  {calls:6.1f} calls/frame "
                    f" {key[:70]}")
        serve_convs = make_engine(
            bf["int4"].cfg, device, torch.bfloat16, params=bf["int4"].params,
            **ENGINE_KW[SERVE_CONVS])
        for label, eng, share in (("bf16", engine, False),
                                  (KV8_PATH, bf[KV8_PATH], True),
                                  (SERVE_CONVS, serve_convs, True)):
            phase = ("profiler, serving" if label == "bf16"
                     else f"profiler, serving {label}")
            busy, walls, frames, kern, counted = profile_serving(
                eng, voice, os.path.join(
                    out_dir, "profile_serving.txt" if label == "bf16"
                    else f"profile_serving_{label}.txt")
                if out_dir else None, share_prefix=share)
            wall = float(np.median(walls))
            log(f"  serving {label}{', shared prefix' if share else ''}, "
                f"{LANES} lanes busy: device busy {busy:.1f} us per "
                f"chunk ({frames} frames) in {sum(r[2] for r in kern):.0f} "
                f"kernel launches; wall per chunk (host clock, before the "
                f"profiler) median {wall:.1f} us, range {min(walls):.1f}-"
                f"{max(walls):.1f}: device idle {1 - busy / wall:.1%}; "
                f"{frames / wall * 1e6:.1f} frames/s with every lane busy")
            rows, verdict = launch_crosscheck(kern, counted)
            log("    profiler / counters per chunk: " + ", ".join(
                f"{fam} {p:.2f} / {c:.2f}" for fam, p, c in rows)
                + f": {verdict}")
            for key, us, calls in kern[:12]:
                log(f"    {us:9.1f} us/chunk  {calls:6.1f} calls/chunk "
                    f" {key[:70]}")

        phase = "command line"
        header(f"[9] command line on {card} (subprocesses of the CLI), the "
               f"reference-exact mode, {WIDE_LANES} lanes")
        with tempfile.TemporaryDirectory() as tmp:
            phase = "command line: --bench"
            for extra in ((), ("--quantize", "int8"),
                          ("--quantize", "int8", "--quantize-convs")):
                cli_bench(extra)
            phase = "command line: stream loop"
            stream_rows(bf, voice)
            phase = "command line: roofline"
            roofline_rows(bf, med, kind)
            phase = "command line: --profile"
            cli_profile(tmp)
            phase = "command line: --batch"
            cli_batch(tmp)
            cli_batch(tmp, ("--quantize", "int4", "--quantize-convs"))
            phase = "command line: ab"
            check_ab(tmp)
        phase = "command line: --reference-exact"
        for path in EXACT_PATHS:
            check_exact(device, voice, counts, path)
        phase = f"command line: {WIDE_LANES} lanes"
        serve_vs_solo(device, voice, KV8_PATH, share_prefix=True,
                      steps=lane_steps, lanes=WIDE_LANES)
        with tempfile.TemporaryDirectory() as tmp:
            serve_cli(tmp, ("--lanes", str(WIDE_LANES), "--quantize", "int4",
                            "--quantize-kv", "--share-prefix"))
            serve_cli(tmp, ("--quantize", "int4", "--quantize-kv",
                            "--share-prefix", "--quantize-convs"))
        wide_chunk_walls(bf[KV8_PATH], voice)

        header("[10] dormant modules: the native library, gating + RMSNorm "
               "alphas, cross-attention, the SEANet encoder")
        t10 = time.perf_counter()
        phase = "dormant modules: native library"
        check_native()
        phase = "dormant modules: kernels"
        qenc = check_dormant_kernels(DEFAULT_CONFIG, device, errs)
        phase = "dormant modules: paths"
        dormant, ex = dormant_engines(engines, DEFAULT_CONFIG, device,
                                      torch.bfloat16)
        for label, eng in dormant.items():
            quant = "int8" if label.endswith("_int8") else None
            if label.startswith("cross"):
                check_cross_run(eng, voice, ex, label, quant)
            else:
                end_to_end(eng, voice, counts, label, expected=(
                    dormant_launches(eng.cfg, "gated_rms", quant),
                    expected_launches(eng.cfg, quant or "bf16")[1]))
        phase = "dormant modules: card vs cpu"
        check_dormant_card_vs_cpu(DEFAULT_CONFIG, device, voice, ex)
        check_weights_per_step(DEFAULT_CONFIG, device)
        phase = "dormant modules: encoder"
        check_encoder(DEFAULT_CONFIG, device, qenc)
        phase = "dormant modules: timing"
        time_dormant(dict(bf16=bf["bf16"], int8=bf["int8"], **dormant),
                     voice, ex)
        time_encoder_kernels(qenc, DEFAULT_CONFIG, device)
        log(f"  phase 10: {time.perf_counter() - t10:.1f} s")

        phase = "mesh"
        header("[11] sharded serving: 4 gloo ranks (data 2 x model 2) on "
               "the one card")
        run_mesh_phase(voice, device, {})
    except Exception:
        import traceback
        traceback.print_exc()
        print(f"chip_smoke: FAILED in phase '{phase}'", file=sys.stderr)
        return 1

    header("[done]")

    def path_launches(name):
        if name in SERVING_KERNELS:
            return serve_launches[name]
        if name in SERVING_KV8_KERNELS:
            return serve_kv8_launches[name]
        if name == "decode_attn_kv8":
            return runs[KV8_PATH][0][name]
        if name in ("decode_attn_lanes", "decode_attn_stats"):
            return k1_serve_launches[name]
        if name in MEGA_KERNELS:
            return runs[MEGA_KERNELS[name]][0][name]
        if name in WIDE_PREFILL:
            return runs["int8"][0][name] + runs["int8_convs"][0][name]
        users = [p for p in QUANT_PATHS + CONV_PATHS
                 if name in PATH_KERNELS[ENGINE_KW[p]["quantize"]]]
        return sum(runs[p][0][name] for p in users or ["bf16"])

    kernels = []
    for name in KERNELS:
        r = times[name][0]
        kernels.append(dict(
            name=name, route="cuda", **KERNELS[name],
            launches=path_launches(name), max_abs_err=errs[name]["bf16"],
            ms=r["k"][0], plain_ms=r["plain"][0], bound_ms=r["bound"][0],
            bound_by=r["bound"][1], library_ms=r["lib"]))
    print(json.dumps({"kernels": kernels}))
    return _result(card, kind)


def _result(card, kind) -> int:
    """The card's name and power limit, then the result line; 0."""
    import torch
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
