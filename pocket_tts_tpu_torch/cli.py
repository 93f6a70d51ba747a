"""pocket-tts command line for the PyTorch port (main-path flags only).

Usage:
  python -m pocket_tts_tpu_torch.cli --random-weights -s 1 -t 0.7 \\
      -o out.wav "Hello world."

Text streams through `Stream.send/flush/receive` in 15-character chunks,
as the JAX package's CLI feeds it. --device defaults to "cuda" (the
hand-written kernels run there, in bf16) and fails when there is no card;
--device cpu runs the plain versions in f32. --quantize int8 (or q8)
quantizes the linear weights to int8 after load, int4 (or q4) to packed
int4 with per-channel scales, q4_0 to int4 with 32-row K-grouped scales.
--save-cache writes the (quantized) params to a safetensors params cache,
--load-cache starts from one (either package's; DEFAULT_CONFIG).
--quantize-kv keeps the backbone's KV cache in int8 with per-row scales
(solo and --serve). --fuse-insert routes each solo decode step's KV-row
write and attention through kernel K7 instead of a row write and K1.
--megalayer (implies --fuse-insert) runs each quantized decode layer as
one launch of kernel K8 (int8 or int4 weights; q4_0 raises).

The checkpoint, tokenizer and voice embeddings are read from -m/--model,
or else from <-r/--model-root, or $MODEL_CACHE, or .>/kyutai/
pocket-tts-without-voice-cloning, the JAX package's CLI layout. With no
checkpoint there the CLI says so on stderr and runs random weights and a
random voice, as the JAX package's CLI does (--random-weights: the same,
without the note).

Serving:
  python -m pocket_tts_tpu_torch.cli --random-weights --serve reqs.txt \
      --serve-out out_dir [--lanes 32] [--quantize int4 --quantize-kv \
      --share-prefix]

--serve reads requests from a file ('-' for stdin), one per line: a JSON
object ({"text": ..., "voice"?: ..., "temp"?: ..., "id"?: ...}) or a
plain text line, decodes them through the ContinuousBatchingServer and
writes one wav per request under --serve-out. --share-prefix holds one
shared copy of each voice's prompt KV for the whole batch; with --quantize
int4 --quantize-kv it is the JAX package's serving mode.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np


def build_parser():
    p = argparse.ArgumentParser(prog="pocket-tts-torch", description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("text", nargs="?", default=None)
    p.add_argument("-r", "--model-root", default=None,
                   help="root for kyutai models (default: $MODEL_CACHE or "
                        ".)")
    p.add_argument("-m", "--model", default=None,
                   help="model directory (tts_b6369a24.safetensors, "
                        "tokenizer.model, embeddings/; default: <root>/"
                        "kyutai/pocket-tts-without-voice-cloning)")
    p.add_argument("-v", "--voice", default="cosette",
                   help="voice name or voice .safetensors path")
    p.add_argument("-s", "--seed", type=int, default=0)
    p.add_argument("-t", "--temperature", type=float, default=0.6)
    p.add_argument("-o", "--output", default=None, help="output .wav path")
    p.add_argument("--random-weights", action="store_true",
                   help="random weights and the mock tokenizer (no "
                        "checkpoint needed)")
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda (default) or cpu")
    p.add_argument("--quantize", default=None,
                   choices=["int8", "q8", "int4", "q4", "q4_0"],
                   help="quantized linear weights (after load): per-channel "
                        "int8 or int4; q4_0 = int4 with 32-row K-grouped "
                        "scales")
    p.add_argument("--quantize-kv", action="store_true",
                   help="int8 backbone KV cache (per-row scales): the "
                        "serving-throughput mode")
    p.add_argument("--quantize-convs", action="store_true",
                   help="quantize the SEANet/mimi convs (not ported yet)")
    p.add_argument("--save-cache", default=None, metavar="PATH",
                   help="write the params cache (.safetensors) and go on")
    p.add_argument("--load-cache", default=None, metavar="PATH",
                   help="load params from a params cache (.safetensors)")
    p.add_argument("--fuse-insert", action="store_true",
                   help="solo decode: write the KV row and attend in one "
                        "kernel (K7); serving always does")
    p.add_argument("--megalayer", action="store_true",
                   help="solo quantized decode: one kernel (K8) per backbone "
                        "layer (implies --fuse-insert)")
    p.add_argument("--serve", default=None, metavar="PATH",
                   help="continuous-serving mode: read requests from PATH "
                        "('-' = stdin; JSON objects with text/voice/temp/id "
                        "or plain text lines), decode them through the "
                        "ContinuousBatchingServer and write one wav per "
                        "request")
    p.add_argument("--serve-out", default=None, metavar="DIR",
                   help="output directory for --serve wavs "
                        "(default: serve_out)")
    p.add_argument("--lanes", type=int, default=32,
                   help="continuous server decode lanes (--serve)")
    p.add_argument("--share-prefix", action="store_true",
                   help="--serve: one shared copy of each voice's prompt KV "
                        "for the whole batch instead of one per lane")
    return p


_WEIGHTS = {"int8": "int8", "q8": "int8", "int4": "int4", "q4": "int4",
            "q4_0": "q4_0"}


def model_dir(args) -> str:
    """-m, or the JAX CLI's default layout under -r / $MODEL_CACHE / ."""
    return args.model or os.path.join(
        args.model_root or os.environ.get("MODEL_CACHE", "."), "kyutai",
        "pocket-tts-without-voice-cloning")


def _serve(engine, args, voice):
    """Drain a request file through the ContinuousBatchingServer. Each
    request's text is split into sentences of at most 50 tokens (the
    engine's splitter); the chunks' audio concatenates back into ONE wav
    per request."""
    from .io.params import load_voice
    from .io.wav import save_wav
    from .runtime.engine import DEFAULT_VOICES
    from .runtime.server import ContinuousBatchingServer
    from .text.preprocess import split_into_best_sentences

    lines = (sys.stdin.read() if args.serve == "-"
             else open(args.serve).read()).splitlines()
    reqs = []
    for i, line in enumerate(lines):
        line = line.strip()
        if not line:
            continue
        obj = json.loads(line) if line.startswith("{") else {"text": line}
        obj.setdefault("id", f"req_{i:04d}")
        obj.setdefault("voice", "default")
        obj.setdefault("temp", args.temperature)
        reqs.append(obj)
    if not reqs:
        print("no requests in input", file=sys.stderr)
        return 1
    srv = ContinuousBatchingServer(engine, lanes=args.lanes,
                                   share_prefix=args.share_prefix)

    def resolve(name):
        if not isinstance(voice, str):
            # random weights: every name maps to the synthetic prompt
            return np.asarray(voice, np.float32)
        v = voice if name == "default" else name
        path = (os.path.join(model_dir(args), "embeddings",
                             v + ".safetensors")
                if v in DEFAULT_VOICES else v)
        return load_voice(path).cpu().numpy()

    srv.register_voices({name: resolve(name)
                         for name in {r["voice"] for r in reqs}})
    budget = min(50, srv.text_bucket)
    parts = []  # (request index, chunk index, server Request)
    for ri, obj in enumerate(reqs):
        for ci, chunk in enumerate(split_into_best_sentences(
                engine.tokenizer, obj["text"], budget)):
            parts.append((ri, ci, srv.submit(chunk, obj["voice"],
                                             float(obj["temp"]))))
    t0 = time.perf_counter()
    srv.run_pending()
    wall = time.perf_counter() - t0
    outdir = args.serve_out or "serve_out"
    os.makedirs(outdir, exist_ok=True)
    per_req = {}
    for ri, ci, sr in parts:
        per_req.setdefault(ri, []).append((ci, sr.pcm))
    frames = 0
    for ri, chunks in sorted(per_req.items()):
        pcm = np.concatenate([p for _, p in sorted(chunks, key=lambda c:
                                                   c[0])])
        frames += pcm.size // engine.frame_size
        save_wav(os.path.join(outdir, f"{reqs[ri]['id']}.wav"), pcm,
                 engine.sample_rate)
    stats = srv.stats()
    stats.update({"requests": len(reqs), "chunks": len(parts),
                  "lanes": srv.lanes, "wall_s": round(wall, 3),
                  "aggregate_frames_per_second": round(frames / wall, 1),
                  "outdir": outdir})
    print(json.dumps(stats))
    return 0


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.text is None and not (args.save_cache or args.serve):
        build_parser().print_help()
        return 1
    if args.quantize_convs:  # before any weights are built
        raise NotImplementedError("--quantize-convs is not ported yet")
    import dataclasses

    import torch

    from .config import DEFAULT_CONFIG
    from .io.wav import save_wav
    from .runtime.engine import TTSEngine

    device = args.device
    if device.startswith("cuda") and not torch.cuda.is_available():
        print("no CUDA device (torch.cuda.is_available() is False); pass "
              "--device cpu to run on the CPU", file=sys.stderr)
        return 1
    dtype = torch.bfloat16 if device.startswith("cuda") else torch.float32
    cfg0 = DEFAULT_CONFIG
    if args.fuse_insert or args.megalayer:
        cfg0 = dataclasses.replace(cfg0, backbone=dataclasses.replace(
            cfg0.backbone, fuse_insert=True, use_megalayer=args.megalayer))
    model = model_dir(args)
    if args.load_cache:
        # the model directory, when given, provides tokenizer and voices
        engine = TTSEngine.from_params_cache(
            args.load_cache, cfg0, model_path=args.model,
            dtype=dtype, device=device, seed=args.seed,
            quantize=args.quantize, quantize_kv=args.quantize_kv)
        if args.random_weights:  # no model directory: a synthetic voice
            from .io.params import random_voice_prompt
            voice = random_voice_prompt(engine.cfg)
        else:
            voice = args.voice
    elif args.random_weights or not os.path.exists(
            os.path.join(model, "tts_b6369a24.safetensors")):
        # no checkpoint: random weights and a random voice, as the JAX
        # package's CLI does
        if not args.random_weights:
            print(f"note: no checkpoint under {model}; using random "
                  "weights", file=sys.stderr)
        from .io.params import random_params, random_voice_prompt
        params, cfg = random_params(cfg0, dtype=dtype, device=device)
        engine = TTSEngine(params=params, cfg=cfg, dtype=dtype,
                           device=device, seed=args.seed,
                           quantize=args.quantize,
                           quantize_kv=args.quantize_kv)
        voice = random_voice_prompt(cfg)
    else:
        engine = TTSEngine(model_path=model, cfg=cfg0, dtype=dtype,
                           device=device, seed=args.seed,
                           quantize=args.quantize,
                           quantize_kv=args.quantize_kv)
        voice = args.voice
    if args.save_cache:
        engine.save_params_cache(args.save_cache)
        print(f"wrote params cache: {args.save_cache}")
        if args.text is None and not args.serve:
            return 0
    if args.serve:
        return _serve(engine, args, voice)
    weights = (f", {_WEIGHTS[args.quantize]} weights" if args.quantize
               else "") + (", int8 KV cache" if args.quantize_kv else "")
    print(f"seed: {engine.seed}")
    print(f"device: {engine.device} ({dtype}{weights})")

    stream = engine.open_stream(voice, args.temperature)
    frames = []
    t0 = time.perf_counter()

    def pump():
        while True:
            frame = stream.receive()
            if frame is None:
                return
            frames.append(frame)

    text = args.text
    for pos in range(0, len(text), 15):
        stream.send(text[pos:pos + 15])
        if pos + 15 >= len(text):
            stream.flush()
        pump()
    pump()
    wall = time.perf_counter() - t0
    n = len(frames)
    print(f"frame count: {n:4d} frames")
    print(f"frame rate:  {n / wall if wall > 0 else 0.0:f} frames/s "
          f"(wall clock, {wall:.3f} s)")
    if args.output:
        pcm = np.concatenate(frames) if frames else np.zeros(0, np.float32)
        save_wav(args.output, pcm, engine.sample_rate)
        print(f"wrote {args.output}: {pcm.size / engine.sample_rate:.2f}s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
