"""pocket-tts command line for the PyTorch port (main-path flags only).

Usage:
  python -m pocket_tts_tpu_torch.cli --random-weights -s 1 -t 0.7 \\
      -o out.wav "Hello world."

Text streams through `Stream.send/flush/receive` in 15-character chunks,
as the JAX package's CLI feeds it. --device defaults to "cuda" (the
hand-written kernels run there, in bf16) and fails when there is no card;
--device cpu runs the plain versions in f32. --quantize int8 (or q8)
quantizes the linear weights to int8 after load.
"""
from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np


def build_parser():
    p = argparse.ArgumentParser(prog="pocket-tts-torch", description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("text", nargs="?", default=None)
    p.add_argument("-m", "--model", default=None,
                   help="model directory (tts_b6369a24.safetensors, "
                        "tokenizer.model, embeddings/)")
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
    p.add_argument("--quantize", default=None, choices=["int8", "q8"],
                   help="per-channel int8 linear weights (quantized after "
                        "load)")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.text is None:
        build_parser().print_help()
        return 1
    import torch

    from pocket_tts_tpu.io.wav import save_wav
    from .config import DEFAULT_CONFIG
    from .runtime.engine import TTSEngine

    device = args.device
    if device.startswith("cuda") and not torch.cuda.is_available():
        print("no CUDA device (torch.cuda.is_available() is False); pass "
              "--device cpu to run on the CPU", file=sys.stderr)
        return 1
    dtype = torch.bfloat16 if device.startswith("cuda") else torch.float32
    if args.random_weights:
        from .io.params import random_params, random_voice_prompt
        params, cfg = random_params(DEFAULT_CONFIG, dtype=dtype,
                                    device=device)
        engine = TTSEngine(params=params, cfg=cfg, dtype=dtype,
                           device=device, seed=args.seed,
                           quantize=args.quantize)
        voice = random_voice_prompt(cfg)
    else:
        model = args.model or "."
        if not os.path.exists(os.path.join(model,
                                           "tts_b6369a24.safetensors")):
            print(f"no checkpoint under {model}; pass -m or "
                  "--random-weights", file=sys.stderr)
            return 1
        engine = TTSEngine(model_path=model, dtype=dtype, device=device,
                           seed=args.seed, quantize=args.quantize)
        voice = args.voice
    print(f"seed: {engine.seed}")
    print(f"device: {engine.device} ({dtype}"
          f"{', int8 weights' if args.quantize else ''})")

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
