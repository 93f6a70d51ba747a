"""pocket-tts command line for the PyTorch port.

Usage:
  python -m pocket_tts_tpu_torch.cli --random-weights -s 1 -t 0.7 \\
      -o out.wav "Hello world."
  python -m pocket_tts_tpu_torch.cli --random-weights --bench --json

It takes every option of the JAX package's CLI (`pocket_tts_tpu/cli.py`)
but --fetch-models, with the same meaning. Text (the
argument, or -i FILE) streams through `Stream.send/flush/receive` in
15-character chunks, as the JAX package's CLI feeds it; --interactive
reads stdin lines instead. Each `receive` is timed with
`utils.profiling.FrameMeter`: the report gives frames/s, realtime factor
and time to first audio (ttfa_ms: from the stream's start to the first
frame on the host, prefill included) on the host clock; --json prints it
as one JSON line with the JAX CLI's keys. --bench fixes the text, seed 0
and temperature 0 unless they are given. --batch N synthesizes the text N
times at once (runtime.batched.BatchedEngine) and reports the aggregate
frames/s. --profile DIR records a torch.profiler trace of the stream into
DIR/trace.json. -o writes .wav and .flac natively and other containers
through an ffmpeg binary (io/audio.py), --out-rate HZ resamples before
the encoder (io/audio_in.py), --play plays while generating
(runtime/player.py). --reference-exact runs `reference_exact_config`
(config.py says which kernels it leaves out). --compile-cache DIR chooses
the directory the kernel library is built into. -l lists the CUDA
devices. --threads is accepted and ignored.

--device (-d) defaults to "cuda" (the
hand-written kernels run there, in bf16) and fails when there is no card;
--device cpu runs the plain versions in f32. --quantize int8 (or q8)
quantizes the linear weights to int8 after load, int4 (or q4) to packed
int4 with per-channel scales, q4_0 to int4 with 32-row K-grouped scales.
--quantize-convs (with --quantize) quantizes the SEANet decoder's large
convs too: the decoder then runs K4a / K4b in place of kernel K3.
--save-cache writes the (quantized) params to a params cache (safetensors,
or GGUF for a .gguf path, whose large float tensors --gguf-quantize
q8_0 | q4_0 | q8_k | q4_k block-quantizes), --load-cache starts from one
(either package's; DEFAULT_CONFIG). A model directory holding
tts_b6369a24.gguf and no .safetensors loads the GGUF checkpoint.
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
    p.add_argument("-l", "--list-devices", action="store_true",
                   help="list the CUDA devices (index, name, memory) and "
                        "exit")
    p.add_argument("-d", "--device", default="cuda",
                   help="torch device: cuda (default) or cpu (the JAX "
                        "CLI's -d takes a JAX platform)")
    p.add_argument("--threads", type=int, default=None,
                   help="accepted for parity with the JAX CLI; ignored")
    p.add_argument("-r", "--model-root", default=None,
                   help="root for kyutai models (default: $MODEL_CACHE or "
                        ".)")
    p.add_argument("-m", "--model", default=None,
                   help="model directory (tts_b6369a24.safetensors, "
                        "tokenizer.model, embeddings/; default: <root>/"
                        "kyutai/pocket-tts-without-voice-cloning)")
    p.add_argument("-v", "--voice", default="cosette",
                   help="voice name or voice .safetensors path")
    p.add_argument("-o", "--output", default=None,
                   help="output audio path (.wav/.flac native; "
                        ".mp3/.ogg/.opus/.m4a through an ffmpeg binary)")
    p.add_argument("-i", "--input", default=None, help="input text file")
    p.add_argument("--out-rate", type=int, default=None, metavar="HZ",
                   help="resample the output audio to this rate before "
                        "encoding (polyphase resampler, io/audio_in.py)")
    p.add_argument("-s", "--seed", type=int, default=None,
                   help="noise seed (default 0)")
    p.add_argument("-t", "--temperature", type=float, default=None,
                   help="sampling temperature (default 0.6; 0 with "
                        "--bench)")
    p.add_argument("--bench", action="store_true",
                   help="bench defaults: fixed text, seed 0, temp 0")
    p.add_argument("--random-weights", action="store_true",
                   help="random weights and the mock tokenizer (no "
                        "checkpoint needed)")
    p.add_argument("--batch", type=int, default=1,
                   help="synthesize the text N times at once (lanes) and "
                        "report the aggregate frames/s")
    p.add_argument("--json", action="store_true",
                   help="emit the stats as one JSON line")
    p.add_argument("--interactive", action="store_true",
                   help="read text from stdin, stream audio per line")
    p.add_argument("--quantize", default=None,
                   choices=["int8", "q8", "int4", "q4", "q4_0"],
                   help="quantized linear weights (after load): per-channel "
                        "int8 or int4; q4_0 = int4 with 32-row K-grouped "
                        "scales")
    p.add_argument("--quantize-kv", action="store_true",
                   help="int8 backbone KV cache (per-row scales): the "
                        "serving-throughput mode")
    p.add_argument("--quantize-convs", action="store_true",
                   help="with --quantize: quantize the SEANet decoder's large "
                        "convs too (K4a/K4b in place of kernel K3)")
    p.add_argument("--save-cache", default=None, metavar="PATH",
                   help="write the params cache (.safetensors or .gguf) and "
                        "go on")
    p.add_argument("--load-cache", default=None, metavar="PATH",
                   help="load params from a params cache (.safetensors or "
                        ".gguf)")
    p.add_argument("--gguf-quantize", default=None,
                   choices=["q8_0", "q4_0", "q8_k", "q4_k"],
                   help="ggml block quantization for --save-cache *.gguf")
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="record a torch.profiler trace of the stream into "
                        "DIR/trace.json (Chrome trace format)")
    p.add_argument("--play", action="store_true",
                   help="play audio while generating (aplay/pw-play/"
                        "ffplay through a 3-frame PcmFifo ring)")
    p.add_argument("--reference-exact", action="store_true",
                   help="ggml-reference-exact numerics (tanh GELU, -1e5 "
                        "mask, 250-slot mimi ring; plain attention instead "
                        "of the attention and fused-layer kernels)")
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
    p.add_argument("--share-prefix", action="store_true",
                   help="--serve: one shared copy of each voice's prompt KV "
                        "for the whole batch instead of one per lane")
    p.add_argument("--lanes", type=int, default=32,
                   help="continuous server decode lanes (--serve)")
    p.add_argument("--compile-cache", default=None, metavar="DIR",
                   help="directory nvcc builds the kernel library into "
                        "(default: the package's _build/; 'off' builds "
                        "into a fresh temporary directory); a library "
                        "built there before for the same sources loads "
                        "at once")
    return p


_WEIGHTS = {"int8": "int8", "q8": "int8", "int4": "int4", "q4": "int4",
            "q4_0": "q4_0"}


def model_dir(args) -> str:
    """-m, or the JAX CLI's default layout under -r / $MODEL_CACHE / ."""
    return args.model or os.path.join(
        args.model_root or os.environ.get("MODEL_CACHE", "."), "kyutai",
        "pocket-tts-without-voice-cloning")


def _serve(engine, args, voice, temp: float):
    """Drain a request file through the ContinuousBatchingServer. Each
    request's text is split into sentences of at most 50 tokens (the
    engine's splitter); the chunks' audio concatenates back into ONE wav
    per request."""
    from .io.wav import save_wav
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
        obj.setdefault("temp", temp)
        reqs.append(obj)
    if not reqs:
        print("no requests in input", file=sys.stderr)
        return 1
    srv = ContinuousBatchingServer(engine, lanes=args.lanes,
                                   share_prefix=args.share_prefix)

    def resolve(name):
        if name == "default" or not isinstance(voice, str):
            # random weights: every name maps to the synthetic prompt
            return _voice_array(voice, args)
        return _voice_array(name, args)

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


def pump(stream, meter, on_frame=None) -> int:
    """Drain the frames a Stream has ready; returns how many came. Each
    `receive` is one FrameMeter step, as in the JAX CLI's pump (a receive
    that gives nothing is taken back with `meter.skip`); on_frame(frame)
    gets each frame."""
    n = 0
    while True:
        with meter.step():
            frame = stream.receive()
        if frame is None:
            meter.skip()
            return n
        n += 1
        if on_frame is not None:
            on_frame(frame)


def feed(stream, meter, text: str, on_frame=None) -> int:
    """Stream `text` in 15-character chunks, as the JAX CLI does, flushing
    with the last one and pumping after each; returns the frames."""
    frames, pos = 0, 0
    while pos < len(text):
        chunk = text[pos:pos + 15]
        pos += len(chunk)
        stream.send(chunk)
        if pos >= len(text):
            stream.flush()
        frames += pump(stream, meter, on_frame)
    return frames + pump(stream, meter, on_frame)


def _list_devices() -> int:
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device (torch.cuda.is_available() is False)")
        return 0
    for i in range(torch.cuda.device_count()):
        prop = torch.cuda.get_device_properties(i)
        print(f"cuda:{i}: {prop.name}, {prop.total_memory / 2 ** 30:.1f} "
              "GiB")
    return 0


def _voice_array(voice, args):
    """A voice name or path as a (Tp, d_model) float32 array (the batch
    path primes the lanes from arrays); an array stays as it is."""
    if not isinstance(voice, str):
        return np.asarray(voice, np.float32)
    from .io.params import load_voice
    from .runtime.engine import DEFAULT_VOICES
    path = (os.path.join(model_dir(args), "embeddings", voice + ".safetensors")
            if voice in DEFAULT_VOICES else voice)
    return load_voice(path).cpu().numpy()


def _batch(engine, args, text, voice, temp: float) -> int:
    """--batch N: the text N times at once through BatchedEngine, the
    aggregate frames/s (the JAX CLI's batched throughput mode)."""
    from .io.audio import save_audio
    from .runtime.batched import BatchedEngine
    be = BatchedEngine(engine)
    vstates = be.prime_voices([_voice_array(voice, args)] * args.batch)
    t0 = time.perf_counter()
    pcms = be.synthesize_batch([text] * args.batch, vstates, temp)
    dt = time.perf_counter() - t0
    frames = sum(p.size for p in pcms) // engine.frame_size
    fps = frames / dt
    print(f"batch {args.batch}: {frames} frames in {dt:.2f}s = "
          f"{fps:.1f} frames/s aggregate")
    if args.json:
        print(json.dumps({"metric": "batched_frames_per_second",
                          "value": round(fps, 2), "unit": "frames/s",
                          "batch": args.batch}))
    if args.output:
        pcm0, rate = pcms[0], engine.sample_rate
        if args.out_rate and args.out_rate != rate:
            from .io.audio_in import resample
            pcm0, rate = resample(pcm0, rate, args.out_rate), args.out_rate
        save_audio(args.output, pcm0, rate)
    return 0


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.list_devices:
        return _list_devices()
    text = args.text
    if args.input:
        with open(args.input) as f:
            text = f.read()
    seed, temp = args.seed, args.temperature
    if args.bench:
        if text is None:
            text = "The quick brown fox jumped over the sleeping dog."
        if seed is None:
            seed = 0
        if temp is None:
            temp = 0.0
    if text is None and not (args.interactive or args.save_cache
                             or args.serve):
        build_parser().print_help()
        return 1
    seed = 0 if seed is None else seed
    temp = 0.6 if temp is None else temp
    import contextlib
    import dataclasses

    import torch

    from .config import DEFAULT_CONFIG, reference_exact_config
    from .io.audio import StreamingEncoder
    from .runtime.engine import TTSEngine
    from .utils.profiling import FrameMeter, device_trace

    device = args.device
    if device.startswith("cuda") and not torch.cuda.is_available():
        print("no CUDA device (torch.cuda.is_available() is False); pass "
              "--device cpu to run on the CPU", file=sys.stderr)
        return 1
    if args.compile_cache is not None:
        from .utils.profiling import enable_compile_cache
        enable_compile_cache(args.compile_cache)
    dtype = torch.bfloat16 if device.startswith("cuda") else torch.float32
    cfg0 = (reference_exact_config(DEFAULT_CONFIG) if args.reference_exact
            else DEFAULT_CONFIG)
    if args.fuse_insert or args.megalayer:
        cfg0 = dataclasses.replace(cfg0, backbone=dataclasses.replace(
            cfg0.backbone, fuse_insert=True, use_megalayer=args.megalayer))
    model = model_dir(args)
    qkw = dict(quantize=args.quantize, quantize_kv=args.quantize_kv,
               quantize_convs=args.quantize_convs)
    if args.load_cache:
        # the model directory, when given, provides tokenizer and voices
        engine = TTSEngine.from_params_cache(
            args.load_cache, cfg0, model_path=args.model,
            dtype=dtype, device=device, seed=seed, **qkw)
        if args.random_weights:  # no model directory: a synthetic voice
            from .io.params import random_voice_prompt
            voice = random_voice_prompt(engine.cfg)
        else:
            voice = args.voice
    elif args.random_weights or not any(
            os.path.exists(os.path.join(model, "tts_b6369a24." + ext))
            for ext in ("safetensors", "gguf")):
        # no checkpoint: random weights and a random voice, as the JAX
        # package's CLI does
        if not args.random_weights:
            print(f"note: no checkpoint under {model}; using random "
                  "weights", file=sys.stderr)
        from .io.params import random_params, random_voice_prompt
        params, cfg = random_params(cfg0, dtype=dtype, device=device)
        engine = TTSEngine(params=params, cfg=cfg, dtype=dtype,
                           device=device, seed=seed, **qkw)
        voice = random_voice_prompt(cfg)
    else:
        engine = TTSEngine(model_path=model, cfg=cfg0, dtype=dtype,
                           device=device, seed=seed, **qkw)
        voice = args.voice
    if args.save_cache:
        engine.save_params_cache(args.save_cache,
                                 gguf_quantize=args.gguf_quantize)
        print(f"wrote params cache: {args.save_cache}")
        if text is None and not (args.interactive or args.serve):
            return 0
    weights = (f", {_WEIGHTS[args.quantize]} weights" if args.quantize
               else "") + (", int8 KV cache" if args.quantize_kv else "") \
        + (", quantized convs" if args.quantize and args.quantize_convs
           else "") \
        + (", reference-exact" if args.reference_exact else "")
    print(f"seed: {engine.seed}")
    print(f"device: {engine.device} ({dtype}{weights})")
    if args.serve:
        return _serve(engine, args, voice, temp)
    if args.batch > 1:
        return _batch(engine, args, text, voice, temp)

    stream = engine.open_stream(voice, temp)
    player = None
    if args.play:
        from .runtime.player import AudioPlayer
        player = AudioPlayer(engine.sample_rate,
                             frame_size=engine.frame_size)
    meter = FrameMeter(engine.cfg.mimi.frame_rate)
    out_rate = args.out_rate or engine.sample_rate
    writer = (StreamingEncoder(args.output, out_rate)
              if args.output else None)
    out_rs = None
    if writer is not None and out_rate != engine.sample_rate:
        from .io.audio_in import StreamingResampler
        out_rs = StreamingResampler(engine.sample_rate, out_rate)
    trace_cm = (device_trace(args.profile, engine.device) if args.profile
                else contextlib.nullcontext())

    def on_frame(frame):
        if writer is not None:
            writer.write(out_rs.process(frame) if out_rs is not None
                         else frame)
        if player is not None:
            player.play(frame)

    with trace_cm:
        if args.interactive:
            # stdin lines as they arrive, then the rest on EOF
            frames = 0
            for line in sys.stdin:
                stream.send(line)
                frames += pump(stream, meter, on_frame)
            stream.flush()
            frames += pump(stream, meter, on_frame)
        else:
            frames = feed(stream, meter, text, on_frame)

    if player is not None:
        player.close()
    if writer is not None:
        if out_rs is not None:
            writer.write(out_rs.flush())
        writer.close()
        print(f"wrote {args.output}: "
              f"{frames * engine.frame_size / engine.sample_rate:.2f}s")
    if args.profile:
        print(f"wrote trace: {os.path.join(args.profile, 'trace.json')}")
    rep = meter.report()
    print(f"done generating. {rep['wall_s']:.3f}")
    print(f"frame count: {frames:4d} frames")
    print(f"frame rate:  {rep['frames_per_second']:f} frames/s")
    if args.json:
        print(json.dumps({
            "metric": "frames_per_second",
            "value": rep["frames_per_second"], "unit": "frames/s",
            "frames": frames, "total_s": rep["wall_s"], "rtf": rep["rtf"],
            "ttfa_ms": rep["ttfa_ms"],
        }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
