"""One-command real-weights A/B runner, for the PyTorch port.

    python -m pocket_tts_tpu_torch.ab --model-dir DIR [-o OUT] [--no-verify]
        [-d DEVICE]

Counterpart of `pocket_tts_tpu/ab.py`, the same pipeline: verify the model
directory against the release manifest (io/fetch.py), load the real
tokenizer and weights, switch to the reference-exact numerics (temp 0,
seed 0, tanh GELU, -1e5 mask, 250-slot mimi ring:
config.reference_exact_config), write per-stage activation probes (tensor
sums) and the per-weight quantization errors to OUT/ab_probes.json, and
the synthesized sentence to OUT/ab_out.wav. The engine runs in float32
on DEVICE ("cuda" by default; "cpu" runs the plain versions), so the
probes of the card and of the CPU compare directly.

Probe protocol (every sum in float32 over the whole tensor), the JAX
runner's keys:
  voice_kv_sum[l]     backbone k-cache sum per layer after voice priming
  prefill_kv_sum[l]   the same after the sentence's text prefill
  frame[i].latent_sum the sampled latent's sum at decode step i (temp 0)
  frame[i].eos        whether the EOS head fired at step i
  frame[i].pcm_sum    the sum of the frame's 1920 samples
  quant_rel_error_int4 / _int8 / _q4_0
                      io.quant.quantization_error_report(convs=True) of
                      the loaded weights: per-channel int4, int8, and int4
                      with 32-row groups
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

AB_TEXT = "The quick brown fox jumped over the sleeping dog."


def stage_probes(eng, voice, text: str, n_frames: int = 8) -> dict:
    """Per-stage activation sums for one reference-exact sentence."""
    import torch
    from .models import flow_lm, mimi
    from .text.preprocess import prepare_text_prompt

    def tsum(x):
        return float(x.float().sum())

    probes = {"text": text, "temp": 0.0, "seed": eng.seed}
    with torch.no_grad():
        vs = eng.prime_voice(voice)
        probes["voice_kv_sum"] = [tsum(k) for k in vs.k]
        probes["voice_end"] = int(vs.end)

        prepared, _ = prepare_text_prompt(text)
        state, _ = eng._prefill_sentence(vs, prepared)
        probes["prefill_kv_sum"] = [tsum(k) for k in state.flow.k]
        probes["prefill_end"] = int(state.flow.end)

        frames = []
        prev = state.prev_latent
        zero_noise = torch.zeros_like(prev)
        for _ in range(n_frames):
            # decode_step advances the backbone state by the step's row
            _, latent, is_eos = flow_lm.decode_step(
                eng.params, eng.cfg, state.flow, prev, zero_noise)
            _, pcm = mimi.decode_frame(
                eng.params["mimi"], eng.cfg.mimi, state.mimi,
                flow_lm.denormalize(eng.params, latent), eng.cfg.gelu_approx,
                eng.seanet_weights)
            frames.append({"latent_sum": tsum(latent), "eos": bool(is_eos),
                           "pcm_sum": tsum(pcm)})
            prev = latent
    probes["frame"] = frames
    return probes


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="pocket-tts-torch-ab", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--model-dir", required=True,
                   help="release layout dir (tts_b6369a24.safetensors or "
                        ".gguf, tokenizer.model, embeddings/)")
    p.add_argument("-o", "--out",
                   default=os.path.join(tempfile.gettempdir(),
                                        "pocket_tts_ab"),
                   help="output directory for the wav and the probes JSON")
    p.add_argument("-d", "--device", default="cuda",
                   help="torch device: cuda (default) or cpu")
    p.add_argument("--text", default=AB_TEXT)
    p.add_argument("--voice", default="cosette")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--frames", type=int, default=8,
                   help="decode steps to probe")
    p.add_argument("--no-verify", "--skip-verify", dest="skip_verify",
                   action="store_true",
                   help="skip the manifest sha256 check (fixture dirs)")
    args = p.parse_args(argv)

    if not args.skip_verify:
        from .io.fetch import verify_model_dir
        status = verify_model_dir(args.model_dir)
        bad = {k: v for k, v in status.items() if v != "ok"}
        for rel, st in status.items():
            print(f"  {st:8s} {rel}")
        if bad:
            print(f"model dir failed verification: {bad}", file=sys.stderr)
            return 2

    from .config import reference_exact_config
    from .io.quant import quantization_error_report
    from .io.wav import save_wav
    from .runtime.engine import TTSEngine

    # load with the dims the checkpoint fixes, then switch to the
    # reference-exact numerics (shape-free but for the mimi ring's
    # capacity, which lives in the state)
    eng0 = TTSEngine(model_path=args.model_dir, seed=args.seed,
                     device=args.device)
    eng = TTSEngine(params=eng0.params, cfg=reference_exact_config(eng0.cfg),
                    tokenizer=eng0.tokenizer, seed=args.seed,
                    model_path=args.model_dir, device=args.device)

    os.makedirs(args.out, exist_ok=True)
    probes = stage_probes(eng, args.voice, args.text, args.frames)
    for key, kw in (("int4", dict(bits=4)), ("int8", dict(bits=8)),
                    ("q4_0", dict(bits=4, group=32))):
        probes[f"quant_rel_error_{key}"] = quantization_error_report(
            eng.params, convs=True, **kw)
    probes_path = os.path.join(args.out, "ab_probes.json")
    with open(probes_path, "w") as f:
        json.dump(probes, f, indent=1)

    pcm = eng.synthesize(args.text, args.voice, temp=0.0)
    wav_path = os.path.join(args.out, "ab_out.wav")
    save_wav(wav_path, pcm, eng.sample_rate)
    print(f"wrote {wav_path}: {pcm.size / eng.sample_rate:.2f}s "
          f"({pcm.size // eng.frame_size} frames)")
    print(f"wrote {probes_path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
