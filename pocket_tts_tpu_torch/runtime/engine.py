"""TTSEngine: model + host-side orchestration (solo synthesis).

Counterpart of `pocket_tts_tpu/runtime/engine.py`: `TTSEngine.synthesize`
(offline, sentence by sentence) and `Stream.send/flush/receive`
(streaming), with the same token, prompt and scan buckets and the same
per-sentence KV capacity (the smallest 128-multiple that covers prompt,
text and max frames), so the KV length S varies per sentence.

Everything runs on `device` ("cuda", the default, launches the
hand-written kernels on the card; "cpu" runs their plain versions).
`quantize="int8"` (or "q8") quantizes the linear weights to int8 after
load, as the JAX engine does, and "int4" (or "q4") to packed int4 with
per-channel scales, "q4_0" with 32-row K-grouped bf16 scales; the decode
step then runs kernels K4a (K4b), K5a, K5b and K6 beside K1-K3.
`quantize_kv=True` keeps the backbone's KV cache in int8 with per-row
scales (K1's int8-KV variant solo, K7's at batch), the JAX engine's
serving-throughput mode. The engine runs the cfg it is given, as the JAX
engine does: `backbone.use_megalayer` (kernel K8 per quantized decode
layer), `backbone.use_bilayer` (kernel K5c, int4 weights) and
`mimi.transformer.quantize_kv` (the int8 mimi ring, K2's int8 variant)
come from the cfg.
`save_params_cache` / `from_params_cache` write and read the JAX
package's safetensors params cache. Noise comes from a
torch.Generator on that device, seeded from the engine seed: it does not
reproduce jax.random, so the two packages agree only at temp 0 or when the
same noise is fed to both (`_draw_noise` is the single place it is drawn).
The batched paths (runtime/batched.py, runtime/server.py) draw each
request's noise from a seed of its own (`request_seed`).
"""
from __future__ import annotations

import dataclasses
import os
from collections import deque
from typing import Optional

import numpy as np
import torch

from ..config import check_supported
from ..io import params as params_io
from ..io.quant import (cast_floats, load_params_cache, quantize_params,
                        save_params_cache)
from ..models import backbone, seanet, tts
from ..ops import fused_layer, fused_step
from ..ops.basic import slice_layer_params
from ..ops.seanet_frame import prep_weights
from ..text.preprocess import (StrProcessor, count_words,
                               prepare_text_prompt, split_into_best_sentences)
from ..text.tokenizer import load_tokenizer

DEFAULT_VOICES = ["alba", "azelma", "cosette", "eponine", "fantine",
                  "javert", "jean", "marius"]

_TOKEN_BUCKETS = (16, 32, 64, 128, 256)
_PROMPT_BUCKET = 128
_SCAN_BUCKET = 25  # frames (2 s of audio) granularity for the offline loop
MAX_SENTENCE_TOKENS = 50


def _device(device) -> torch.device:
    """The engine's device: "cuda" when None; raises when that is the card
    and there is none."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "TTSEngine: no CUDA device (torch.cuda.is_available() is "
            "False); pass device='cpu' to run on the CPU")
    return device


def _has_quantized_leaves(tree) -> bool:
    if isinstance(tree, dict):
        return ("q" in tree or "q4" in tree
                or any(_has_quantized_leaves(v) for v in tree.values()))
    if isinstance(tree, (list, tuple)):
        return any(_has_quantized_leaves(v) for v in tree)
    return False


def _bucket(n: int, buckets=_TOKEN_BUCKETS) -> int:
    for b in buckets:
        if n <= b:
            return b
    raise ValueError(f"conditioning too long: {n} tokens (max {buckets[-1]})")


class TTSEngine:
    def __init__(self, model_path: Optional[str] = None,
                 params: Optional[dict] = None, cfg=None,
                 dtype: torch.dtype = torch.float32, device=None,
                 seed: int = 0, tokenizer=None,
                 quantize: Optional[str] = None, quantize_kv: bool = False,
                 quantize_convs: bool = False,
                 allow_mock_tokenizer: bool = False):
        """Load weights onto `device` ("cuda" when None; it raises when
        there is no card, and running on the CPU takes device="cpu").
        params: a tree already on that device (with its cfg), or None to
        load `tts_b6369a24.safetensors` under model_path. quantize: None,
        "int8" or "q8" (per-channel int8 linear weights), "int4" or "q4"
        (per-channel int4), "q4_0" (int4 with 32-row K-grouped scales),
        quantized after load (a tree that is quantized already keeps its
        quantized leaves). quantize_convs (with quantize): the SEANet
        decoder's large convs quantized too, per output channel whatever
        the mode; the decoder then runs its chain with K4a / K4b in place
        of K3. quantize_kv: the backbone's KV cache in int8
        with per-row scales, as the JAX engine applies it (backbone only:
        the int8 mimi ring is the cfg's `mimi.transformer.quantize_kv`);
        the serving-throughput mode. q4_0 weights with
        `backbone.use_megalayer` raise NotImplementedError (kernel K8
        takes no K-grouped scales) unless `backbone.use_pallas_attn` is
        False (the plain route runs no K8). Without params it loads
        `tts_b6369a24.safetensors` under model_path, or
        `tts_b6369a24.gguf` when there is no safetensors file."""
        if quantize not in (None, "int8", "q8", "int4", "q4", "q4_0"):
            raise ValueError(f"unknown quantization: {quantize}")
        self.device = _device(device)
        self.model_path = model_path
        if params is None:
            ckpt = os.path.join(model_path or ".", "tts_b6369a24.safetensors")
            gguf = os.path.join(model_path or ".", "tts_b6369a24.gguf")
            if not os.path.exists(ckpt) and os.path.exists(gguf):
                ckpt = gguf
            params, cfg = params_io.load_checkpoint(ckpt, cfg, dtype,
                                                    self.device)
        if cfg is None:
            raise ValueError("cfg is required with params")
        if quantize_kv:
            cfg = dataclasses.replace(cfg, backbone=dataclasses.replace(
                cfg.backbone, quantize_kv=True))
        check_supported(cfg)
        if quantize:
            params = quantize_params(params, bits=4 if "4" in quantize else 8,
                                     convs=quantize_convs,
                                     group=32 if quantize == "q4_0" else 0)
        layer0 = slice_layer_params(params["layers"], 0)
        if (cfg.backbone.use_megalayer
                and cfg.backbone.use_pallas_attn is not False
                and fused_layer.supported(layer0)
                and not fused_step.supported(layer0)):
            raise NotImplementedError(
                "q4_0 (K-grouped) weights with backbone.use_megalayer: the "
                "megalayer kernel K8 takes no K-grouped scales (the JAX "
                "package's fused_step.supported excludes them); use int4 or "
                "int8 weights, or leave use_megalayer off")
        self.params = params
        self.cfg = cfg
        self.dtype = dtype
        self.quantized = _has_quantized_leaves(params)
        # K3's weight layouts, built once (the card path reads them); a
        # decoder with quantized convs runs no K3
        decoder = params["mimi"]["decoder"]
        self.seanet_weights = (
            prep_weights(decoder, cfg.mimi.seanet)
            if self.device.type == "cuda" and not seanet.quantized(decoder)
            else None)
        self.set_seed(seed)
        if tokenizer is None:
            tok_path = (os.path.join(model_path, cfg.lut.tokenizer_path)
                        if model_path is not None else None)
            tokenizer = load_tokenizer(tok_path, cfg.lut.n_bins,
                                       allow_mock=allow_mock_tokenizer)
        self.tokenizer = tokenizer
        self.prompt_slot_budget = min(256, cfg.backbone.kv_capacity)

    # -- identity ----------------------------------------------------------
    @property
    def sample_rate(self) -> int:
        return self.cfg.mimi.sample_rate

    @property
    def frame_size(self) -> int:
        return self.cfg.mimi.frame_size

    def save_params_cache(self, path: str, gguf_quantize=None):
        """Write the (possibly quantized) params tree to a params cache
        that either package loads: safetensors, or GGUF for a `.gguf` path
        (gguf_quantize: None, "q8_0", "q4_0", "q8_k" or "q4_k" block
        quantization of its large float tensors)."""
        save_params_cache(self.params, path, gguf_quantize=gguf_quantize)

    @classmethod
    def from_params_cache(cls, path: str, cfg, **kw):
        """An engine on the params of a cache file written by either
        package (kw as for the constructor: device, dtype, seed, ...); the
        float leaves take the engine's dtype (`io.quant.cast_floats`)."""
        params = load_params_cache(path, _device(kw.get("device")))
        return cls(params=cast_floats(params, kw.get("dtype", torch.float32)),
                   cfg=cfg, **kw)

    def set_seed(self, seed: int):
        self.seed = seed
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        self._requests = 0

    def request_seed(self) -> int:
        """The next request's noise seed: the n-th seed of a sequence set by
        the engine seed (the counterpart of the JAX engine's `_next_rng`)."""
        self._requests += 1
        return int(np.random.SeedSequence(
            [self.seed, self._requests]).generate_state(1)[0])

    def _draw_noise(self, temp: float):
        """One frame's N(0, temp) noise, (latent,) in the engine dtype."""
        n = torch.randn(self.cfg.latent_dim, generator=self.generator,
                        device=self.device, dtype=torch.float32)
        return (float(np.sqrt(np.float32(temp))) * n).to(self.dtype)

    # -- conditioning ------------------------------------------------------
    def prime_voice(self, voice) -> backbone.BackboneState:
        """The reusable voice-conditioned KV prefix. voice: a default-voice
        name, a voice .safetensors path, or a (Tp, d_model) array."""
        if isinstance(voice, str):
            if voice in DEFAULT_VOICES:
                voice = os.path.join(self.model_path or ".", "embeddings",
                                     voice + ".safetensors")
            prompt = params_io.load_voice(voice, self.dtype, self.device)
        else:
            prompt = torch.as_tensor(np.asarray(voice, np.float32)).to(
                device=self.device, dtype=self.dtype)
        n = prompt.shape[0]
        cap = self.cfg.backbone.kv_capacity
        step = min(_PROMPT_BUCKET, max(16, cap // 8))
        tp = _bucket(n, tuple(range(step, cap + 1, step)))
        if tp > self.prompt_slot_budget:
            raise ValueError(
                f"voice prompt needs {tp} slots > prompt_slot_budget "
                f"{self.prompt_slot_budget}; raise it on the engine")
        prompt = torch.cat([prompt, prompt.new_zeros(tp - n, prompt.shape[1])])
        state = backbone.init_state(self.cfg.backbone, self.dtype,
                                    self.device)
        with torch.no_grad():
            return tts.prime_voice(self.params, self.cfg, state, prompt, n)

    def _sentence_capacity(self, token_pad: int, max_steps: int,
                           prompt_slots: Optional[int] = None) -> int:
        """Smallest 128-multiple slot budget covering this sentence."""
        base = (self.prompt_slot_budget if prompt_slots is None
                else prompt_slots)
        need = base + token_pad + max_steps + 8
        return min(-(-need // 128) * 128, self.cfg.backbone.kv_capacity)

    def _prefill_sentence(self, voice_state, text: str):
        """Returns (StreamState, max_steps). The voice state is copied
        (shrunk to the sentence's capacity), never written."""
        ids = self.tokenizer.encode(text)
        n = len(ids)
        tp = _bucket(n)
        max_steps = int((count_words(text) + 2.0) * self.cfg.mimi.frame_rate)
        cap = self._sentence_capacity(tp, max_steps,
                                      prompt_slots=voice_state.end)
        tokens = torch.zeros(tp, dtype=torch.long, device=self.device)
        tokens[:n] = torch.as_tensor(ids, dtype=torch.long)
        with torch.no_grad():
            state = tts.sentence_prefill(
                self.params, self.cfg,
                backbone.shrink_state(voice_state, cap), tokens, n)
        return state, max_steps

    # -- streaming ---------------------------------------------------------
    def open_stream(self, voice, temp: float = 0.6) -> "Stream":
        return Stream(self, self.prime_voice(voice), temp)

    # -- offline -----------------------------------------------------------
    def synthesize_sentence(self, voice_state, text: str, temp: float,
                            frames_after_eos: int) -> np.ndarray:
        """One prepared sentence -> PCM float32; the loop stops as soon as
        EOS + frames_after_eos (or max_steps, or the KV budget) is hit."""
        state, max_steps = self._prefill_sentence(voice_state, text)
        scan_len = -(-max_steps // _SCAN_BUCKET) * _SCAN_BUCKET
        with torch.no_grad():
            pcm = tts.decode_sentence_early_exit(
                self.params, self.cfg, state,
                lambda i: self._draw_noise(temp), frames_after_eos,
                max_steps, scan_len, self.seanet_weights)
        return pcm.reshape(-1).cpu().numpy()

    def synthesize(self, text: str, voice, temp: float = 0.6) -> np.ndarray:
        """Multi-sentence offline synthesis."""
        voice_state = (voice if isinstance(voice, backbone.BackboneState)
                       else self.prime_voice(voice))
        out = []
        for chunk in split_into_best_sentences(self.tokenizer, text):
            prepared, guess = prepare_text_prompt(chunk)
            out.append(self.synthesize_sentence(voice_state, prepared, temp,
                                                guess + 2))
        return np.concatenate(out) if out else np.zeros(0, np.float32)

    def synthesize_to_wav(self, text: str, voice, path: str,
                          temp: float = 0.6):
        from ..io.wav import save_wav
        pcm = self.synthesize(text, voice, temp)
        save_wav(path, pcm, self.sample_rate)
        return pcm


class Stream:
    """Streaming send/flush/receive state machine."""

    def __init__(self, engine: TTSEngine, voice_state, temp: float):
        self.engine = engine
        self.voice_state = voice_state
        self.temp = temp
        self.sproc = StrProcessor()
        self.reset()

    def reset(self):
        self.state: Optional[tts.StreamState] = None
        self.max_gen_len = 0
        self._frames_after_eos = 0
        self._pending: deque = deque()
        self.sproc.reset()

    def send(self, chunk: str):
        """An empty chunk flushes."""
        if chunk == "":
            self.flush()
        else:
            self.sproc.ingest(chunk)

    def flush(self):
        self.sproc.flush()

    def _sentence_init(self, text: str, frames_after_eos: int):
        self.state, self.max_gen_len = self.engine._prefill_sentence(
            self.voice_state, text)
        self._frames_after_eos = frames_after_eos

    def _step(self) -> Optional[np.ndarray]:
        eng = self.engine
        with torch.no_grad():
            pcm, valid = tts.frame_step(
                eng.params, eng.cfg, self.state, eng._draw_noise(self.temp),
                self._frames_after_eos, self.max_gen_len,
                eng.seanet_weights)
        if not valid:
            self.state = None
            return None
        return pcm.cpu().numpy()

    def _enqueue_chunks(self, text: str):
        """Bound a popped sentence to the 50-token budget."""
        eng = self.engine
        if len(eng.tokenizer.encode(text)) <= MAX_SENTENCE_TOKENS:
            self._pending.append(text)
        else:
            self._pending.extend(
                c for c in split_into_best_sentences(
                    eng.tokenizer, text, MAX_SENTENCE_TOKENS) if c)

    def receive(self) -> Optional[np.ndarray]:
        """Next 80 ms PCM frame, or None if no audio is ready."""
        if self.state is not None:
            pcm = self._step()
            if pcm is not None:
                return pcm
        if not self._pending and self.sproc.sentences:
            self._enqueue_chunks(self.sproc.sentences.popleft())
        if self._pending:
            text = self._pending.popleft()
            guess = (3 if count_words(text) <= 4 else 1) + 2
            self._sentence_init(text, guess)
            pcm = self._step()
            if pcm is not None:
                return pcm
        return None
