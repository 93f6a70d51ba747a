"""Plain float32 reference of Pocket TTS, teacher-forced on served latents.

Written from the model's equations in plain PyTorch, with no import of the
program under test: it takes the benchmark's own checkpoint (the flat dict
of `weights.py`, torch layouts, keys of `tts_b6369a24.safetensors`), a
request's voice prompt, token ids and noise, and the latents the server
emitted, and gives for every served frame what the model computes there:

- the FlowLM backbone over [voice rows, text rows, one row a frame] in one
  causal pass (interleaved RoPE on the checkpoint's unpermuted q/k
  columns), the EOS logit and the flow net's latent of each frame, each
  frame conditioned on the SERVED latents before it;
- the Mimi decoder over the served latents: quantizer projection, the x16
  depthwise transposed conv, the 2-layer transformer (a 250-step window
  fenced by the 256-slot ring the decoder keeps), and the SEANet decoder
  as non-streaming causal convs, through to the PCM.

Precision is a `Precision`: the configuration's own (`configured`: float32
arithmetic on the weights as the configuration stores them, int4
per-channel linears worked out again from the float weights, and int8 KV
rows with one absmax scale a row where the configuration keeps them), or
one step below it (`lower`, the control: fp8 e4m3 wherever the
configuration computes in bf16, so the inputs of every matrix product and
the latents and PCM frames a stage hands on; fp8 weights in place of bf16
ones, int4 KV rows in place of int8 ones, fp8 ones in place of bf16 ones).
TF32 is switched off while it runs.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import re
from typing import Dict

import torch
import torch.nn.functional as F

E4M3_MAX = 448.0


def fp8_rows(x: torch.Tensor) -> torch.Tensor:
    """x rounded to fp8 e4m3 with one scale per row (last axis)."""
    s = (x.abs().amax(-1, keepdim=True) / E4M3_MAX).clamp_min(1e-30)
    return (x / s).to(torch.float8_e4m3fn).float() * s


def int_rows(x: torch.Tensor, qmax: float) -> torch.Tensor:
    """x quantized to integers in [-qmax, qmax] with one absmax scale a row
    (last axis), and dequantized."""
    s = (x.abs().amax(-1, keepdim=True) / qmax).clamp_min(1e-12)
    return torch.clamp(torch.round(x / s), -qmax, qmax) * s


def int4_channels(w: torch.Tensor) -> torch.Tensor:
    """A linear's (out, in) weight quantized to int4 with one absmax scale
    per output channel (scale = amax / 7, round half to even, clip to
    +-7), dequantized."""
    amax = w.abs().amax(-1, keepdim=True)
    # a correctly rounded division, as the configuration's quantizer's
    # (on the card, dividing by a Python number multiplies by its
    # reciprocal, which moves some weights one step)
    scale = torch.where(amax > 0, amax / torch.full_like(amax, 7.0),
                        torch.ones_like(amax))
    return torch.clamp(torch.round(w / scale), -7.0, 7.0) * scale


@dataclasses.dataclass(frozen=True)
class Precision:
    """weights: "float" or "int4" (per-channel linears) or "fp8";
    kv / mimi_kv: "float", "int8", "int4" or "fp8" rows; acts: "float" or
    "fp8" inputs to every matrix product."""
    weights: str = "float"
    kv: str = "float"
    mimi_kv: str = "float"
    acts: str = "float"

    def act(self, x):
        return fp8_rows(x) if self.acts == "fp8" else x

    def out(self, x):
        """What a stage hands on (latents, PCM frames) in the working
        type: float32 as computed, or fp8 rows for the control."""
        return self.act(x)

    @staticmethod
    def rows(kind: str, x):
        if kind == "int8":
            return int_rows(x, 127.0)
        if kind == "int4":
            return int_rows(x, 7.0)
        if kind == "fp8":
            return fp8_rows(x)
        return x


_LOWER = {"float": "fp8", "int8": "int4", "fp8": "fp8", "int4": "int4"}


def configured(spec: dict) -> Precision:
    """The precision a configuration file's "reference" entry states."""
    return Precision(weights=spec["weights"], kv=spec["kv"],
                     mimi_kv=spec["mimi_kv"], acts="float")


def lower(spec: dict) -> Precision:
    """One step below the configured precision: the control."""
    return Precision(weights=_LOWER[spec["weights"]], kv=_LOWER[spec["kv"]],
                     mimi_kv=_LOWER[spec["mimi_kv"]], acts="fp8")


@contextlib.contextmanager
def no_tf32():
    m, c = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = m
        torch.backends.cudnn.allow_tf32 = c


# linears the configuration quantizes to int4: a weight of at least
# 64 x 64 elements, counted over its layers where the model stacks them
# (then only with 128 outputs or more), with an even input width; not the
# time embedding, which is folded into one constant from the float
# weights at load
_MIN_QUANT = 64 * 64
_STACKED = ("flow_lm.transformer.layers.", "flow_lm.flow_net.res_blocks.",
            "mimi.decoder_transformer.transformer.layers.")


def _quantized(key: str, w, stacks: dict) -> bool:
    out, k = w.shape
    if k % 2 or "time_embed" in key:
        return False
    for prefix, n in stacks.items():
        if key.startswith(prefix):
            return n * out * k >= _MIN_QUANT and out >= 128
    return out * k >= _MIN_QUANT


class Model:
    """The checkpoint's weights at a precision, on one device, float32."""

    def __init__(self, flat: Dict[str, torch.Tensor], dims: dict,
                 prec: Precision, device):
        self.prec = prec
        self.dims = dims
        self.device = device
        self.w = {}
        stacks = {g: _count(flat, g) for g in _STACKED}
        for k, v in flat.items():
            t = torch.as_tensor(v).to(device=device, dtype=torch.float32)
            if k.endswith(".weight") and t.dim() == 2 and self._linear(k):
                if prec.weights == "int4" and _quantized(k, t, stacks):
                    t = int4_channels(t)
                elif prec.weights == "fp8":
                    t = fp8_rows(t)
            elif prec.weights == "fp8" and k.endswith(".weight") \
                    and t.dim() == 3 and "upsample" not in k:
                t = fp8_rows(t.reshape(t.shape[0], -1)).reshape(t.shape)
            self.w[k] = t
        self.n_layers = _count(flat, "flow_lm.transformer.layers.")
        self.n_flow = _count(flat, "flow_lm.flow_net.res_blocks.")
        self.n_mimi = _count(flat,
                             "mimi.decoder_transformer.transformer.layers.")
        with torch.no_grad():
            self.time_cond = self._time_cond()

    @staticmethod
    def _linear(key: str) -> bool:
        return not key.startswith("mimi.decoder.") and "conditioner" not in key

    # -- pieces ------------------------------------------------------------
    def lin(self, name, x):
        w = self.w[name + ".weight"]
        y = self.prec.act(x) @ w.T
        b = self.w.get(name + ".bias")
        return y if b is None else y + b

    def ln(self, name, x, eps):
        y = F.layer_norm(x, x.shape[-1:], eps=eps)
        if name is None:
            return y
        s, b = self.w.get(name + ".weight"), self.w.get(name + ".bias")
        if s is not None:
            y = y * s
        if b is not None:
            y = y + b
        return y

    def _time_embed(self, j, t):
        pre = f"flow_lm.flow_net.time_embed.{j}."
        args = self.w[pre + "freqs"].reshape(-1) * t
        e = torch.cat([torch.cos(args), torch.sin(args)], -1)[None]
        h = self.lin(pre + "mlp.2", F.silu(self.lin(pre + "mlp.0", e)))
        xc = h - h.mean(-1, keepdim=True)
        var = (xc * xc).sum(-1, keepdim=True) / (h.shape[-1] - 1)
        return h * torch.rsqrt(var + 1e-5) * self.w[pre + "mlp.3.alpha"]

    def _time_cond(self):
        return 0.5 * (self._time_embed(1, 1.0) + self._time_embed(0, 0.0))

    @staticmethod
    def rope(x, pos, max_period):
        """Interleaved rotary embedding: x (T, H, D), pairs (2i, 2i+1)."""
        d = x.shape[-1]
        half = d // 2
        freqs = torch.exp(torch.arange(half, device=x.device,
                                       dtype=torch.float32)
                          * (-math.log(max_period) / half))
        ang = pos.float()[:, None] * freqs                   # (T, D/2)
        c, s = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
        re, im = x[..., 0::2], x[..., 1::2]
        out = torch.empty_like(x)
        out[..., 0::2] = re * c - im * s
        out[..., 1::2] = re * s + im * c
        return out

    def attention(self, q, k, v, allowed, block: int = 2048):
        """q (T, H, D), k/v (S, H, D), allowed (T, S) bool -> (T, H*D),
        in blocks of query rows."""
        t, h, d = q.shape
        outs = []
        for a in range(0, t, block):
            qb = self.prec.act(q[a:a + block])
            lg = torch.einsum("thd,shd->hts", qb, k) / math.sqrt(d)
            lg = lg.masked_fill(~allowed[a:a + block][None], float("-inf"))
            pw = torch.softmax(lg, -1)
            outs.append(torch.einsum("hts,shd->thd", self.prec.act(pw), v))
        return torch.cat(outs).reshape(t, h * d)

    # -- FlowLM ------------------------------------------------------------
    def backbone(self, rows):
        """rows (T, d) at positions 0..T-1, causal -> out-normed (T, d)."""
        dm = self.dims["d_model"]
        nh = self.dims["num_heads"]
        hd = dm // nh
        t = rows.shape[0]
        pos = torch.arange(t, device=rows.device)
        allowed = pos[None, :] <= pos[:, None]
        x = rows
        for l in range(self.n_layers):
            pre = f"flow_lm.transformer.layers.{l}."
            qkv = self.lin(pre + "self_attn.in_proj",
                           self.ln(pre + "norm1", x, 1e-5))
            q, k, v = qkv.split(dm, -1)
            q = self.rope(q.reshape(t, nh, hd), pos, self.dims["max_period"])
            k = self.rope(k.reshape(t, nh, hd), pos, self.dims["max_period"])
            k = self.prec.rows(self.prec.kv, k.reshape(t, dm))
            v = self.prec.rows(self.prec.kv, v)
            a = self.attention(q, k.reshape(t, nh, hd),
                               v.reshape(t, nh, hd), allowed)
            x = x + self.lin(pre + "self_attn.out_proj", a)
            h = self.ln(pre + "norm2", x, 1e-5)
            x = x + self.lin(pre + "linear2",
                             F.gelu(self.lin(pre + "linear1", h)))
        return self.ln("flow_lm.out_norm", x, 1e-5)

    def flow(self, c, noise):
        """latent = noise + flow_net(c, noise): c (N, d), noise (N, lat)."""
        pre = "flow_lm.flow_net."
        h = self.lin(pre + "input_proj", noise)
        y = self.time_cond + self.lin(pre + "cond_embed", c)
        for i in range(self.n_flow):
            b = f"{pre}res_blocks.{i}."
            shift, scale, gate = self.lin(b + "adaLN_modulation.1",
                                          F.silu(y)).chunk(3, -1)
            m = self.ln(b + "in_ln", h, 1e-6) * (1 + scale) + shift
            m = self.lin(b + "mlp.2", F.silu(self.lin(b + "mlp.0", m)))
            h = h + gate * m
        f = pre + "final_layer."
        shift, scale = self.lin(f + "adaLN_modulation.1",
                                F.silu(y)).chunk(2, -1)
        h = self.ln(f + "norm_final", h, 1e-6) * (1 + scale) + shift
        return self.prec.out(noise + self.lin(f + "linear", h))

    def flow_lm(self, voice, tokens, latents, noise):
        """voice (nv, d), tokens (n_tok,) long, latents (n, lat) served,
        noise (n, lat) -> (eos logits (n,), latents (n, lat)): frame j
        conditioned on the served latents before it."""
        emb = self.w["flow_lm.conditioner.embed.weight"]
        text = emb[tokens.clamp(0, emb.shape[0] - 1)]
        prev = torch.cat([self.w["flow_lm.bos_emb"].reshape(1, -1),
                          latents[:-1]])
        frames = self.lin("flow_lm.input_linear", prev)
        h = self.backbone(torch.cat([voice, text, frames]))[-len(latents):]
        eos = self.lin("flow_lm.out_eos", h)[:, 0]
        return eos, self.flow(h, noise)

    # -- Mimi ----------------------------------------------------------------
    def mimi_transformer(self, x):
        """x (16 n, d) rows of n frames -> (16 n, d)."""
        dims = self.dims
        dm, nh = dims["mimi_dim"], dims["mimi_heads"]
        hd = dm // nh
        t = x.shape[0]
        step = dims["upsample_stride"]
        pos = torch.arange(t, device=x.device)
        block_end = (pos // step + 1) * step
        pq, pk = pos[:, None], pos[None, :]
        # the window, fenced by the ring: a query sees the key rows still
        # held in the ring after its frame's rows were inserted
        allowed = ((pk <= pq) & (pq - pk < dims["mimi_context"])
                   & (pk >= block_end[:, None] - dims["mimi_capacity"]))
        for l in range(self.n_mimi):
            pre = f"mimi.decoder_transformer.transformer.layers.{l}."
            qkv = self.lin(pre + "self_attn.in_proj",
                           self.ln(pre + "norm1", x, 0.0))
            q, k, v = qkv.split(dm, -1)
            q = self.rope(q.reshape(t, nh, hd), pos, dims["mimi_max_period"])
            k = self.rope(k.reshape(t, nh, hd), pos, dims["mimi_max_period"])
            k = self.prec.rows(self.prec.mimi_kv, k.reshape(t, dm))
            v = self.prec.rows(self.prec.mimi_kv, v)
            a = self.attention(q, k.reshape(t, nh, hd), v.reshape(t, nh, hd),
                               allowed)
            x = x + self.w[pre + "layer_scale_1.scale"] * self.lin(
                pre + "self_attn.out_proj", a)
            h = self.ln(pre + "norm2", x, 0.0)
            x = x + self.w[pre + "layer_scale_2.scale"] * self.lin(
                pre + "linear2", F.gelu(self.lin(pre + "linear1", h)))
        return x

    def conv(self, name, x, kind="conv", stride=1):
        """Causal conv (zero history) or transposed conv (right tail
        dropped) over x (C, T)."""
        w = self.w[name + ".weight"]
        b = self.w.get(name + ".bias")
        x = self.prec.act(x.T).T
        k = w.shape[-1]
        if kind == "conv":
            return F.conv1d(F.pad(x[None], (k - 1, 0)), w, b)[0]
        y = F.conv_transpose1d(x[None], w, b, stride=stride)[0]
        return y[:, : x.shape[-1] * stride]

    @staticmethod
    def elu(x):
        return F.elu(x)

    def seanet(self, z):
        """z (T, C) -> pcm (T * total_stride,)."""
        x = self.elu(self.conv("mimi.decoder.model.0.conv", z.T))
        for c, r, s in zip((2, 5, 8), (3, 6, 9), self.dims["strides"]):
            x = self.conv(f"mimi.decoder.model.{c}.convtr", x, "tr", s)
            v = self.conv(f"mimi.decoder.model.{r}.block.1.conv",
                          self.elu(x))
            x = x + self.conv(f"mimi.decoder.model.{r}.block.3.conv",
                              self.elu(v))
            x = self.elu(x)
        return self.conv("mimi.decoder.model.11.conv", x)[0]

    def mimi(self, latents):
        """Served latents (n, lat) -> pcm (n, frame)."""
        n = latents.shape[0]
        z = latents * self.w["flow_lm.emb_std"] + self.w["flow_lm.emb_mean"]
        wq = self.w["mimi.quantizer.output_proj.weight"][:, :, 0]
        u = self.prec.act(z) @ wq.T                           # (n, C)
        wu = self.w["mimi.upsample.convtr.convtr.weight"][:, 0, :]  # (C, K)
        k = wu.shape[-1]
        s = self.dims["upsample_stride"]
        y = u[:, None, :] * wu.T[None]                        # (n, K, C)
        emb = y[:, :k - s].clone()
        emb[1:] += y[:-1, k - s:]
        b = self.w.get("mimi.upsample.convtr.convtr.bias")
        if b is not None:
            emb = emb + b
        x = self.mimi_transformer(emb.reshape(n * (k - s), -1))
        return self.prec.out(self.seanet(x).reshape(n, -1))


def _count(flat, prefix) -> int:
    pat = re.compile(re.escape(prefix) + r"(\d+)\.")
    return max((int(m.group(1)) + 1 for m in map(pat.match, flat) if m),
               default=0)


def dims_of(model_file: dict) -> dict:
    """The sizes the reference reads, from a configuration file's
    "model" entry."""
    m = model_file["model"]
    return {
        "d_model": m["backbone"]["d_model"],
        "num_heads": m["backbone"]["num_heads"],
        "max_period": m["backbone"]["max_period"],
        "mimi_dim": m["mimi"]["dim"],
        "mimi_heads": m["mimi"]["transformer"]["num_heads"],
        "mimi_context": m["mimi"]["transformer"]["context"],
        "mimi_capacity": m["mimi"]["transformer"]["capacity"],
        "mimi_max_period": m["mimi"]["transformer"]["max_period"],
        "upsample_stride": m["mimi"]["upsample_stride"],
        "strides": tuple(s["stride"] for s in m["mimi"]["seanet"]["stages"]),
    }


def run_request(model: Model, voice, tokens, latents, noise):
    """(eos logits (n,), latents (n, lat), pcm (n, frame)) of one request,
    teacher-forced on its served latents."""
    with torch.no_grad(), no_tf32():
        eos, lat = model.flow_lm(voice, tokens, latents, noise)
        pcm = model.mimi(latents)
    return eos, lat, pcm


def prepare_text(text: str):
    """(prepared text, frames after EOS, max frames): strip, merge
    whitespace, capitalise, end with punctuation, pad short prompts with 8
    spaces; 3 frames after EOS up to 4 words, else 1 (plus the 2 every
    request adds); max frames (words + 2) x 12.5."""
    text = " ".join(text.strip().split())
    words = len(text.split())
    guess = 3 if words <= 4 else 1
    text = text[0].upper() + text[1:]
    if text[-1].isalnum():
        text += "."
    if words < 5:
        text = "        " + text
    return text, guess + 2, int((words + 2.0) * 12.5)

