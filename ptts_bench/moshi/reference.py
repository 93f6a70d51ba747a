"""Plain float32 reference of Moshi, teacher-forced on a served call.

Written from the model's equations in plain PyTorch, with no import of the
program under test and no cache, batching or kernel: it takes a checkpoint
(a flat dict in the torch layouts and keys of `kyutai/moshiko-pytorch-bf16`
and Mimi's decoder; `Model` reads each tensor as float32 when it uses it),
the tokens a call was served (the text token and the n_q codes drawn at
each step, the user's codes), and gives what the model computes at every
step of the call:

- `temporal`: the 17 token streams of the delayed grid (`grid`), the sum of
  their embeddings at column t - 1 for step t, one causal pass of the
  temporal transformer over all steps (pre-RMSNorm layers in float32 over
  the checkpoint's unpermuted q/k columns with interleaved RoPE, a
  `context`-step window, the SwiGLU MLP), `out_norm` and the text logits;
- `depth`: the depth transformer over each step's sub-steps, each with
  its own linears, causal over the step's sub-steps, teacher-forced on the
  served text token and codes, and every sub-step's logits;
- `mimi`: Mimi's decoder over given codes: the split RVQ (two groups of
  codebooks, each projected 1x1), the x2 depthwise transposed conv, the
  8-layer transformer (LayerNorm, interleaved RoPE, a 250-step window,
  GELU MLP, layer scales), and SEANet as non-streaming causal convs, to
  the PCM.

Departures from Moshi's code, all of form: the codebooks are plain
tables (the checkpoint's `embedding_sum / cluster_usage`), the norms'
`alpha` are (d,), and no sampling is done (the served tokens are given).
A call resumed at a step a > 0 (its first a steps' tokens given, not
served) is compared from step a on, and its PCM from frame a - 1 on,
decoded from silence, as the server decodes it.

Precision is a `Precision`: float32 arithmetic on the weights as stored
(`configured`), the same with every matrix product's inputs and the PCM
rounded to bfloat16 (`bf16_inputs`, the yardstick of the PCM check), or
one step below bfloat16 (`lower`, the control: fp8 e4m3 weights and
product inputs, one scale a row). TF32 is off (module import and
`no_tf32`).
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Dict

import torch
import torch.nn.functional as F

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

E4M3_MAX = 448.0


def fp8_rows(x: torch.Tensor) -> torch.Tensor:
    """x rounded to fp8 e4m3 with one scale per row (last axis)."""
    s = (x.abs().amax(-1, keepdim=True) / E4M3_MAX).clamp_min(1e-30)
    return (x / s).to(torch.float8_e4m3fn).float() * s


@dataclasses.dataclass(frozen=True)
class Precision:
    """weights: "float" or "fp8"; acts: "float", "bf16" or "fp8" inputs to
    every matrix product (and the PCM handed out)."""
    weights: str = "float"
    acts: str = "float"

    def act(self, x):
        if self.acts == "bf16":
            return x.to(torch.bfloat16).float()
        if self.acts == "fp8":
            return fp8_rows(x)
        return x

    def weight(self, w):
        return fp8_rows(w) if self.weights == "fp8" else w


def configured() -> Precision:
    return Precision()


def bf16_inputs() -> Precision:
    return Precision(acts="bf16")


def lower() -> Precision:
    return Precision(weights="fp8", acts="fp8")


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


def grid(dims: dict, text, codes, user):
    """The delayed token grid (steps, streams) of a call of n frames served
    in steps = n + 1 steps: column c holds, for a stream of delay d, the
    token of frame c - d, or the stream's initial token while c - d < 0.
    text (steps,), codes (steps, n_q): the tokens drawn at each step
    (column c's of Moshi's streams are those drawn at step c); user (n,
    n_q): the user's codes by frame."""
    nq, delays = dims["n_q"], dims["delays"]
    steps = text.shape[0]
    g = torch.empty(steps, 1 + 2 * nq, dtype=torch.long, device=text.device)
    c = torch.arange(steps, device=text.device)
    for s, d in enumerate(delays):
        init = dims["text_card"] if s == 0 else dims["card"]
        if s == 0:
            val = text
        elif s <= nq:
            val = codes[:, s - 1]
        else:
            f = (c - d).clamp(0, user.shape[0] - 1)
            val = user[f, s - 1 - nq]
        g[:, s] = torch.where(c - d >= 0, val, torch.full_like(val, init))
    return g


def rope(x, pos, max_period: float):
    """Interleaved RoPE: x (T, H, D), pairs (2i, 2i + 1) rotated by pos *
    max_period^(-2i / D)."""
    d = x.shape[-1]
    freqs = torch.exp(-math.log(max_period) * torch.arange(
        d // 2, device=x.device, dtype=torch.float32) / (d // 2))
    ang = pos.float()[:, None] * freqs[None]                   # (T, D/2)
    c, s = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    re, im = x[..., 0::2], x[..., 1::2]
    return torch.stack([re * c - im * s, re * s + im * c], -1).flatten(-2)


def attend(q, k, v, context: int):
    """Causal attention over a `context`-step window: q, k, v (T, H, D)."""
    t, _, d = q.shape
    i = torch.arange(t, device=q.device)
    delta = i[:, None] - i[None, :]
    ok = (delta >= 0) & (delta < context)
    lg = torch.einsum("thd,shd->hts", q, k) / math.sqrt(d)
    w = torch.softmax(lg.masked_fill(~ok, float("-inf")), -1)
    return torch.einsum("hts,shd->thd", w, v)


class Model:
    """The equations over a checkpoint `flat` at sizes `dims` (the
    configuration file's "model") in precision `prec`."""

    def __init__(self, flat: Dict[str, torch.Tensor], dims: dict,
                 prec: Precision, device):
        self.flat, self.dims, self.prec = flat, dims, prec
        self.device = device

    def w(self, key):
        return self.flat[key].to(self.device).float()

    def lin(self, key, x):
        return self.prec.act(x) @ self.prec.weight(self.w(key)).T

    def rms(self, key, x, eps: float):
        return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) \
            * self.w(key)

    def gating(self, pre, x):
        h = self.lin(pre + "linear_in.weight", x)
        a, b = h.chunk(2, -1)
        return self.lin(pre + "linear_out.weight", F.silu(a) * b)

    # -- the language model -----------------------------------------------
    def temporal(self, g):
        """g: the grid (steps, streams) -> (z (steps, D), text logits
        (steps, text_card)); step t reads column t - 1."""
        dm = self.dims
        steps = g.shape[0]
        inp = torch.empty_like(g)
        inp[0, 0] = dm["text_card"]
        inp[0, 1:] = dm["card"]
        inp[1:] = g[:-1]
        x = self.w("text_emb.weight")[inp[:, 0]]
        for s in range(1, inp.shape[1]):
            x = x + self.w(f"emb.{s - 1}.weight")[inp[:, s]]
        h, d = dm["num_heads"], dm["d_model"] // dm["num_heads"]
        pos = torch.arange(steps, device=x.device)
        eps = dm["norm_eps"]
        for l in range(dm["num_layers"]):
            pre = f"transformer.layers.{l}."
            y = self.rms(pre + "norm1.alpha", x, eps)
            q, k, v = self.lin(pre + "self_attn.in_proj_weight", y).view(
                steps, 3, h, d).unbind(1)
            a = attend(rope(q, pos, dm["max_period"]),
                       rope(k, pos, dm["max_period"]), v, dm["context"])
            x = x + self.lin(pre + "self_attn.out_proj.weight",
                             a.reshape(steps, h * d))
            x = x + self.gating(pre + "gating.",
                                self.rms(pre + "norm2.alpha", x, eps))
        z = self.rms("out_norm.alpha", x, eps)
        return z, self.lin("text_linear.weight", z)

    def depth(self, z, text, codes):
        """Teacher-forced sub-steps: z (steps, D), the drawn text (steps,)
        and codes (steps, n_q) -> logits (steps, n_q, card)."""
        dp = self.dims["depth"]
        steps, n = z.shape[0], dp["steps"]
        eps = self.dims["norm_eps"]
        ys = []
        for k in range(n):
            emb = (self.w("depformer_text_emb.weight")[text] if k == 0
                   else self.w(f"depformer_emb.{k - 1}.weight")[
                       codes[:, k - 1]])
            ys.append(self.lin(f"depformer_in.{k}.weight", z) + emb)
        y = torch.stack(ys, 1)                              # (steps, n, Dd)
        h, d = dp["num_heads"], dp["d_model"] // dp["num_heads"]
        causal = torch.ones(n, n, dtype=torch.bool,
                            device=z.device).tril()
        for l in range(dp["num_layers"]):
            pre = f"depformer.layers.{l}."
            yn = self.rms(pre + "norm1.alpha", y, eps)
            qkv = torch.stack([self.lin(
                pre + f"self_attn.in_projs.{k}.weight", yn[:, k])
                for k in range(n)], 1).view(steps, n, 3, h, d)
            q, kk, vv = qkv.unbind(2)
            lg = torch.einsum("tqhd,tkhd->thqk", q, kk) / math.sqrt(d)
            w = torch.softmax(lg.masked_fill(~causal, float("-inf")), -1)
            a = torch.einsum("thqk,tkhd->tqhd", w, vv).reshape(steps, n,
                                                                h * d)
            y = y + torch.stack([self.lin(
                pre + f"self_attn.out_projs.{k}.weight", a[:, k])
                for k in range(n)], 1)
            yn = self.rms(pre + "norm2.alpha", y, eps)
            y = y + torch.stack([self.gating(pre + f"gating.{k}.", yn[:, k])
                                 for k in range(n)], 1)
        return torch.stack([self.lin(f"linears.{k}.weight", y[:, k])
                            for k in range(n)], 1)

    # -- Mimi -------------------------------------------------------------
    def rvq(self, codes):
        """codes (F, n_q) -> (F, mimi dim)."""
        r = self.dims["rvq"]
        q = "mimi.quantizer."
        book = "._codebook.embedding"
        ns = r["n_semantic"]
        first = sum(self.w(q + f"rvq_first.vq.layers.{k}" + book)[codes[:, k]]
                    for k in range(ns))
        rest = sum(self.w(q + f"rvq_rest.vq.layers.{k - ns}" + book)[
            codes[:, k]] for k in range(ns, r["n_q"]))
        return (self.lin_conv(q + "rvq_first.output_proj.weight", first)
                + self.lin_conv(q + "rvq_rest.output_proj.weight", rest))

    def lin_conv(self, key, x):
        """A 1x1 conv (out, in, 1) as a linear over rows."""
        return self.prec.act(x) @ self.prec.weight(self.w(key)[:, :, 0]).T

    def mimi_transformer(self, x):
        mt = self.dims["mimi"]["transformer"]
        t, dmod = x.shape
        h = mt["num_heads"]
        d = dmod // h
        pos = torch.arange(t, device=x.device)
        for l in range(mt["num_layers"]):
            pre = f"mimi.decoder_transformer.transformer.layers.{l}."
            y = F.layer_norm(x, (dmod,), self.w(pre + "norm1.weight"),
                             self.w(pre + "norm1.bias"), mt["norm_eps"])
            q, k, v = self.lin(pre + "self_attn.in_proj_weight", y).view(
                t, 3, h, d).unbind(1)
            a = attend(rope(q, pos, mt["max_period"]),
                       rope(k, pos, mt["max_period"]), v, mt["context"])
            x = x + self.w(pre + "layer_scale_1.scale") * self.lin(
                pre + "self_attn.out_proj.weight", a.reshape(t, dmod))
            y = F.layer_norm(x, (dmod,), self.w(pre + "norm2.weight"),
                             self.w(pre + "norm2.bias"), mt["norm_eps"])
            x = x + self.w(pre + "layer_scale_2.scale") * self.lin(
                pre + "linear2.weight",
                F.gelu(self.lin(pre + "linear1.weight", y)))
        return x

    def conv(self, key, x, transpose=False, stride=1):
        """A causal conv over x (T, Cin) -> (T * stride, Cout) for a
        transposed one: the checkpoint's (Cout, Cin, K) or (Cin, Cout, K)
        weight, its bias; inputs and weights rounded as the precision
        says (a conv is a matrix product)."""
        w = self.prec.weight(self.w(key + ".weight").flatten(1)).view(
            self.flat[key + ".weight"].shape)
        b = self.w(key + ".bias") if key + ".bias" in self.flat else None
        xi = self.prec.act(x).T[None]                          # (1, C, T)
        k = w.shape[-1]
        if transpose:
            y = F.conv_transpose1d(xi, w, b, stride=stride)
            return y[0, :, : x.shape[0] * stride].T
        return F.conv1d(F.pad(xi, (k - 1, 0)), w, b)[0].T

    def seanet(self, x):
        sc = self.dims["mimi"]["seanet"]
        n = len(sc["stages"])
        x = self.conv("mimi.decoder.model.0.conv", x)
        for i, st in enumerate(sc["stages"]):
            c, r = 3 * i + 2, 3 * i + 3
            x = self.conv(f"mimi.decoder.model.{c}.convtr", F.elu(x),
                          transpose=True, stride=st["stride"])
            v = self.conv(f"mimi.decoder.model.{r}.block.1.conv", F.elu(x))
            x = x + self.conv(f"mimi.decoder.model.{r}.block.3.conv",
                              F.elu(v))
        return self.conv(f"mimi.decoder.model.{3 * n + 2}.conv", F.elu(x))

    def mimi(self, codes):
        """codes (F, n_q) -> PCM (F * frame,)."""
        mi = self.dims["mimi"]
        x = self.rvq(codes)                                    # (F, dim)
        w = self.w("mimi.upsample.convtr.convtr.weight")       # (C, 1, K)
        y = F.conv_transpose1d(self.prec.act(x).T[None],
                               self.prec.weight(w[:, 0])[:, None],
                               stride=mi["upsample_stride"],
                               groups=w.shape[0])
        y = y[0, :, : x.shape[0] * mi["upsample_stride"]].T
        pcm = self.seanet(self.mimi_transformer(y))[:, 0]
        return self.prec.act(pcm[None])[0] if self.prec.acts != "float" \
            else pcm


def run_call(model: Model, text, codes, user, start: int = 0):
    """A call: text (steps,), codes (steps, n_q) the tokens drawn at each
    step, user (n, n_q) -> what was served from step `start` on (a call
    resumed there; 0 from its first): (text logits (steps - start,
    text_card), audio logits (steps - start, n_q, card), PCM (`run_mimi`)).
    The temporal pass runs over every step, the depth pass over the served
    ones."""
    with torch.no_grad(), no_tf32():
        g = grid(model.dims, text, codes, user)
        z, text_logits = model.temporal(g)
        audio_logits = model.depth(z[start:], text[start:], codes[start:])
        pcm = model.mimi(frame_codes(codes)[max(start - 1, 0):])
    return text_logits[start:], audio_logits, pcm


def frame_codes(codes):
    """Mimi's codes of each frame f from the codes drawn at each step:
    codebook 0 of step f, the others of step f + 1 (their delay)."""
    return torch.cat([codes[:-1, :1], codes[1:, 1:]], 1)


def run_mimi(model: Model, codes, start: int = 0):
    """The PCM served from step `start` on: Mimi's decode, from silence,
    of frames max(start - 1, 0).. (a call resumed at step a > 0 decodes
    its frame a - 1 at its first step)."""
    with torch.no_grad(), no_tf32():
        return model.mimi(frame_codes(codes)[max(start - 1, 0):])
