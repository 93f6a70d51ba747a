"""Moshi's random checkpoint: its key layout at a configuration's sizes and
a draw from a seed, written for the benchmark apart from the program.

The keys and torch layouts are those of `kyutai/moshiko-pytorch-bf16`
(the language model's `text_emb`, `emb.N`, `transformer.layers.N.*`,
`out_norm`, `text_linear`, the depth transformer's `depformer_in.K`,
`depformer_text_emb`, `depformer_emb.K`, `depformer.layers.N.*` with one
linear a sub-step, `linears.K`) and of Mimi's decoder (`mimi.quantizer.*`,
`mimi.upsample.*`, `mimi.decoder_transformer.*`, `mimi.decoder.model.N.*`),
with three simplifications of form: the norms' `alpha` are (d,), the
codebooks are plain `embedding` tables (the checkpoint's `embedding_sum /
cluster_usage`), and the per-step depth linears sit under `in_projs.K`,
`out_projs.K` and `gating.K`, as moshi's `weights_per_step` modules name
them.

The values: every transformer linear N(0, 1 / fan-in) (so that a layer's
branch weighs about as much as its residual at any width), the
embeddings and codebooks N(0, 1); every norm's weight 1 + N(0, 0.1) and
each Mimi LayerNorm's bias N(0, 0.1), so that a norm swapped, ignored or
misrouted moves the numbers; Mimi's layer scales positive and distinct
per layer and per scale (layer i's first `0.05 (1 + i / L)`, its second
`0.15 (1 + i / L)`, each times `exp(N(0, 0.2))` a channel); Mimi's convs
and projections N(0, 1 / fan-in) with biases N(0, 0.02), so that the PCM
carries the codes; the
last SEANet conv's taps without DC (their mean over a channel's taps
taken out, the bias 0), so that the PCM has no DC offset. Every value is
rounded to bfloat16 first, so that a float32 copy reads the same numbers.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

DRAW = 1 << 25  # elements a draw
S = 0.02        # the std of a conv's bias


def layout(dims: dict) -> List[Tuple[str, tuple, tuple]]:
    """[(key, shape, fill)] of the checkpoint at the sizes `dims` (a
    configuration's "model"); fill is ("normal", std), ("fan",) for N(0,
    1 / fan-in) of an (out, in) weight, ("norm", 1, std) for 1 + N(0,
    std), ("scale", c, std) for c exp(N(0, std)), ("zero",) or
    ("zero_dc", std)."""
    d, nq = dims["d_model"], dims["n_q"]
    tc, card = dims["text_card"], dims["card"]
    lin, emb, norm = ("fan",), ("normal", 1.0), ("norm", 1.0, 0.1)
    out = [("text_emb.weight", (tc + 1, d), emb)]
    out += [(f"emb.{i}.weight", (card + 1, d), emb) for i in range(2 * nq)]
    for i in range(dims["num_layers"]):
        pre = f"transformer.layers.{i}."
        out += [(pre + "norm1.alpha", (d,), norm),
                (pre + "self_attn.in_proj_weight", (3 * d, d), lin),
                (pre + "self_attn.out_proj.weight", (d, d), lin),
                (pre + "norm2.alpha", (d,), norm),
                (pre + "gating.linear_in.weight", (2 * dims["hidden"], d),
                 lin),
                (pre + "gating.linear_out.weight", (d, dims["hidden"]),
                 lin)]
    out += [("out_norm.alpha", (d,), norm),
            ("text_linear.weight", (tc, d), lin)]
    dp = dims["depth"]
    dd, steps, hid = dp["d_model"], dp["steps"], dp["hidden"]
    out += [(f"depformer_in.{k}.weight", (dd, d), lin) for k in range(steps)]
    out += [("depformer_text_emb.weight", (tc + 1, dd), emb)]
    out += [(f"depformer_emb.{k}.weight", (card + 1, dd), emb)
            for k in range(steps - 1)]
    for i in range(dp["num_layers"]):
        pre = f"depformer.layers.{i}."
        out += [(pre + "norm1.alpha", (dd,), norm),
                (pre + "norm2.alpha", (dd,), norm)]
        for k in range(steps):
            out += [(pre + f"self_attn.in_projs.{k}.weight", (3 * dd, dd),
                     lin),
                    (pre + f"self_attn.out_projs.{k}.weight", (dd, dd), lin),
                    (pre + f"gating.{k}.linear_in.weight", (2 * hid, dd),
                     lin),
                    (pre + f"gating.{k}.linear_out.weight", (dd, hid), lin)]
    out += [(f"linears.{k}.weight", (card, dd), lin) for k in range(steps)]
    return out + _mimi(dims)


def _mimi(dims: dict) -> list:
    mi, rvq = dims["mimi"], dims["rvq"]
    md, mt, sc = mi["dim"], mi["transformer"], mi["seanet"]

    def fan(n):
        return ("normal", float(n) ** -0.5)

    bias, norm = ("normal", S), ("norm", 1.0, 0.1)
    q = "mimi.quantizer."
    ns, rest = rvq["n_semantic"], rvq["n_q"] - rvq["n_semantic"]
    book = (rvq["bins"], rvq["dim"])
    out = [(q + f"rvq_first.vq.layers.{k}._codebook.embedding", book,
            ("normal", 1.0)) for k in range(ns)]
    out += [(q + f"rvq_rest.vq.layers.{k}._codebook.embedding", book,
             ("normal", 1.0)) for k in range(rest)]
    out += [(q + "rvq_first.output_proj.weight", (md, rvq["dim"], 1),
             fan(rvq["dim"] * ns)),
            (q + "rvq_rest.output_proj.weight", (md, rvq["dim"], 1),
             fan(rvq["dim"] * rest)),
            ("mimi.upsample.convtr.convtr.weight",
             (md, 1, mi["upsample_kernel"]), ("normal", 0.5))]
    n = mt["num_layers"]
    for i in range(n):
        pre = f"mimi.decoder_transformer.transformer.layers.{i}."
        grow = 1.0 + i / n
        out += [(pre + "norm1.weight", (md,), norm),
                (pre + "norm1.bias", (md,), ("normal", 0.1)),
                (pre + "self_attn.in_proj_weight", (3 * md, md), ("fan",)),
                (pre + "self_attn.out_proj.weight", (md, md), ("fan",)),
                (pre + "layer_scale_1.scale", (md,),
                 ("scale", 0.05 * grow, 0.2)),
                (pre + "norm2.weight", (md,), norm),
                (pre + "norm2.bias", (md,), ("normal", 0.1)),
                (pre + "linear1.weight", (mt["hidden_dim"], md), ("fan",)),
                (pre + "linear2.weight", (md, mt["hidden_dim"]), ("fan",)),
                (pre + "layer_scale_2.scale", (md,),
                 ("scale", 0.15 * grow, 0.2))]
    stages = sc["stages"]
    out += [("mimi.decoder.model.0.conv.weight",
             (stages[0]["in_ch"], sc["in_ch"], sc["first_kernel"]),
             fan(sc["in_ch"] * sc["first_kernel"])),
            ("mimi.decoder.model.0.conv.bias", (stages[0]["in_ch"],), bias)]
    for i, st in enumerate(stages):
        c, r = 3 * i + 2, 3 * i + 3
        half = st["out_ch"] // 2
        k = sc["resnet_kernel"]
        out += [(f"mimi.decoder.model.{c}.convtr.weight",
                 (st["in_ch"], st["out_ch"], st["kernel"]),
                 fan(st["in_ch"] * st["kernel"] // st["stride"])),
                (f"mimi.decoder.model.{c}.convtr.bias", (st["out_ch"],),
                 bias),
                (f"mimi.decoder.model.{r}.block.1.conv.weight",
                 (half, st["out_ch"], k), fan(st["out_ch"] * k)),
                (f"mimi.decoder.model.{r}.block.1.conv.bias", (half,), bias),
                (f"mimi.decoder.model.{r}.block.3.conv.weight",
                 (st["out_ch"], half, 1), fan(half)),
                (f"mimi.decoder.model.{r}.block.3.conv.bias",
                 (st["out_ch"],), bias)]
    last = 3 * len(stages) + 2
    kl = sc["last_kernel"]
    out += [(f"mimi.decoder.model.{last}.conv.weight",
             (sc["out_ch"], stages[-1]["out_ch"], kl),
             ("zero_dc", float(stages[-1]["out_ch"] * kl) ** -0.5)),
            (f"mimi.decoder.model.{last}.conv.bias", (sc["out_ch"],),
             ("zero",))]
    return out


def draw(dims: dict, seed: int, device="cpu", dtype=None, prefix: str = ""
         ) -> Dict[str, "torch.Tensor"]:
    """A random checkpoint {key: tensor of `dtype` (bfloat16 when None) on
    `device`}, drawn from one torch.Generator on the device tensor by
    tensor (never the whole checkpoint through the host). prefix: only
    the keys that start with it ("mimi.": Mimi's decoder alone)."""
    import torch
    dtype = dtype or torch.bfloat16
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    out = {}
    for key, shape, fill in layout(dims):
        if not key.startswith(prefix):
            continue
        if fill[0] == "zero":
            out[key] = torch.zeros(shape, dtype=dtype, device=device)
            continue
        n = 1
        for x in shape:
            n *= x
        w = torch.empty(n, dtype=dtype, device=device)
        for a in range(0, n, DRAW):
            z = torch.randn(min(DRAW, n - a), generator=gen, device=device)
            if fill[0] == "normal":
                z.mul_(fill[1])
            elif fill[0] == "fan":
                z.mul_(float(shape[1]) ** -0.5)
            elif fill[0] == "norm":
                z = fill[1] + fill[2] * z
            elif fill[0] == "scale":
                z = fill[1] * torch.exp(fill[2] * z)
            w[a:a + z.numel()] = z.to(torch.bfloat16).to(dtype)
        w = w.view(shape)
        if fill[0] == "zero_dc":   # one draw, centred over each tap row
            w32 = w.float()
            w = ((w32 - w32.mean(-1, keepdim=True)) * fill[1]).to(
                torch.bfloat16).to(dtype)
        out[key] = w
    return out
