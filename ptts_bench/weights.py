"""The benchmark's checkpoint and voices, made on the device from a seed.

The checkpoint has the key set and torch layouts of Kyutai's
`tts_b6369a24.safetensors` at the sizes a configuration file gives
(`model`), filled the way random test checkpoints of this model are:
N(0, 0.02) for weights and biases, N(0, 1) for the BOS latent and the
time-embedding frequencies, 0.2 for the upsampler, ones and zeros for
norms, 0.01 layer scales, an EOS bias of -6. Every random value comes from
one torch.Generator on the device, in a few large draws, and is rounded
to bfloat16 (the type the model is served in), so the program and the
reference read the same numbers. Voices are prompt embeddings of
N(0, 0.05), rounded the same way.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

DRAW = 1 << 25  # elements per draw


def sub_seed(seed: int, *tag: int) -> int:
    """A 63-bit seed for one purpose of a run's seed."""
    return int(np.random.SeedSequence([int(seed) % (1 << 64), *tag])
               .generate_state(2, np.uint64)[0] >> np.uint64(1))


def layout(model: dict) -> List[Tuple[str, tuple, object]]:
    """[(key, shape, fill)] of the checkpoint; fill a float std for
    N(0, std), or ("const", value)."""
    bb, fl, mi = model["backbone"], model["flow"], model["mimi"]
    dm, lat = bb["d_model"], model["latent_dim"]
    hid = dm * bb["hidden_scale"]
    fd, fh, ff = fl["dim"], fl["mlp_hidden"], fl["freq_half"]
    s = 0.02
    one, zero = ("const", 1.0), ("const", 0.0)
    out = [("flow_lm.conditioner.embed.weight", (model["lut"]["n_bins"], dm),
            s), ("flow_lm.emb_std", (lat,), one),
           ("flow_lm.emb_mean", (lat,), zero),
           ("flow_lm.bos_emb", (lat,), 1.0),
           ("flow_lm.input_linear.weight", (dm, lat), s)]
    for i in range(bb["num_layers"]):
        pre = f"flow_lm.transformer.layers.{i}."
        out += [(pre + "self_attn.in_proj.weight", (3 * dm, dm), s),
                (pre + "self_attn.out_proj.weight", (dm, dm), s),
                (pre + "norm1.weight", (dm,), one),
                (pre + "norm1.bias", (dm,), zero),
                (pre + "norm2.weight", (dm,), one),
                (pre + "norm2.bias", (dm,), zero),
                (pre + "linear1.weight", (hid, dm), s),
                (pre + "linear2.weight", (dm, hid), s)]
    out += [("flow_lm.out_norm.weight", (dm,), one),
            ("flow_lm.out_norm.bias", (dm,), zero),
            ("flow_lm.out_eos.weight", (1, dm), s),
            ("flow_lm.out_eos.bias", (1,), ("const", -6.0)),
            ("flow_lm.flow_net.input_proj.weight", (fd, lat), s),
            ("flow_lm.flow_net.input_proj.bias", (fd,), s),
            ("flow_lm.flow_net.cond_embed.weight", (fd, dm), s),
            ("flow_lm.flow_net.cond_embed.bias", (fd,), s)]
    for j in range(2):
        pre = f"flow_lm.flow_net.time_embed.{j}."
        out += [(pre + "freqs", (ff,), 1.0),
                (pre + "mlp.0.weight", (fd, 2 * ff), s),
                (pre + "mlp.0.bias", (fd,), s),
                (pre + "mlp.2.weight", (fd, fd), s),
                (pre + "mlp.2.bias", (fd,), s),
                (pre + "mlp.3.alpha", (fd,), one)]
    for i in range(fl["depth"]):
        pre = f"flow_lm.flow_net.res_blocks.{i}."
        out += [(pre + "mlp.0.weight", (fh, fd), s),
                (pre + "mlp.0.bias", (fh,), s),
                (pre + "mlp.2.weight", (fd, fh), s),
                (pre + "mlp.2.bias", (fd,), s),
                (pre + "adaLN_modulation.1.weight", (3 * fd, fd), s),
                (pre + "adaLN_modulation.1.bias", (3 * fd,), zero)]
    fin = "flow_lm.flow_net.final_layer."
    out += [(fin + "linear.weight", (lat, fd), s),
            (fin + "linear.bias", (lat,), zero),
            (fin + "adaLN_modulation.1.weight", (2 * fd, fd), s),
            (fin + "adaLN_modulation.1.bias", (2 * fd,), zero)]
    md, mt, sc = mi["dim"], mi["transformer"], mi["seanet"]
    out += [("mimi.quantizer.output_proj.weight", (md, lat, 1), s),
            ("mimi.upsample.convtr.convtr.weight",
             (md, 1, mi["upsample_kernel"]), 0.2)]
    for i in range(mt["num_layers"]):
        pre = f"mimi.decoder_transformer.transformer.layers.{i}."
        out += [(pre + "norm1.weight", (md,), one),
                (pre + "norm1.bias", (md,), zero),
                (pre + "self_attn.in_proj.weight", (3 * md, md), s),
                (pre + "self_attn.out_proj.weight", (md, md), s),
                (pre + "layer_scale_1.scale", (md,), ("const", 0.01)),
                (pre + "norm2.weight", (md,), one),
                (pre + "norm2.bias", (md,), zero),
                (pre + "linear1.weight", (mt["hidden_dim"], md), s),
                (pre + "linear2.weight", (md, mt["hidden_dim"]), s),
                (pre + "layer_scale_2.scale", (md,), ("const", 0.01))]
    out += [("mimi.decoder.model.0.conv.weight",
             (sc["in_ch"], sc["in_ch"], sc["first_kernel"]), s),
            ("mimi.decoder.model.0.conv.bias", (sc["in_ch"],), s)]
    for st, (c, r) in zip(sc["stages"], ((2, 3), (5, 6), (8, 9))):
        half = st["out_ch"] // 2
        out += [(f"mimi.decoder.model.{c}.convtr.weight",
                 (st["in_ch"], st["out_ch"], st["kernel"]), s),
                (f"mimi.decoder.model.{c}.convtr.bias", (st["out_ch"],), s),
                (f"mimi.decoder.model.{r}.block.1.conv.weight",
                 (half, st["out_ch"], sc["resnet_kernel"]), s),
                (f"mimi.decoder.model.{r}.block.1.conv.bias", (half,), s),
                (f"mimi.decoder.model.{r}.block.3.conv.weight",
                 (st["out_ch"], half, 1), s),
                (f"mimi.decoder.model.{r}.block.3.conv.bias",
                 (st["out_ch"],), s)]
    out += [("mimi.decoder.model.11.conv.weight",
             (sc["out_ch"], sc["stages"][-1]["out_ch"], sc["last_kernel"]),
             s),
            ("mimi.decoder.model.11.conv.bias", (sc["out_ch"],), s)]
    return out


def _draw(gen, n: int, device) -> torch.Tensor:
    parts = [torch.randn(min(DRAW, n - a), generator=gen, device=device)
             for a in range(0, n, DRAW)]
    return torch.cat(parts) if len(parts) > 1 else parts[0]


def checkpoint(model: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The flat checkpoint {key: float32 tensor on `device`}, every value
    representable in bfloat16."""
    items = layout(model)
    n = sum(int(np.prod(shape)) for _, shape, fill in items
            if not isinstance(fill, tuple))
    gen = torch.Generator(device=device)
    gen.manual_seed(sub_seed(seed, 1))
    z = _draw(gen, n, device)
    out, a = {}, 0
    for key, shape, fill in items:
        if isinstance(fill, tuple):
            out[key] = torch.full(shape, fill[1], device=device)
            continue
        m = int(np.prod(shape))
        out[key] = (z[a:a + m].view(shape) * fill).to(torch.bfloat16).float()
        a += m
    return out


def voices(model: dict, lengths, seed: int, device) -> List[torch.Tensor]:
    """One (length, d_model) prompt a voice, float32 on `device`, every
    value representable in bfloat16."""
    gen = torch.Generator(device=device)
    gen.manual_seed(sub_seed(seed, 2))
    dm = model["backbone"]["d_model"]
    z = _draw(gen, int(sum(lengths)) * dm, device)
    out, a = [], 0
    for n in lengths:
        out.append((z[a:a + n * dm].view(n, dm) * 0.05).to(torch.bfloat16)
                   .float())
        a += n * dm
    return out
