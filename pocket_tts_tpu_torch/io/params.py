"""Checkpoint <-> params-tree mapping for the PyTorch port.

Counterpart of `pocket_tts_tpu/io/params.py`, with torch tensors in place of
jax arrays. The tree keeps the JAX package's structure and layouts exactly,
so one numpy checkpoint feeds both packages and the tests compare leaf for
leaf:

  torch Linear weight (out, in)  -> w (in, out)  [transposed once here]
  conv1d weight (out, in, K)     -> as-is
  conv_transpose1d (in, out, K)  -> as-is
  LayerNorm weight/bias          -> scale/bias
  per-layer modules              -> stacked along a new axis 0
  in_proj q/k columns            -> rope-permuted (see `_rope_permute`)

The modules a checkpoint switches on by shipping their weights load as
the JAX loader loads them: a mimi layer's `norm1` / `norm2` as
{"alpha"} (RMSNorm) when the checkpoint ships `norm*.alpha`; an optional
`norm_cross` + `cross_attention.{in_proj, out_proj}` sub-block in
backbone and mimi layers (its in_proj is not rope-permuted: the cross
path applies no RoPE); and the SEANet encoder, `mimi.encoder.model.N.*`,
under p["mimi"]["encoder"] (indices as models/seanet.encoder_forward
reads them). Flat `.gating.` keys are ignored, as the JAX loader ignores
them: gating reaches a model only through a params tree or a params
cache (io/quant.py).

`random_flat` and `random_voice_prompt` are numpy and draw in the JAX
package's order, so both packages build bit-identical checkpoints from one
seed. Nothing here imports jax.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..config import DEFAULT_CONFIG, ModelConfig, SeanetStage


def _t(a, dtype, device):
    # a C-order copy: checkpoint arrays may be read-only memory maps, and
    # transposed linear weights must be row-major (in, out) for the kernels
    return torch.from_numpy(np.array(a, order="C")).to(device=device,
                                                        dtype=dtype)


def _lin(flat, name, dtype, device, required=True):
    w = flat.get(name + ".weight")
    if w is None:
        if required:
            raise KeyError(f"missing weight: {name}.weight")
        return None
    out = {"w": _t(np.asarray(w).T, dtype, device)}
    b = flat.get(name + ".bias")
    if b is not None:
        out["b"] = _t(b, dtype, device)
    return out


def _norm(flat, name, dtype, device, required=True):
    out = {}
    w = flat.get(name + ".weight")
    if w is not None:
        out["scale"] = _t(w, dtype, device)
    b = flat.get(name + ".bias")
    if b is not None:
        out["bias"] = _t(b, dtype, device)
    if required and not out:
        raise KeyError(f"missing norm params: {name}")
    return out


def _norm_or_rms(flat, name, dtype, device):
    """LayerNorm params, or {"alpha": (d,)} when the checkpoint ships the
    RMSNorm variant (`name.alpha`); consumers route on the "alpha" key."""
    a = flat.get(name + ".alpha")
    if a is not None:
        return {"alpha": _t(a, dtype, device).reshape(-1)}
    return _norm(flat, name, dtype, device)


def _cross(flat, pre, layer, dtype, device):
    """Add the optional `norm_cross` + `cross_attention` sub-block of the
    layer at prefix `pre` to `layer` when the checkpoint ships it."""
    x_in = _lin(flat, pre + "cross_attention.in_proj", dtype, device,
                required=False)
    if x_in is not None:
        layer["norm_cross"] = _norm(flat, pre + "norm_cross", dtype, device)
        layer["cross_attention"] = {
            "in_proj": x_in,
            "out_proj": _lin(flat, pre + "cross_attention.out_proj", dtype,
                             device)}
    return layer


def _conv(flat, name, dtype, device):
    out = {"w": _t(flat[name + ".weight"], dtype, device)}
    b = flat.get(name + ".bias")
    if b is not None:
        out["b"] = _t(b, dtype, device)
    return out


def _rope_permute(lin: dict, d_model: int, head_dim: int) -> dict:
    """Reorder in_proj's q/k output columns so rope's even/odd interleaved
    pairs arrive as contiguous halves (ops.rope.apply_rope_halves relies on
    it). Per head: columns [0, 2, ..., D-2, 1, 3, ..., D-1]; the v block is
    untouched. Same permutation as the JAX loader."""
    perm_head = np.concatenate([np.arange(0, head_dim, 2),
                                np.arange(1, head_dim, 2)])
    perm_d = np.concatenate(
        [h * head_dim + perm_head for h in range(d_model // head_dim)])
    full = torch.as_tensor(np.concatenate(
        [perm_d, d_model + perm_d, 2 * d_model + np.arange(d_model)]),
        device=lin["w"].device)
    out = {"w": lin["w"][:, full].contiguous()}
    if "b" in lin:
        out["b"] = lin["b"][full].contiguous()
    return out


def _stack(dicts):
    """Stack identically-structured dicts of tensors along a new axis 0,
    keys in sorted order as `jax.tree.map` rebuilds them in the JAX
    loader (the params cache records the tree's key order)."""
    return {k: (_stack([d[k] for d in dicts]) if isinstance(dicts[0][k], dict)
                else torch.stack([d[k] for d in dicts], 0))
            for k in sorted(dicts[0])}


def _count_layers(flat, prefix):
    n = 0
    pat = re.compile(re.escape(prefix) + r"(\d+)\.")
    for k in flat:
        m = pat.match(k)
        if m:
            n = max(n, int(m.group(1)) + 1)
    return n


def params_from_flat(flat: Dict[str, np.ndarray],
                     cfg: Optional[ModelConfig] = None,
                     dtype: torch.dtype = torch.float32,
                     device="cpu") -> Tuple[dict, ModelConfig]:
    """Build the params tree from a flat name->array dict, inferring the
    dims the checkpoint fixes (as the JAX loader does)."""
    cfg = cfg or DEFAULT_CONFIG

    inp_w = flat["flow_lm.input_linear.weight"]
    d_model, latent = inp_w.shape
    flow_depth = _count_layers(flat, "flow_lm.flow_net.res_blocks.")
    bb_layers = _count_layers(flat, "flow_lm.transformer.layers.")
    mimi_layers = _count_layers(
        flat, "mimi.decoder_transformer.transformer.layers.")
    flow_dim = flat["flow_lm.flow_net.input_proj.weight"].shape[0]
    freq_half = flat["flow_lm.flow_net.time_embed.0.freqs"].shape[0]
    mlp_hidden = flat["flow_lm.flow_net.res_blocks.0.mlp.0.weight"].shape[0]
    hidden = flat["flow_lm.transformer.layers.0.linear1.weight"].shape[0]
    mimi_dim = flat["mimi.quantizer.output_proj.weight"].shape[0]
    mimi_hidden = flat["mimi.decoder_transformer.transformer.layers.0."
                       "linear1.weight"].shape[0]
    w0 = flat["mimi.decoder.model.0.conv.weight"]
    stages = []
    for m in (2, 5, 8):
        wt = flat[f"mimi.decoder.model.{m}.convtr.weight"]
        stages.append(SeanetStage(int(wt.shape[0]), int(wt.shape[1]),
                                  int(wt.shape[2]), int(wt.shape[2]) // 2))
    up_k = int(flat["mimi.upsample.convtr.convtr.weight"].shape[2])
    n_bins, lut_dim = flat["flow_lm.conditioner.embed.weight"].shape

    cfg = dataclasses.replace(
        cfg,
        latent_dim=latent,
        flow=dataclasses.replace(cfg.flow, depth=flow_depth, dim=flow_dim,
                                 freq_half=freq_half, mlp_hidden=mlp_hidden),
        backbone=dataclasses.replace(
            cfg.backbone, d_model=d_model, num_layers=bb_layers,
            hidden_scale=hidden // d_model),
        lut=dataclasses.replace(cfg.lut, n_bins=int(n_bins),
                                dim=int(lut_dim)),
        mimi=dataclasses.replace(
            cfg.mimi, dim=mimi_dim, latent_dim=latent,
            upsample_kernel=up_k, upsample_stride=up_k // 2,
            transformer=dataclasses.replace(
                cfg.mimi.transformer, d_model=mimi_dim,
                num_layers=mimi_layers, hidden_dim=mimi_hidden),
            seanet=dataclasses.replace(
                cfg.mimi.seanet, in_ch=int(w0.shape[0]),
                first_kernel=int(w0.shape[2]), stages=tuple(stages),
                resnet_kernel=int(
                    flat["mimi.decoder.model.3.block.1.conv.weight"
                         ].shape[2]),
                last_kernel=int(
                    flat["mimi.decoder.model.11.conv.weight"].shape[2]))),
    )

    dd = dict(dtype=dtype, device=device)
    p = {
        "emb_std": _t(flat["flow_lm.emb_std"], **dd).reshape(-1),
        "emb_mean": _t(flat["flow_lm.emb_mean"], **dd).reshape(-1),
        "bos_emb": _t(flat["flow_lm.bos_emb"], **dd).reshape(-1),
        "conditioner": {
            "embed": _t(flat["flow_lm.conditioner.embed.weight"], **dd)},
        "input_linear": _lin(flat, "flow_lm.input_linear", **dd),
        "out_norm": _norm(flat, "flow_lm.out_norm", **dd),
        "out_eos": _lin(flat, "flow_lm.out_eos", **dd),
    }

    layers = []
    for i in range(bb_layers):
        pre = f"flow_lm.transformer.layers.{i}."
        layers.append(_cross(flat, pre, {
            "norm1": _norm(flat, pre + "norm1", **dd),
            "in_proj": _rope_permute(
                _lin(flat, pre + "self_attn.in_proj", **dd),
                d_model, cfg.backbone.head_dim),
            "out_proj": _lin(flat, pre + "self_attn.out_proj", **dd),
            "norm2": _norm(flat, pre + "norm2", **dd),
            "linear1": _lin(flat, pre + "linear1", **dd),
            "linear2": _lin(flat, pre + "linear2", **dd),
        }, **dd))
    p["layers"] = _stack(layers)

    tes = []
    for j in range(2):
        pre = f"flow_lm.flow_net.time_embed.{j}."
        tes.append({
            "freqs": _t(flat[pre + "freqs"], **dd).reshape(-1),
            "mlp_0": _lin(flat, pre + "mlp.0", **dd),
            "mlp_2": _lin(flat, pre + "mlp.2", **dd),
            "mlp_3": {"alpha": _t(flat[pre + "mlp.3.alpha"],
                                  **dd).reshape(-1)},
        })
    blocks = []
    for i in range(flow_depth):
        pre = f"flow_lm.flow_net.res_blocks.{i}."
        blocks.append({
            "in_ln": _norm(flat, pre + "in_ln", **dd, required=False),
            "mlp_0": _lin(flat, pre + "mlp.0", **dd),
            "mlp_2": _lin(flat, pre + "mlp.2", **dd),
            "adaln": _lin(flat, pre + "adaLN_modulation.1", **dd),
        })
    p["flow_net"] = {
        "input_proj": _lin(flat, "flow_lm.flow_net.input_proj", **dd),
        "cond_embed": _lin(flat, "flow_lm.flow_net.cond_embed", **dd),
        "time_embed": tuple(tes),
        "res_blocks": _stack(blocks),
        "final": {
            "norm": _norm(flat, "flow_lm.flow_net.final_layer.norm_final",
                          **dd, required=False),
            "linear": _lin(flat, "flow_lm.flow_net.final_layer.linear",
                           **dd),
            "adaln": _lin(flat,
                          "flow_lm.flow_net.final_layer.adaLN_modulation.1",
                          **dd),
        },
    }

    mlayers = []
    for i in range(mimi_layers):
        pre = f"mimi.decoder_transformer.transformer.layers.{i}."
        mlayers.append(_cross(flat, pre, {
            "norm1": _norm_or_rms(flat, pre + "norm1", **dd),
            "in_proj": _rope_permute(
                _lin(flat, pre + "self_attn.in_proj", **dd),
                mimi_dim, cfg.mimi.transformer.head_dim),
            "out_proj": _lin(flat, pre + "self_attn.out_proj", **dd),
            "layer_scale_1": {
                "scale": _t(flat[pre + "layer_scale_1.scale"], **dd)},
            "norm2": _norm_or_rms(flat, pre + "norm2", **dd),
            "linear1": _lin(flat, pre + "linear1", **dd),
            "linear2": _lin(flat, pre + "linear2", **dd),
            "layer_scale_2": {
                "scale": _t(flat[pre + "layer_scale_2.scale"], **dd)},
        }, **dd))

    dec = {}
    for name in ["model_0", "model_11"]:
        dec[name] = _conv(flat, f"mimi.decoder.{name.replace('_', '.')}.conv",
                          **dd)
    for name in ["model_2", "model_5", "model_8"]:
        dec[name] = _conv(
            flat, f"mimi.decoder.{name.replace('_', '.')}.convtr", **dd)
    for name in ["model_3", "model_6", "model_9"]:
        base = f"mimi.decoder.{name.replace('_', '.')}"
        dec[name] = {
            "block_1": _conv(flat, base + ".block.1.conv", **dd),
            "block_3": _conv(flat, base + ".block.3.conv", **dd),
        }

    p["mimi"] = {
        "quantizer": _conv(flat, "mimi.quantizer.output_proj", **dd),
        "upsample": _conv(flat, "mimi.upsample.convtr.convtr", **dd),
        "decoder_transformer": {"layers": _stack(mlayers)},
        "decoder": dec,
    }
    if "mimi.encoder.model.0.conv.weight" in flat:
        p["mimi"]["encoder"] = _encoder(flat, len(stages), **dd)

    # derived: constant time conditioning (s=0, t=1 always at inference)
    from ..models.flow_mlp import time_cond
    p["_time_cond"] = time_cond(p["flow_net"])
    return p, cfg


def _encoder(flat, n: int, dtype, device) -> dict:
    """The SEANet encoder's convs, `mimi.encoder.model.N.*`: model_0, per
    stage i a resnet at 3i+1 and a strided conv at 3i+3, the final conv at
    3n+2 (models/seanet.encoder_init_state)."""
    dd = dict(dtype=dtype, device=device)
    enc = {"model_0": _conv(flat, "mimi.encoder.model.0.conv", **dd)}
    for gi in range(n):
        ri, ci = 3 * gi + 1, 3 * gi + 3
        enc[f"model_{ri}"] = {
            blk: _conv(flat, f"mimi.encoder.model.{ri}.block.{j}.conv", **dd)
            for blk, j in (("block_1", 1), ("block_3", 3))}
        enc[f"model_{ci}"] = _conv(flat, f"mimi.encoder.model.{ci}.conv",
                                   **dd)
    fi = 3 * n + 2
    enc[f"model_{fi}"] = _conv(flat, f"mimi.encoder.model.{fi}.conv", **dd)
    return enc


def from_jax_numpy(tree, device="cpu", dtype: Optional[torch.dtype] = None,
                   _keep: bool = False):
    """The JAX package's params pytree, given with numpy leaves
    (`jax.tree.map(np.asarray, params)`), as the port's params tree: the
    same nesting, stacking and rope permutation, with torch tensors. dtype
    None keeps each leaf's float type (bf16 leaves arrive as ml_dtypes
    bfloat16 and become torch.bfloat16); a dtype casts the float leaves to
    it, except the `scale` of a quantized linear ({"q"/"q4", "scale"}),
    which the JAX package keeps in its storage type (float32, bfloat16 for
    K-grouped int4) in every engine dtype. Integer leaves (int8 `q`, packed
    `q4`) keep their type."""
    if isinstance(tree, dict):
        quant = "q" in tree or "q4" in tree
        return {k: from_jax_numpy(v, device, dtype, quant and k == "scale")
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return tuple(from_jax_numpy(v, device, dtype) for v in tree)
    a = np.asarray(tree)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))
    if dtype is not None and t.is_floating_point() and not _keep:
        t = t.to(dtype)
    return t.to(device)


def load_checkpoint(path: str, cfg: Optional[ModelConfig] = None,
                    dtype: torch.dtype = torch.float32, device="cpu"):
    """Load a checkpoint (safetensors, or GGUF for a `.gguf` path, as the
    JAX loader reads both) into the port's params tree. A GGUF file's BF16
    tensors come as torch.bfloat16 and its block-quantized ones
    dequantized to float32; both widen to float32 here, exactly, as the
    safetensors reader gives BF16."""
    if path.endswith(".gguf"):
        from .gguf import read_gguf
        flat, _ = read_gguf(path)
        flat = {k: (v.float().numpy() if isinstance(v, torch.Tensor) else v)
                for k, v in flat.items()}
    else:
        from .safetensors_io import load_safetensors
        flat = load_safetensors(path)
    return params_from_flat(flat, cfg, dtype, device)


def load_voice(path: str, dtype: torch.dtype = torch.float32, device="cpu"):
    """Load a voice embedding file as a (Tp, d_model) tensor (the
    "voice.audio_prompt" tensor, flattened to rows)."""
    from .safetensors_io import load_safetensors
    prompt = np.asarray(load_safetensors(path)["voice.audio_prompt"],
                        np.float32)
    return _t(prompt.reshape(-1, prompt.shape[-1]), dtype, device)


# ---------------------------------------------------------------------------
# random checkpoint generation (tests / bench without real weights)
# ---------------------------------------------------------------------------

def random_flat(cfg: ModelConfig, seed: int = 0,
                scale: float = 0.02) -> Dict[str, np.ndarray]:
    """A flat dict with exactly the reference checkpoint's key set and
    plausible shapes, filled with small random values. Draws in the same
    order as the JAX package's `random_flat`, so the arrays are
    bit-identical for one seed."""
    rng = np.random.RandomState(seed)
    out: Dict[str, np.ndarray] = {}

    def t(name, *shape, s=scale):
        out[name] = (rng.randn(*shape) * s).astype(np.float32)

    def ones(name, *shape):
        out[name] = np.ones(shape, np.float32)

    def zeros(name, *shape):
        out[name] = np.zeros(shape, np.float32)

    dm = cfg.backbone.d_model
    lat = cfg.latent_dim
    hid = cfg.backbone.hidden_dim
    fd = cfg.flow.dim
    fh = cfg.flow.mlp_hidden
    ff = cfg.flow.freq_half

    t("flow_lm.conditioner.embed.weight", cfg.lut.n_bins, dm)
    ones("flow_lm.emb_std", lat)
    zeros("flow_lm.emb_mean", lat)
    t("flow_lm.bos_emb", lat, s=1.0)
    t("flow_lm.input_linear.weight", dm, lat)
    for i in range(cfg.backbone.num_layers):
        pre = f"flow_lm.transformer.layers.{i}."
        t(pre + "self_attn.in_proj.weight", 3 * dm, dm)
        t(pre + "self_attn.out_proj.weight", dm, dm)
        ones(pre + "norm1.weight", dm)
        zeros(pre + "norm1.bias", dm)
        ones(pre + "norm2.weight", dm)
        zeros(pre + "norm2.bias", dm)
        t(pre + "linear1.weight", hid, dm)
        t(pre + "linear2.weight", dm, hid)
    ones("flow_lm.out_norm.weight", dm)
    zeros("flow_lm.out_norm.bias", dm)
    t("flow_lm.out_eos.weight", 1, dm)
    out["flow_lm.out_eos.bias"] = np.full((1,), -6.0, np.float32)

    t("flow_lm.flow_net.input_proj.weight", fd, lat)
    t("flow_lm.flow_net.input_proj.bias", fd)
    t("flow_lm.flow_net.cond_embed.weight", fd, dm)
    t("flow_lm.flow_net.cond_embed.bias", fd)
    for j in range(2):
        pre = f"flow_lm.flow_net.time_embed.{j}."
        t(pre + "freqs", ff, s=1.0)
        t(pre + "mlp.0.weight", fd, 2 * ff)
        t(pre + "mlp.0.bias", fd)
        t(pre + "mlp.2.weight", fd, fd)
        t(pre + "mlp.2.bias", fd)
        ones(pre + "mlp.3.alpha", fd)
    for i in range(cfg.flow.depth):
        pre = f"flow_lm.flow_net.res_blocks.{i}."
        t(pre + "mlp.0.weight", fh, fd)
        t(pre + "mlp.0.bias", fh)
        t(pre + "mlp.2.weight", fd, fh)
        t(pre + "mlp.2.bias", fd)
        t(pre + "adaLN_modulation.1.weight", 3 * fd, fd)
        zeros(pre + "adaLN_modulation.1.bias", 3 * fd)
    t("flow_lm.flow_net.final_layer.linear.weight", lat, fd)
    zeros("flow_lm.flow_net.final_layer.linear.bias", lat)
    t("flow_lm.flow_net.final_layer.adaLN_modulation.1.weight", 2 * fd, fd)
    zeros("flow_lm.flow_net.final_layer.adaLN_modulation.1.bias", 2 * fd)

    md = cfg.mimi.dim
    mt = cfg.mimi.transformer
    t("mimi.quantizer.output_proj.weight", md, lat, 1)
    t("mimi.upsample.convtr.convtr.weight", md, 1, cfg.mimi.upsample_kernel,
      s=0.2)
    for i in range(mt.num_layers):
        pre = f"mimi.decoder_transformer.transformer.layers.{i}."
        ones(pre + "norm1.weight", md)
        zeros(pre + "norm1.bias", md)
        t(pre + "self_attn.in_proj.weight", 3 * md, md)
        t(pre + "self_attn.out_proj.weight", md, md)
        out[pre + "layer_scale_1.scale"] = np.full((md,), 0.01, np.float32)
        ones(pre + "norm2.weight", md)
        zeros(pre + "norm2.bias", md)
        t(pre + "linear1.weight", mt.hidden_dim, md)
        t(pre + "linear2.weight", md, mt.hidden_dim)
        out[pre + "layer_scale_2.scale"] = np.full((md,), 0.01, np.float32)

    sc = cfg.mimi.seanet
    t("mimi.decoder.model.0.conv.weight", sc.in_ch, sc.in_ch, sc.first_kernel)
    t("mimi.decoder.model.0.conv.bias", sc.in_ch)
    stage_names = [("model.2", "model.3"), ("model.5", "model.6"),
                   ("model.8", "model.9")]
    for st, (cname, rname) in zip(sc.stages, stage_names):
        t(f"mimi.decoder.{cname}.convtr.weight", st.in_ch, st.out_ch,
          st.kernel)
        t(f"mimi.decoder.{cname}.convtr.bias", st.out_ch)
        half = st.out_ch // 2
        t(f"mimi.decoder.{rname}.block.1.conv.weight", half, st.out_ch,
          sc.resnet_kernel)
        t(f"mimi.decoder.{rname}.block.1.conv.bias", half)
        t(f"mimi.decoder.{rname}.block.3.conv.weight", st.out_ch, half, 1)
        t(f"mimi.decoder.{rname}.block.3.conv.bias", st.out_ch)
    t("mimi.decoder.model.11.conv.weight", sc.out_ch, sc.stages[-1].out_ch,
      sc.last_kernel)
    t("mimi.decoder.model.11.conv.bias", sc.out_ch)
    return out


def random_params(cfg: ModelConfig, seed: int = 0,
                  dtype: torch.dtype = torch.float32, device="cpu"):
    return params_from_flat(random_flat(cfg, seed), cfg, dtype, device)


def random_voice_prompt(cfg: ModelConfig, length: int = 32, seed: int = 1):
    rng = np.random.RandomState(seed)
    return (rng.randn(length, cfg.backbone.d_model) * 0.05).astype(np.float32)
