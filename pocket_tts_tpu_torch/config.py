"""Model configuration for the PyTorch port.

The dataclasses are shared with the JAX package (`pocket_tts_tpu.config`
imports nothing of JAX). `check_supported` names what this port runs: solo
decode, with bf16/f32 or int8 weights (int8 is an engine option, not a
config field). Every config option outside that raises, so no
configuration silently runs something other than what it asks for.

The JAX package's backend switches (`use_pallas_attn`, `use_pallas`) are
not read here: the port picks by device, plain PyTorch for tensors on the
CPU and the hand-written CUDA kernels for tensors on the card.
"""
from __future__ import annotations

from pocket_tts_tpu.config import (DEFAULT_CONFIG, ModelConfig,  # noqa: F401
                                   tiny_config)


def check_supported(cfg: ModelConfig) -> None:
    """Raise NotImplementedError for any option this port does not run."""
    bb = cfg.backbone
    mt = cfg.mimi.transformer
    bad = []
    if bb.quantize_kv:
        bad.append("backbone.quantize_kv")
    if bb.fuse_insert:
        bad.append("backbone.fuse_insert")
    if bb.use_megalayer:
        bad.append("backbone.use_megalayer")
    if bb.use_bilayer:
        bad.append("backbone.use_bilayer")
    if bb.mesh is not None or mt.mesh is not None \
            or cfg.mimi.seanet.mesh is not None or cfg.on_mesh:
        bad.append("mesh")
    if mt.quantize_kv:
        bad.append("mimi.transformer.quantize_kv")
    if mt.capacity % cfg.mimi.upsample_stride:
        bad.append(f"mimi.transformer.capacity={mt.capacity} "
                   f"(must be a multiple of {cfg.mimi.upsample_stride})")
    if bad:
        raise NotImplementedError(
            "not ported yet: " + ", ".join(bad))
