"""The multi-rank dry run of sharded serving.

Counterpart of the JAX package's `dryrun_multichip` (its driver entry,
`__graft_entry__.py`): n ranks on a ("data", "model") mesh, model = 2 when
n is even, at the full reference dims of DEFAULT_CONFIG (d_model 1024, 16
backbone heads, mimi d 512, 8 heads) with random weights from seed 0, so
that it catches divisibility and layout faults tiny shapes cannot. Each
rank:

- primes and prefills the whole batch (b = 2 * data lanes, the KV slot
  budget shrunk to 256 as the JAX dry run does), takes its block
  (`shard_batched_state`, `shard_params`) and runs one batched frame step
  with the kernels off (`use_pallas_attn=False` on both transformers) and
  then with them on, both through `mesh_cfg`; the two must agree (1e-3
  relative to max |pcm|);
- runs a `ContinuousBatchingServer(mesh=, share_prefix=True)`: one
  request, a chunk, a second request after the batch is decoding (an
  admission into a running sharded batch), another chunk.

    python -m pocket_tts_tpu_torch.parallel.dryrun [N] [--device cpu]

The ranks use the gloo backend (several ranks share one card; NCCL
refuses that), on "cuda" (the default) or on the CPU.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import launch as _launch
from .sharding import (axis_size, gather_lanes, shard_batched_state,
                       shard_params)


def _whole_batch(p, cfg, prompts, device):
    """Every lane primed and prefilled without a mesh."""
    from ..models import backbone
    from ..runtime import batched as tb
    b = prompts.shape[0]
    cfg0 = tb.mesh_cfg(cfg)
    st = tb.stack_states([backbone.init_state(cfg0.backbone, device=device)
                          for _ in range(b)])
    vs = tb.batched_prime_voice(
        p, cfg0, st, torch.from_numpy(prompts).to(device),
        torch.full((b,), prompts.shape[1], dtype=torch.int32, device=device))
    vs = tb.shrink_lanes(vs, 256)
    tokens = torch.arange(16, device=device).repeat(b, 1)
    return tb.batched_sentence_prefill(
        p, cfg0, vs, tokens, torch.full((b,), 12, dtype=torch.int32,
                                        device=device))


def _rank(mesh, cfg):
    from ..config import DEFAULT_CONFIG
    from ..io.params import random_params, random_voice_prompt
    from ..runtime import batched as tb
    from ..runtime.engine import TTSEngine
    from ..runtime.server import ContinuousBatchingServer
    from ..text.tokenizer import MockTokenizer
    device = torch.device(mesh.device_type)
    params, cfg = random_params(cfg or DEFAULT_CONFIG, seed=0, device=device)
    data, model = axis_size(mesh, "data"), axis_size(mesh, "model")
    b = 2 * data
    prompts = np.stack([random_voice_prompt(cfg, 16, seed=i)
                        for i in range(b)])
    off = dataclasses.replace(
        cfg, backbone=dataclasses.replace(cfg.backbone,
                                          use_pallas_attn=False),
        mimi=dataclasses.replace(cfg.mimi, transformer=dataclasses.replace(
            cfg.mimi.transformer, use_pallas_attn=False)))
    own = tb.lane_block(b, mesh)
    noise = torch.stack([tb.draw_noise(i, 1, cfg.latent_dim, 0.7,
                                       torch.float32, device)[0]
                         for i in own])
    pcms = {}
    for label, base in (("kernels off", off), ("kernels on", cfg)):
        cfg_m = tb.mesh_cfg(base, mesh)
        states = shard_batched_state(_whole_batch(params, base, prompts,
                                                  device), mesh, cfg_m)
        pcm, _ = tb.batched_frame_step(
            shard_params(params, mesh, cfg_m), cfg_m, states, noise,
            torch.full((len(own),), 3, dtype=torch.int32, device=device),
            torch.full((len(own),), 50, dtype=torch.int32, device=device))
        pcm = gather_lanes(pcm, mesh)
        if pcm.shape != (b, cfg.mimi.frame_size) or not bool(
                torch.isfinite(pcm).all()):
            raise AssertionError(f"dryrun {label}: pcm {tuple(pcm.shape)}, "
                                 f"finite {bool(torch.isfinite(pcm).all())}")
        pcms[label] = pcm
    scale = float(pcms["kernels off"].abs().max())
    err = float((pcms["kernels on"] - pcms["kernels off"]).abs().max())
    if not (scale > 0 and err <= 1e-3 * scale):
        raise AssertionError(f"dryrun: kernels on vs off differ by {err} "
                             f"(max |pcm| {scale})")
    eng = TTSEngine(params=params, cfg=cfg, device=device,
                    tokenizer=MockTokenizer(cfg.lut.n_bins))
    srv = ContinuousBatchingServer(eng, lanes=b, chunk_frames=2, mesh=mesh,
                                   share_prefix=True)
    if srv.cfg.backbone.mesh is not mesh or not srv.share_prefix:
        raise AssertionError("dryrun: the server's cfg lost the mesh")
    srv.register_voices({"v0": random_voice_prompt(cfg, 16, seed=0)})
    srv.submit("Hello mesh world.", "v0")
    emitted = srv.step()                 # first admission + first chunk
    srv.submit("A second stream joins.", "v0")
    emitted += srv.step()                # admission into a running batch
    active = sum(1 for r in srv._live if r is not None)
    if emitted <= 0 or active < 2:
        raise AssertionError(f"dryrun: the sharded server emitted "
                             f"{emitted} frames with {active} active lanes")
    return dict(mesh=(data, model), batch=b, kernels_vs_plain=err / scale,
                server_frames=emitted, active=active)


def dryrun_multichip(n_devices: int = 4, device: str = "cuda",
                     cfg=None) -> dict:
    """The dry run on n_devices gloo ranks (see the module docstring);
    cfg: DEFAULT_CONFIG when None. Returns rank 0's report; a rank's
    failure raises here."""
    model = 2 if n_devices % 2 == 0 else 1
    reports = _launch.launch(_rank, n_devices // model, model,
                             backend="gloo", device=device, args=(cfg,))
    rep = reports[0]
    print(f"dryrun_multichip ok: mesh={rep['mesh']}, batch={rep['batch']}, "
          f"kernels on vs off {rep['kernels_vs_plain']:.2e} of max |pcm|, "
          f"share_prefix=on, admission_cycles=2, "
          f"server_frames={rep['server_frames']}")
    return rep


if __name__ == "__main__":
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n", nargs="?", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args()
    dryrun_multichip(a.n, a.device)
