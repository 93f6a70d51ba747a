"""Rank-side jobs of tests/test_torch_sharding.py and
tests/test_torch_sharding_quant.py.

Each job runs on every rank of a gloo group (pocket_tts_tpu_torch.parallel.
launch.RankGroup) as job(mesh, *args) and returns numpy arrays and plain
values. This module imports torch and the port only: the spawned ranks
never load JAX (the test module, which does, runs the JAX references).
"""
import dataclasses

import numpy as np
import torch

from pocket_tts_tpu_torch.config import check_supported
from pocket_tts_tpu_torch.io.quant import quantize_params
from pocket_tts_tpu_torch.models import backbone, tts
from pocket_tts_tpu_torch.parallel import sharding
from pocket_tts_tpu_torch.runtime import batched as tb
from pocket_tts_tpu_torch.runtime.engine import TTSEngine
from pocket_tts_tpu_torch.runtime.server import (ContinuousBatchingServer,
                                                 MultiStreamServer)
from pocket_tts_tpu_torch.text.tokenizer import MockTokenizer


def to_numpy(tree):
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_numpy(v) for v in tree)
    return tree.numpy() if isinstance(tree, torch.Tensor) else tree


def to_torch(tree):
    if isinstance(tree, dict):
        return {k: to_torch(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_torch(v) for v in tree)
    return torch.from_numpy(tree) if isinstance(tree, np.ndarray) else tree


def coords(mesh):
    return (torch.distributed.get_rank(), sharding.axis_rank(mesh, "data"),
            sharding.axis_rank(mesh, "model"))


def engine(params_np, cfg, **kw):
    return TTSEngine(params=to_torch(params_np), cfg=cfg, seed=0,
                     device="cpu", tokenizer=MockTokenizer(cfg.lut.n_bins),
                     **kw)


# the engine's `quantize` options as quantize_params arguments
QUANTIZE = {"int8": dict(bits=8), "int4": dict(bits=4),
            "q4_0": dict(bits=4, group=32)}


def params(params_np, quantize=None):
    """The torch tree of a numpy params tree, quantized as the engine's
    `quantize` option does (None: float)."""
    p = to_torch(params_np)
    return p if quantize is None else quantize_params(p,
                                                      **QUANTIZE[quantize])


# the fused kernels' wrappers a mesh must never reach, and K4a / K4b as
# ops.basic.linear calls them: {counter: (module, attribute)}
ROUTES = {"K5a": ("fused_layer", "pre_attention"),
          "K5b": ("fused_layer", "post_attention"),
          "K5c": ("fused_layer", "bilayer_post_pre"),
          "K8": ("fused_step", "megalayer"),
          "K6": ("fused_flow", "flow_forward"),
          "K4a": ("basic", "int8_matmul"),
          "K4b": ("basic", "int4_matmul")}
_calls = {}


def count_routes():
    """Wrap ROUTES once in this process so that each call counts in
    `_calls`; returns `_calls` reset to zeros."""
    import importlib
    if not _calls:
        for key, (mod, name) in ROUTES.items():
            m = importlib.import_module(f"pocket_tts_tpu_torch.ops.{mod}")
            real = getattr(m, name)

            def fn(*a, _real=real, _key=key, **kw):
                _calls[_key] += 1
                return _real(*a, **kw)

            setattr(m, name, fn)
    _calls.update({key: 0 for key in ROUTES})
    return _calls


# ----------------------------------------------------------------- jobs ---

def shard_params_job(mesh, params_np, cfg, quantize=None):
    """This rank's block of the params (quantized first, see `params`)
    under mesh_cfg(cfg, mesh); bf16 scales come back as float32, which
    holds them exactly."""
    cfg_m = tb.mesh_cfg(cfg, mesh)
    block = sharding.shard_params(params(params_np, quantize), mesh, cfg_m)
    return coords(mesh), to_numpy(sharding._tree_map(
        lambda path, t: t.float() if isinstance(t, torch.Tensor)
        and t.dtype == torch.bfloat16 else t, block))


def mesh_cfg_job(mesh, params_np, cfg):
    """mesh_cfg's fields on a real mesh, and the cfg of both servers."""
    cfg_m = tb.mesh_cfg(cfg, mesh)
    check_supported(cfg_m)
    eng = engine(params_np, cfg)
    servers = [MultiStreamServer(eng, max_batch=4, mesh=mesh),
               ContinuousBatchingServer(eng, lanes=4, mesh=mesh)]
    no_mesh = MultiStreamServer(eng, max_batch=4).cfg
    return dict(
        backbone_mesh=cfg_m.backbone.mesh is mesh,
        backbone_pallas=cfg_m.backbone.use_pallas_attn,
        mimi_mesh=cfg_m.mimi.transformer.mesh is mesh,
        mimi_pallas=cfg_m.mimi.transformer.use_pallas_attn,
        seanet_mesh=cfg_m.mimi.seanet.mesh is mesh,
        on_mesh=cfg_m.on_mesh, fuse_insert=cfg_m.backbone.fuse_insert,
        heads=(sharding.local_heads(cfg_m.backbone),
               sharding.local_heads(cfg_m.mimi.transformer)),
        servers_through_mesh_cfg=all(s.cfg == cfg_m for s in servers),
        no_mesh_only_fuse_insert=no_mesh == dataclasses.replace(
            cfg, backbone=dataclasses.replace(cfg.backbone,
                                              fuse_insert=True)),
        no_mesh_on_mesh=tb.mesh_cfg(cfg).on_mesh)


def _whole_states(p, cfg, prompts, tokens, prompt_lens, token_lens):
    """Every lane primed and prefilled without a mesh (a whole state)."""
    cfg0 = tb.mesh_cfg(cfg)
    b = prompts.shape[0]
    st = tb.stack_states([backbone.init_state(cfg0.backbone)
                          for _ in range(b)])
    vs = tb.batched_prime_voice(p, cfg0, st, torch.from_numpy(prompts),
                                torch.tensor(prompt_lens, dtype=torch.int32))
    return tb.batched_sentence_prefill(
        p, cfg0, vs, torch.from_numpy(tokens),
        torch.tensor(token_lens, dtype=torch.int32))


def frame_steps_job(mesh, params_np, cfg, prompts, tokens, prompt_lens,
                    token_lens, fae, max_steps, n_frames, quantize=None):
    """The whole batch state sharded (shard_batched_state), then n_frames
    of batched_frame_step on this rank's block at temp 0 (quantize: the
    weights', see `params`). Returns the local pcm (n_frames, B / data,
    frame), valid, the all-reduces and all-gathers a frame issued, and
    the calls a frame made of each of ROUTES."""
    p = params(params_np, quantize)
    cfg_m = tb.mesh_cfg(cfg, mesh)
    whole = _whole_states(p, cfg, prompts, tokens, prompt_lens, token_lens)
    st = sharding.shard_batched_state(whole, mesh, cfg_m)
    ps = sharding.shard_params(p, mesh, cfg_m)
    block = tb.lane_block(prompts.shape[0], mesh)
    own = slice(block.start, block.stop)
    fae_t = torch.tensor(fae[own], dtype=torch.int32)
    ms_t = torch.tensor(max_steps[own], dtype=torch.int32)
    noise = torch.zeros(len(block), cfg.latent_dim)
    pcms, valids = [], []
    sharding.collectives.update(all_reduce=0, all_gather=0)
    calls = count_routes()
    for _ in range(n_frames):
        pcm, valid = tb.batched_frame_step(ps, cfg_m, st, noise, fae_t, ms_t)
        pcms.append(pcm.numpy())
        valids.append(valid.numpy())
    return dict(coords=coords(mesh), block=(block.start, block.stop),
                pcm=np.stack(pcms), valid=np.stack(valids),
                reduces_per_frame=sharding.collectives["all_reduce"]
                / n_frames,
                gathers_per_frame=sharding.collectives["all_gather"]
                / n_frames,
                calls_per_frame={k: v / n_frames for k, v in calls.items()})


def own_prefill_job(mesh, params_np, cfg, prompts, tokens, prompt_lens,
                    token_lens):
    """A rank's own lanes primed and prefilled at its heads (the sharded
    params; BatchedEngine's way) against its block of the whole prefill
    (shard_batched_state): the largest difference of the dequantized
    cache rows and of the int8 scale rows, and whether pos agrees."""
    p = to_torch(params_np)
    cfg_m = tb.mesh_cfg(cfg, mesh)
    whole = sharding.shard_batched_state(
        _whole_states(p, cfg, prompts, tokens, prompt_lens, token_lens),
        mesh, cfg_m)
    block = tb.lane_block(prompts.shape[0], mesh)
    own = slice(block.start, block.stop)
    ps = sharding.shard_params(p, mesh, cfg_m)
    st = tb.stack_states([backbone.init_state(cfg_m.backbone)
                          for _ in block])
    vs = tb.batched_prime_voice(ps, cfg_m, st, torch.from_numpy(prompts[own]),
                                torch.tensor(prompt_lens[own],
                                             dtype=torch.int32))
    mine = tb.batched_sentence_prefill(
        ps, cfg_m, vs, torch.from_numpy(tokens[own]),
        torch.tensor(token_lens[own], dtype=torch.int32))
    a, b = mine.flow, whole.flow
    quant = a.k_scale is not None
    rows = max(float((x.float() - y.float()).abs().max())
               for x, y in zip(a.k + a.v, b.k + b.v))
    scales = (max(float(((x - y).abs() / y.clamp_min(1e-12)).max())
                  for x, y in zip(a.k_scale + a.v_scale,
                                  b.k_scale + b.v_scale)) if quant else 0.0)
    return dict(rows=rows, steps=rows if quant else None, scales=scales,
                width=a.k[0].shape[-1],
                pos=bool(torch.equal(a.pos, b.pos)))


def server_job(mesh, params_np, cfg, voices, reqs, mid, lanes, kw,
               engine_kw=None):
    """A ContinuousBatchingServer on the mesh at temp 0: the first `mid`
    requests, one chunk, the rest (admitted mid-decode), drained (engine_kw:
    TTSEngine's quantize options). Returns each request's pcm and
    admission chunk, and the calls of each of ROUTES."""
    eng = engine(params_np, cfg, **(engine_kw or {}))
    calls = count_routes()
    srv = ContinuousBatchingServer(eng, lanes=lanes, chunk_frames=4,
                                   text_bucket=32, mesh=mesh, **kw)
    srv.register_voices(voices)
    out = [srv.submit(t, v, temp=0.0) for t, v in reqs[:mid]]
    srv.step()
    out += [srv.submit(t, v, temp=0.0) for t, v in reqs[mid:]]
    srv.run_pending()
    return dict(coords=coords(mesh), pcm=[r.pcm for r in out],
                admit=[r.admit_step for r in out],
                compactions=srv.compactions,
                width=srv.batch.flow.k[0].shape[-1],
                lanes=srv.batch.lanes, calls=dict(calls))


def multistream_job(mesh, params_np, cfg, voices, reqs, max_batch,
                    engine_kw=None):
    eng = engine(params_np, cfg, **(engine_kw or {}))
    srv = MultiStreamServer(eng, max_batch=max_batch, chunk_frames=5,
                            mesh=mesh)
    srv.register_voices(voices)
    out = [srv.submit(t, v, temp=0.0) for t, v in reqs]
    srv.run_pending()
    return [r.pcm for r in out]


def batched_engine_job(mesh, params_np, cfg, prompts, texts,
                       engine_kw=None):
    be = tb.BatchedEngine(engine(params_np, cfg, **(engine_kw or {})), mesh)
    return be.synthesize_batch(texts, be.prime_voices(prompts), temp=0.0)


def cache_engine_job(mesh, path, cfg, prompts, texts):
    """BatchedEngine on the mesh over an engine loaded from a params cache
    (safetensors or GGUF): the streams' pcm."""
    eng = TTSEngine.from_params_cache(path, cfg, seed=0, device="cpu",
                                      tokenizer=MockTokenizer(cfg.lut.n_bins))
    be = tb.BatchedEngine(eng, mesh)
    return be.synthesize_batch(texts, be.prime_voices(prompts), temp=0.0)


def tts_decode_job(mesh, params_np, cfg, prompt, tokens, n, fae, max_steps,
                   scan_len, quantize=None):
    """tts.decode_sentence solo with the mesh cfg's prime and prefill
    (register_voices' solo route on a mesh): pcm, valid and the calls of
    each of ROUTES (quantize: the weights', see `params`)."""
    cfg_m = tb.mesh_cfg(cfg, mesh)
    p = sharding.shard_params(params(params_np, quantize), mesh, cfg_m)
    calls = count_routes()
    state = backbone.init_state(cfg_m.backbone)
    state = tts.prime_voice(p, cfg_m, state, torch.from_numpy(prompt),
                            prompt.shape[0])
    st = tts.sentence_prefill(p, cfg_m, state, torch.from_numpy(tokens), n)
    _, pcm, valid = tts.decode_sentence(
        p, cfg_m, st, lambda i: torch.zeros(cfg.latent_dim), fae, max_steps,
        scan_len)
    return pcm.numpy(), valid.numpy(), dict(calls)


def fail_on_rank1(mesh):
    if sharding.axis_rank(mesh, "model") == 1:
        raise ValueError("rank 1 fails")
    return 0


def die_on_rank1(mesh):
    """Rank 1 exits without a reply (as a crash would)."""
    if sharding.axis_rank(mesh, "model") == 1:
        import os
        os._exit(3)
    return 0


def build_dir_job(mesh):
    """The kernel library's build directory this rank was handed."""
    from pocket_tts_tpu_torch.ops import cuda_lib
    return cuda_lib.build_dir()


def stall_job(mesh, seconds):
    """Hold the rank in a job (as a collective that never ends would)."""
    import time
    time.sleep(seconds)
    return 0
