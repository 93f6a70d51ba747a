"""FlowLM: conditioning -> autoregressive latent generation.

Counterpart of `pocket_tts_tpu/models/flow_lm.py`:
  prefill      push conditioning rows (voice prompt or text tokens) through
               the backbone, filling KV;
  decode_step  one 80 ms frame: backbone step on the previous latent, EOS
               head, one flow-matching step on the given noise.
The backbone state is updated in place (see models/backbone.py).
`prefill_lanes` and `decode_step_lanes` do the same for B lanes
(continuous batching): the rows of all lanes go through each linear as one
matrix; with int8 or int4 weights the decode step's flow net runs as ONE
launch of kernel K6 over the B rows (ops/fused_flow.py), as the JAX
package's vmap rule runs it. On a mesh (`cfg.on_mesh`) the flow net
never takes K6, as the JAX package pins it off there: the net is whole on
every rank, and its quantized linears run one K4a / K4b call each
(flow_mlp.forward with fused=False).
"""
from __future__ import annotations

from . import backbone, flow_mlp
from ..ops.basic import layer_norm, linear


def embed_tokens(p, tokens):
    """LUT conditioner. Ids outside the table clamp to its edge, as a jnp
    gather does."""
    table = p["conditioner"]["embed"]
    return table[tokens.clamp(0, table.shape[0] - 1)]


def prefill(p, cfg, state: backbone.BackboneState, emb, n_valid: int):
    """Fill backbone KV with T (padded) rows; only the first n_valid are
    real (the rest get position -1). emb: (T, d_model)."""
    state, _ = backbone.forward(p, cfg.backbone, state, emb, n_valid,
                                cfg.gelu_approx)
    return backbone.advance(state, emb.shape[0], n_valid)


def decode_step(p, cfg, state: backbone.BackboneState, prev_latent, noise):
    """One autoregressive step. prev_latent: (latent,) (bos_emb on the first
    step); noise: (latent,). Returns (state, latent, eos) with eos a 0-d
    bool tensor on the device (logit > cfg.eos_threshold, i.e. -4)."""
    x = linear(p["input_linear"], prev_latent)[None, :]
    state, h = backbone.forward(p, cfg.backbone, state, x, 1,
                                cfg.gelu_approx)
    backbone.advance(state, 1, 1)
    h = layer_norm(p["out_norm"], h, eps=1e-5)[-1]
    is_eos = linear(p["out_eos"], h)[0] > cfg.eos_threshold
    latent = flow_mlp.sample_latent(p["flow_net"], h, noise,
                                    p.get("_time_cond"), not cfg.on_mesh)
    return state, latent, is_eos


def denormalize(p, latent):
    """emb_std * latent + emb_mean."""
    return p["emb_std"] * latent + p["emb_mean"]


def prefill_lanes(p, cfg, state: backbone.BatchedBackboneState, emb,
                  n_valid):
    """prefill for B lanes: emb (B, T, d_model), n_valid (B,) int tensor."""
    state, _ = backbone.forward_lanes(p, cfg.backbone, state, emb, n_valid,
                                      cfg.gelu_approx)
    return backbone.advance_lanes(state, emb.shape[1], n_valid)


def decode_step_lanes(p, cfg, state: backbone.BatchedBackboneState,
                      prev_latent, noise):
    """One step of B lanes: prev_latent, noise (B, latent). Returns (state,
    latent (B, latent), eos (B,) bool on the device)."""
    x = linear(p["input_linear"], prev_latent)[:, None, :]
    state, h = backbone.forward_lanes(p, cfg.backbone, state, x, None,
                                      cfg.gelu_approx)
    backbone.advance_lanes(state, 1, 1)
    h = layer_norm(p["out_norm"], h, eps=1e-5)[:, -1]
    is_eos = linear(p["out_eos"], h)[:, 0] > cfg.eos_threshold
    latent = flow_mlp.sample_latent(p["flow_net"], h, noise,
                                    p.get("_time_cond"), not cfg.on_mesh)
    return state, latent, is_eos
