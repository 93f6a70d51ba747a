"""How the tensor-core product behind K5a / K5b over many rows
(csrc/fused_layer.cu `rows_mma_kernel`, csrc/qmma.cuh) and the K6 flow net
on a thread-block cluster (csrc/fused_flow.cu) cut their work, checked on
the CPU:

- `rows_plan`: at DEFAULT_CONFIG's and tiny_config(64)'s linears, from 1 to
  128 lanes, the output tiles cover every (row, column) once and the
  reduction slices every k-tile once, none empty, within a portable cluster
  and the card's shared memory; so at the shapes a rank of a mesh gives
  K4a / K4b (chip_smoke.mesh_k4_shapes) at 16 and 256 rows;
- the K6 chain's column split (`flow_cols`) covers each step's columns once
  on clusters of 16 and 8 blocks, and `flow_plan` keeps a block's shared
  memory within 227 KB at DEFAULT_CONFIG for int8, int4 and q4_0;
- a plain model of the new arithmetic (bf16 operands rounded where the
  kernels round them, float32 sums per k16 step, the int4 low / high
  pairing of a stored k-tile, q4_0 partials scaled per k16 step, split-K
  partials summed in rank order; for K6 the LayerNorm statistics combined
  from the blocks' column pairs) equals the plain versions
  (`pre_attention_plain`, `post_attention_plain`, `flow_forward_plain`),
  float32 within 1e-5 relative, and the JAX package's fused functions on
  tiny_config(64) quantized to int8, int4 and q4_0 by the JAX package;
- the route (dtype, rows) -> kernel that the wrappers' docstrings state.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import chip_smoke
from pocket_tts_tpu.config import tiny_config as j_tiny_config
from pocket_tts_tpu.io.params import params_from_flat, random_flat
from pocket_tts_tpu.io.quant import quantize_params as j_quantize
from pocket_tts_tpu.models import flow_mlp as j_flow_mlp
from pocket_tts_tpu.ops import fused_flow as j_fused_flow
from pocket_tts_tpu.ops import fused_layer as j_fused_layer
from pocket_tts_tpu.ops.basic import slice_layer_params as j_slice
from pocket_tts_tpu_torch.config import DEFAULT_CONFIG
from pocket_tts_tpu_torch.io.params import from_jax_numpy
from pocket_tts_tpu_torch.ops import fused_flow, fused_layer
from pocket_tts_tpu_torch.ops import quant_matmul as qm
from pocket_tts_tpu_torch.ops.basic import (gelu, layer_norm, silu,
                                            slice_layer_params)
from pocket_tts_tpu_torch.ops.quant_matmul import grouped, unpack_int4

torch.set_num_threads(1)
REL = 1e-5
CFG0 = j_tiny_config(64)
PJ, CFG = params_from_flat(random_flat(CFG0, seed=61), CFG0)
KINDS = {"int8": dict(bits=8), "int4": dict(bits=4),
         "q4_0": dict(bits=4, group=32)}
QJ = {k: j_quantize(PJ, **kw) for k, kw in KINDS.items()}
QT = {k: from_jax_numpy(jax.tree.map(np.asarray, q)) for k, q in QJ.items()}


def _linears(cfg):
    """(K, N) of the layer linears of the backbone and the mimi decoder
    transformer, with the rows a lane gives each: [(K, N, T, ln)]; ln: the
    product's A operand is a LayerNorm of whole rows."""
    out = []
    for dm, hid, t in ((cfg.backbone.d_model, cfg.backbone.hidden_dim, 1),
                       (cfg.mimi.transformer.d_model,
                        cfg.mimi.transformer.hidden_dim, 16)):
        out += [(dm, 3 * dm, t, True), (dm, dm, t, False),
                (dm, hid, t, True), (hid, dm, t, False)]
    return out


def covered_once(total, step, parts):
    seen = np.zeros(parts * step, dtype=int)
    for lo in range(0, parts * step, step):
        seen[lo:lo + step] += 1
    return (seen[:total] == 1).all()


@pytest.mark.parametrize("cfg", [DEFAULT_CONFIG, CFG], ids=["default",
                                                             "tiny64"])
@pytest.mark.parametrize("packed", [False, True], ids=["int8", "int4"])
def test_rows_plan_covers_outputs_and_k_tiles_once(cfg, packed):
    for k, n, t, ln in _linears(cfg):
        for lanes in (1, 2, 4, 16, 32, 64, 128):
            check_rows_plan(lanes * t, k, n, packed, ln)


def check_rows_plan(rows, k, n, packed, ln):
    bm, splits, per = fused_layer.rows_plan(rows, k, n, packed,
                                            4 if ln else 0)
    assert bm in fused_layer.MMA_BMS
    assert 1 <= splits <= fused_layer.MMA_MAX_SPLITS
    # output tiles: ceil(rows / bm) x ceil(n / 64), each output once
    assert covered_once(rows, bm, -(-rows // bm))
    assert covered_once(n, fused_layer.MMA_BN, -(-n // fused_layer.MMA_BN))
    # k-tiles of MMA_BKS stored rows (the last may hold 16), split in
    # slices of `per`
    kt = -(-(k // 2 if packed else k) // fused_layer.MMA_BKS)
    slices = [(z * per, min(kt, (z + 1) * per)) for z in range(splits)]
    assert all(lo < hi for lo, hi in slices), (k, n, rows, slices)
    seen = np.zeros(kt, dtype=int)
    for lo, hi in slices:
        seen[lo:hi] += 1
    assert (seen == 1).all()
    a_bytes = bm * per * fused_layer.MMA_BKS * (2 if packed else 1) * 2
    assert a_bytes <= fused_layer.MMA_A_BYTES
    smem = fused_layer.rows_mma_smem(bm, per, packed, k, 4 if ln else 0)
    assert smem <= fused_layer.SMEM_MAX


MESH = sorted({(k, n) for model in (2, 4) for _, k, n in
               chip_smoke.mesh_k4_shapes(DEFAULT_CONFIG, model)})


@pytest.mark.parametrize("rows", [16, 256])
@pytest.mark.parametrize("packed", [False, True], ids=["int8", "int4"])
@pytest.mark.parametrize("k,n", MESH, ids=[f"{k}x{n}" for k, n in MESH])
def test_rows_plan_at_mesh_rank_shapes(k, n, packed, rows):
    """A rank's K4 shapes on the tensor-core row-block kernel: the widths
    it takes (q4_0's groups of 32 too), one cover of outputs and
    k-tiles."""
    kinds = ([(qm.INT4, 0)] + ([(qm.INT4_GROUPED, 32)] if k % 64 == 0
                                else [])
             if packed else [(qm.INT8, 0)])
    for kind, group in kinds:
        fused_layer._mma_check("rows_mma", k, n, kind, group, False)
    check_rows_plan(rows, k, n, packed, False)


def test_rows_plan_fills_the_card_at_32_lanes():
    """At the serving mode's shapes (32 backbone rows, 512 mimi rows) every
    product's grid fills at least two thirds of the SMs."""
    for k, n, t, ln in _linears(DEFAULT_CONFIG):
        for packed in (False, True):
            bm, splits, _ = fused_layer.rows_plan(32 * t, k, n, packed,
                                                  4 if ln else 0)
            blocks = -(-32 * t // bm) * -(-n // 64) * splits
            assert blocks >= 88, (k, n, t, blocks)


@pytest.mark.parametrize("csize", fused_flow.CLUSTERS)
def test_flow_chain_columns_covered_once(csize):
    for cfg in (DEFAULT_CONFIG, CFG):
        f = cfg.flow
        for n in (f.dim, f.mlp_hidden, cfg.latent_dim):
            cw = fused_flow.flow_cols(n, csize)
            assert cw % 8 == 0
            seen = np.zeros(csize * cw, dtype=int)
            for q in range(csize):
                lo, hi = q * cw, min(n, (q + 1) * cw)
                seen[lo:max(lo, hi)] += 1
            assert (seen[:n] == 1).all() and seen[n:].sum() == 0


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("kind", list(KINDS))
def test_flow_plan_fits_shared_memory(kind, dtype):
    c, f = DEFAULT_CONFIG, DEFAULT_CONFIG.flow
    packed, group = kind != "int8", 32 if kind == "q4_0" else 0
    for csize in fused_flow.CLUSTERS:
        for rows in (1, 4, 15, 16, 32, 40, 64, 128):
            plan = fused_flow.flow_plan(c.backbone.d_model, f.dim,
                                        f.mlp_hidden, c.latent_dim, f.depth,
                                        rows, dtype, packed, group, csize)
            assert plan["chain_smem"] <= 227 * 1024
            assert plan["mods_smem"] <= 227 * 1024
            assert plan["nslot"] >= 1
            assert plan["mma"] == (dtype == torch.bfloat16
                                   and rows >= fused_flow.FLOW_MMA_ROWS)
            assert plan["rb"] <= (64 if plan["mma"] else 16)
            # rows past a row block take more clusters of the same launches
            assert -(-rows // plan["rb"]) * plan["rb"] >= rows


def test_routes_are_what_the_docstrings_state():
    assert fused_layer.rows_route(torch.bfloat16, 16) == "mma"
    assert fused_layer.rows_route(torch.bfloat16, 512) == "mma"
    assert fused_layer.rows_route(torch.bfloat16, 15) == "skinny"
    assert fused_layer.rows_route(torch.bfloat16, 1) == "skinny"
    assert fused_layer.rows_route(torch.float32, 512) == "simt"
    assert fused_layer.rows_route(torch.float32, 1) == "simt"
    assert fused_layer.MMA_ROWS == 16
    assert fused_flow.LAUNCHES == 2


# ------------------------------------------------- plain models, float32 ---

def _weights(lin):
    """(stored rows as float (S, N), packed, per-channel scale or None,
    grouped scales (K / group, N) or None, group)."""
    if "q" in lin:
        return lin["q"].float(), False, lin["scale"].float(), None, 0
    q = lin["q4"].to(torch.int16)
    w = torch.cat([(q & 15) - 8, q >> 4]).float()   # logical rows
    if grouped(lin):
        gs = lin["scale"].float()
        return w, True, None, gs, w.shape[0] // gs.shape[0]
    return w, True, lin["scale"].float(), None, 0


def mma_model(x, lin, plan):
    """rows_mma_kernel's sum for x (rows, K) float32 (already rounded
    where the kernel rounds): k-tiles of MMA_BKS stored rows, each in k16
    steps
    (int4: the low nibbles against x[:, p..], the high ones against
    x[:, K/2 + p..]), a float32 partial per step (grouped: times the step's
    scale), slices summed in rank order; then scales and bias."""
    w, packed, pc, gs, group = _weights(lin)
    k = w.shape[0]
    stored = k // 2 if packed else k
    _, splits, per = plan
    parts = []
    for z in range(splits):
        acc = torch.zeros(x.shape[0], w.shape[1])
        bks = fused_layer.MMA_BKS
        for kt in range(z * per, min(stored // bks, (z + 1) * per)):
            p = kt * bks
            steps = list(range(p, p + bks, 16))
            if packed:
                steps += [k // 2 + r for r in steps]
            for r0 in steps:
                part = x[:, r0:r0 + 16] @ w[r0:r0 + 16]
                if gs is not None:
                    part = part * gs[r0 // group]
                acc = acc + part
        parts.append(acc)
    v = parts[0]
    for part in parts[1:]:
        v = v + part
    if pc is not None:
        v = v * pc
    b = lin.get("b")
    return v if b is None else v + b.float()


def _plan(x, lin):
    return fused_layer.rows_plan(x.shape[0], x.shape[1],
                                 lin["scale"].shape[-1], "q4" in lin)


def pre_model(p, x, eps):
    ln = layer_norm(p["norm1"], x, eps=eps)
    return mma_model(ln, p["in_proj"], _plan(ln, p["in_proj"]))


def post_model(p, x, attn, eps):
    ls1 = p.get("layer_scale_1", {}).get("scale")
    ls2 = p.get("layer_scale_2", {}).get("scale")
    proj = mma_model(attn, p["out_proj"], _plan(attn, p["out_proj"]))
    x1 = x + (proj if ls1 is None else ls1 * proj)
    ln = layer_norm(p["norm2"], x1, eps=eps)
    h = gelu(mma_model(ln, p["linear1"], _plan(ln, p["linear1"])), False)
    up = mma_model(h, p["linear2"], _plan(h, p["linear2"]))
    return x1 + (up if ls2 is None else ls2 * up)


def close_rel(got, want):
    want = np.asarray(want, dtype=np.float32)
    scale = np.abs(want).max()
    np.testing.assert_allclose(np.asarray(got) / scale, want / scale,
                               atol=REL, rtol=0)


def _layer(kind, which):
    if which == "backbone":
        sj, st = QJ[kind]["layers"], QT[kind]["layers"]
        eps, t = 1e-5, 1
    else:
        sj = QJ[kind]["mimi"]["decoder_transformer"]["layers"]
        st = QT[kind]["mimi"]["decoder_transformer"]["layers"]
        eps, t = CFG.mimi.transformer.norm_eps, 16
    return j_slice(sj, 1), slice_layer_params(st, 1), eps, t


@pytest.mark.parametrize("kind", list(KINDS))
@pytest.mark.parametrize("which,lanes", [("backbone", 32), ("mimi", 4),
                                         ("mimi", 32)])
def test_rows_mma_model_equals_plain_and_jax(which, lanes, kind):
    pj, pt, eps, t = _layer(kind, which)
    dm = pt["norm1"]["scale"].shape[0]
    rng = np.random.RandomState(lanes + t)
    x = (rng.randn(lanes, t, dm) * 0.5).astype(np.float32)
    attn = (rng.randn(lanes, t, dm) * 0.5).astype(np.float32)
    xt, at = torch.from_numpy(x), torch.from_numpy(attn)
    pre = pre_model(pt, xt.reshape(-1, dm), eps)
    close_rel(pre, fused_layer.pre_attention_plain(pt, xt.reshape(-1, dm),
                                                   eps))
    want = jax.vmap(lambda xi: j_fused_layer.pre_attention(
        pj, xi, eps=eps, interpret=True))(jnp.asarray(x))
    close_rel(pre.reshape(want.shape), want)
    post = post_model(pt, xt.reshape(-1, dm), at.reshape(-1, dm), eps)
    close_rel(post, fused_layer.post_attention_plain(
        pt, xt.reshape(-1, dm), at.reshape(-1, dm), eps))
    want = jax.vmap(lambda xi, ai: j_fused_layer.post_attention(
        pj, xi, ai, eps=eps, interpret=True))(jnp.asarray(x),
                                              jnp.asarray(attn))
    close_rel(post.reshape(want.shape), want)


def test_rows_mma_model_bf16_rounds_where_the_plain_version_rounds():
    """In bf16 the kernel's operands are the plain version's (LN rounded,
    h rounded); the model with bf16 operands stays within chip_smoke.py's
    1e-2 relative of the plain version."""
    pt = slice_layer_params(QT["q4_0"]["layers"], 0)
    pt = {k: ({kk: (vv.bfloat16() if vv.dtype == torch.float32
                    and kk != "scale" or k.startswith("norm") else vv)
               for kk, vv in v.items()} if isinstance(v, dict) else v)
          for k, v in pt.items()}
    dm = pt["norm1"]["scale"].shape[0]
    x = torch.from_numpy(np.random.RandomState(3).randn(32, dm).astype(
        np.float32) * 0.5).bfloat16()
    ln = layer_norm(pt["norm1"], x, eps=1e-5).bfloat16().float()
    got = mma_model(ln, pt["in_proj"], _plan(ln, pt["in_proj"])).bfloat16()
    want = fused_layer.pre_attention_plain(pt, x, 1e-5)
    err = (got.float() - want.float()).abs().max() / want.float().abs().max()
    assert err <= 1e-2


def chain_model(p, c, x, tc, csize):
    """K6 as the cluster computes it: h and u split into the blocks'
    columns (flow_cols), each block's (sum, M2 about its own mean) of its
    h columns combined into the row's mean and variance, every product the
    float32 dot of the rounded operand."""
    rb = p["res_blocks"]
    dim = tc.shape[0]
    cw = fused_flow.flow_cols(dim, csize)

    def dot(v, lin):
        from pocket_tts_tpu_torch.ops.quant_matmul import deq_dot
        y = deq_dot(v, lin)
        return y if lin.get("b") is None else y + lin["b"].float()

    def stats(h):
        sums, m2s, ns = [], [], []
        for q in range(csize):
            cols = h[:, q * cw:min(dim, (q + 1) * cw)]
            if cols.shape[1] == 0:
                continue
            s = cols.sum(-1)
            mq = s / cols.shape[1]
            sums.append(s)
            m2s.append(((cols - mq[:, None]) ** 2).sum(-1))
            ns.append(cols.shape[1])
        mean = sum(sums) / dim
        m2 = sum(m2 + n * (s / n - mean) ** 2
                 for s, m2, n in zip(sums, m2s, ns))
        return mean[:, None], torch.rsqrt(m2 / dim + 1e-6)[:, None]

    def modulate(h, norm, shift, scale):
        mean, rstd = stats(h)
        y = (h - mean) * rstd
        if norm is not None and norm.get("scale") is not None:
            y = y * norm["scale"].float()
        if norm is not None and norm.get("bias") is not None:
            y = y + norm["bias"].float()
        return y * (1.0 + scale) + shift

    sy = silu(tc.float() + dot(c, p["cond_embed"]))
    h = dot(x, p["input_proj"])
    for i in range(rb["adaln"]["scale"].shape[0]):
        blk = slice_layer_params(rb, i)
        shift, scale, gate = dot(sy, blk["adaln"]).chunk(3, -1)
        hn = modulate(h, blk.get("in_ln"), shift, scale)
        h = h + gate * dot(silu(dot(hn, blk["mlp_0"])), blk["mlp_2"])
    shift, scale = dot(sy, p["final"]["adaln"]).chunk(2, -1)
    hn = modulate(h, p["final"].get("norm"), shift, scale)
    return dot(hn, p["final"]["linear"])


@pytest.mark.parametrize("csize", fused_flow.CLUSTERS)
@pytest.mark.parametrize("kind", list(KINDS))
def test_flow_chain_model_equals_plain_and_jax(kind, csize):
    fj, ft = QJ[kind]["flow_net"], QT[kind]["flow_net"]
    rng = np.random.RandomState(7)
    c = (rng.randn(4, CFG.backbone.d_model) * 0.3).astype(np.float32)
    x = (rng.randn(4, CFG.latent_dim) * 0.5).astype(np.float32)
    tc = np.asarray(j_flow_mlp.time_cond(PJ["flow_net"]))
    got = chain_model(ft, torch.from_numpy(c), torch.from_numpy(x),
                      torch.from_numpy(tc), csize)
    close_rel(got, fused_flow.flow_forward_plain(
        ft, torch.from_numpy(c), torch.from_numpy(x), torch.from_numpy(tc)))
    want = jax.vmap(lambda ci, xi: j_fused_flow.flow_forward(
        fj, ci, xi, tc, interpret=True))(jnp.asarray(c), jnp.asarray(x))
    close_rel(got, want)


def test_default_flow_split_and_statistics_at_full_width():
    """DEFAULT_CONFIG's dim over 16 and 8 blocks: 32 and 64 columns each,
    and the combined statistics equal the row's own mean and variance."""
    dim = DEFAULT_CONFIG.flow.dim
    assert [fused_flow.flow_cols(dim, c) for c in (16, 8)] == [32, 64]
    h = torch.from_numpy(np.random.RandomState(1).randn(3, dim).astype(
        np.float32) * 3 + 1)
    for csize in (16, 8):
        cw = fused_flow.flow_cols(dim, csize)
        blocks = h.split(cw, -1)
        s = sum(b.sum(-1) for b in blocks)
        mean = s / dim
        m2 = sum(((b - b.mean(-1, keepdim=True)) ** 2).sum(-1)
                 + b.shape[1] * (b.mean(-1) - mean) ** 2 for b in blocks)
        np.testing.assert_allclose(mean, h.mean(-1), rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(m2 / dim, h.var(-1, unbiased=False),
                                   rtol=1e-5)
