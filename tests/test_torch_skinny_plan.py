"""How the skinny row-block product (csrc/fused_layer.cu `skinny_kernel`:
bf16 calls below MMA_ROWS rows, K5a at T = 1) and K4b on the row-block
routes cut their work, checked on the CPU:

- `skinny_plan`: at DEFAULT_CONFIG's and tiny_config(64)'s linears (and
  input_linear, K = 32), for int8, int4 and q4_0 at 1, 2 and 15 rows, the
  blocks' units (a 32-column tile x a slice of the stored rows) cover every
  stored weight byte once, a tile's slices are the consecutive blocks of one
  cluster of at most 8, a slice is what the TMA's box and q4_0's groups
  take, and the shared-memory regions hold what the kernel puts there
  (128-byte aligned, no overlap, within 232448 bytes);
- a plain model of the kernel's arithmetic (each slice's float32 partial,
  q4_0 nibbles times their group's scale, the slices summed in rank order,
  per-channel scales after the sum) equals `pre_attention_plain` and the
  JAX package's `pre_attention` in interpret mode, float32 within 1e-5
  relative; so does K4b's (the skinny kernel below 16 rows, the tensor
  cores' k16 partials from 16, a last k-tile of 16 packed rows at K = 32)
  against `int4_matmul_plain` and `int4_matmul_pallas(interpret=True)`;
- at the shapes a rank of a mesh gives K4a / K4b (chip_smoke.
  mesh_k4_shapes: column shards at "model" 2 and 4, the whole out_proj /
  linear2, the flow net's linears), int8, int4 and q4_0: the skinny plan
  at 2 rows as above, and the skinny (2 rows) and tensor-core (16 and 256
  rows) models equal the plain product;
- the route (dtype, rows) -> kernel of `rows_route`, K4b's included, on a
  stand-in for the kernel library (which entry point a call reaches, and
  which counter counts it).
"""
import ctypes

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import chip_smoke
from pocket_tts_tpu.config import tiny_config as j_tiny_config
from pocket_tts_tpu.io.params import params_from_flat, random_flat
from pocket_tts_tpu.io.quant import quantize_params as j_quantize
from pocket_tts_tpu.ops import fused_layer as j_fused_layer
from pocket_tts_tpu.ops import quant_matmul as j_qmm
from pocket_tts_tpu.ops.basic import slice_layer_params as j_slice
from pocket_tts_tpu_torch.config import DEFAULT_CONFIG
from pocket_tts_tpu_torch.io.params import from_jax_numpy
from pocket_tts_tpu_torch.io.quant import _quantize_weight
from pocket_tts_tpu_torch.ops import cuda_lib, fused_layer
from pocket_tts_tpu_torch.ops import quant_matmul as qm
from pocket_tts_tpu_torch.ops.basic import layer_norm, slice_layer_params

torch.set_num_threads(1)
REL = 1e-5
CFG0 = j_tiny_config(64)
PJ, CFG = params_from_flat(random_flat(CFG0, seed=71), CFG0)
KINDS = {"int8": dict(bits=8), "int4": dict(bits=4),
         "q4_0": dict(bits=4, group=32)}
LAYOUT = {"int8": (qm.INT8, 0), "int4": (qm.INT4, 0),
          "q4_0": (qm.INT4_GROUPED, 32)}
QJ = {k: j_quantize(PJ, **kw) for k, kw in KINDS.items()}
QT = {k: from_jax_numpy(jax.tree.map(np.asarray, q)) for k, q in QJ.items()}
SMEM_MAX = 232448


def _linears(cfg):
    """(K, N, ln) of the layer linears of the backbone and the mimi decoder
    transformer (ln: a LayerNorm prologue), and input_linear (K = latent)."""
    out = [(cfg.latent_dim, cfg.backbone.d_model, False)]
    for dm, hid in ((cfg.backbone.d_model, cfg.backbone.hidden_dim),
                    (cfg.mimi.transformer.d_model,
                     cfg.mimi.transformer.hidden_dim)):
        out += [(dm, 3 * dm, True), (dm, dm, False), (dm, hid, True),
                (hid, dm, False)]
    return out


def _layout(kind, k):
    """(kind, group) as io/quant.py stores a (k, N) linear: q4_0 keeps
    per-channel scales where a half of K is not a whole number of groups."""
    kd, group = LAYOUT[kind]
    if group and (k // 2) % group:
        return qm.INT4, 0
    return kd, group


def _regions_ok(regions, smem):
    """csrc/layer_post.cuh `regions_ok` for single-unit regions."""
    if smem > SMEM_MAX:
        return False
    for i, (off, size) in enumerate(regions):
        if off % 128 or off + size > smem - fused_layer.SMEM_SLACK:
            return False
        for o2, s2 in regions[:i]:
            if off < o2 + s2 and o2 < off + size:
                return False
    return True


@pytest.mark.parametrize("rows", [1, 2, 15])
@pytest.mark.parametrize("kind", list(KINDS))
@pytest.mark.parametrize("cfg", [DEFAULT_CONFIG, CFG], ids=["default",
                                                             "tiny64"])
def test_skinny_plan_covers_every_weight_byte_once(cfg, kind, rows):
    for k, n, ln in _linears(cfg):
        check_skinny(rows, k, n, *_layout(kind, k), ln)


def check_skinny(rows, k, n, kd, group, ln):
    """skinny_plan's units cover every stored weight byte once, a tile's
    slices are one cluster, the slice count is the plan's rule, and the
    shared-memory regions hold what the kernel puts there."""
    packed = kd != qm.INT8
    plan = fused_layer.skinny_plan(rows, k, n, kd, group, ln)
    ks, srows = plan["ks"], plan["srows"]
    stored = k // 2 if packed else k
    assert ks in fused_layer.SKINNY_KS and ks <= 8
    assert ks * srows == stored and srows >= 1
    if ks > 1:
        assert srows % 32 == 0
    if group:
        assert srows % group == 0
    assert srows <= fused_layer.TMA_ROWS or srows % fused_layer.TMA_ROWS == 0
    # the grid: block u takes tile u // ks, slice u % ks; the ks blocks
    # of a cluster are u = c * ks .. c * ks + ks - 1, one tile
    assert plan["grid"] == n // 32 * ks
    seen = np.zeros((stored, n), dtype=int)
    for u in range(plan["grid"]):
        tile, q = divmod(u, ks)
        seen[q * srows:(q + 1) * srows, tile * 32:(tile + 1) * 32] += 1
        assert u // ks == tile       # the cluster holds one tile
    assert (seen == 1).all()
    # the fewest slices whose slab is within SKINNY_SLAB, else the most
    valid = fused_layer.skinny_slices(stored, kd, group)
    fit = [q for q in valid
           if stored // q * 32 <= fused_layer.SKINNY_SLAB]
    assert ks == (fit[0] if fit else valid[-1])
    # the regions hold what the kernel puts there
    unit = fused_layer.col_unit_bytes(kd, k, ks, group)
    aw = srows * (2 if packed else 1)
    regions = [(plan["o_w"], unit),
               (plan["o_x"], 4 * rows * (k if ln else aw)),
               (plan["o_lnv"], 8 * k if ln else 0),
               (plan["o_red"], 4 * fused_layer.COOP_RED_FLOATS),
               (plan["o_out"], 4 * rows * 32)]
    assert _regions_ok(regions, plan["smem"]), (k, n, plan)


MESH = sorted({(k, n): name for model in (2, 4) for name, k, n in
               chip_smoke.mesh_k4_shapes(DEFAULT_CONFIG, model)}.items())


@pytest.mark.parametrize("kind", list(KINDS))
@pytest.mark.parametrize("k,n", [kn for kn, _ in MESH],
                         ids=[f"{k}x{n}" for (k, n), _ in MESH])
def test_k4_at_mesh_rank_shapes(k, n, kind):
    """A rank's K4a / K4b shapes: the skinny plan at 2 rows; the skinny
    model at 2 rows and the tensor-core model at 16 and 256 rows equal
    the plain product (io/quant.py's layout: q4_0 keeps per-channel scales
    at K = 32)."""
    rng = np.random.RandomState(k + n)
    w = (rng.randn(k, n) * 0.05).astype(np.float32)
    kw = KINDS[kind]
    lin = _quantize_weight(w, kw["bits"], kw.get("group", 0))
    kd, group = _layout(kind, k)
    assert qm.grouped(lin) == bool(group)
    check_skinny(2, k, n, kd, group, False)
    for rows in (2, 16, 256):
        x = torch.from_numpy((rng.randn(rows, k) * 0.5).astype(np.float32))
        if rows < fused_layer.MMA_ROWS:
            got = skinny_model(x, lin, fused_layer.skinny_plan(
                rows, k, n, kd, group, False)["ks"])
        else:
            fused_layer._mma_check("rows_mma", k, n, kd, group, False)
            got = mma_model(x, lin, fused_layer.rows_plan(
                rows, k, n, kd != qm.INT8))
        close_rel(got, qm.deq_dot(x, lin))


def test_skinny_plan_at_the_backbone_in_proj():
    """DEFAULT_CONFIG's in_proj at T = 1: 96 column tiles in one slice, 96
    blocks without a cluster (32 KB of int8 or 16 KB of int4 each);
    linear2 (K = 4096) in 4 slices of 32 KB; input_linear (K = 32, 16
    packed rows) in one slice."""
    for kind, unit in (("int8", 32768), ("int4", 16384)):
        kd, group = LAYOUT[kind]
        plan = fused_layer.skinny_plan(1, 1024, 3072, kd, group, True)
        assert (plan["ks"], plan["grid"]) == (1, 96)
        assert fused_layer.col_unit_bytes(kd, 1024, 1, group) == unit
    plan = fused_layer.skinny_plan(1, 4096, 1024, qm.INT8)
    assert (plan["ks"], plan["grid"]) == (4, 128)
    plan = fused_layer.skinny_plan(1, 32, 1024, qm.INT4, 0, False)
    assert (plan["ks"], plan["srows"], plan["grid"]) == (1, 16, 32)


def test_skinny_plan_raises_on_widths_it_does_not_take():
    with pytest.raises(ValueError, match="skinny"):
        fused_layer.skinny_plan(1, 256, 48, qm.INT8)        # N % 32
    with pytest.raises(ValueError, match="skinny"):
        fused_layer.skinny_plan(1, 256, 64, qm.INT8, ks=3)  # not a slice
    with pytest.raises(ValueError, match="skinny"):
        fused_layer.skinny_plan(1, 8192, 64, qm.INT8, ln=True)
    with pytest.raises(ValueError, match="shared memory"):
        fused_layer.skinny_plan(15, 4096, 4096, qm.INT8, ln=True)


# ------------------------------------------------- plain models, float32 ---

def _weights(lin):
    """(logical rows as float (K, N), packed, per-channel scale or None,
    grouped scales (K / group, N) or None, group)."""
    if "q" in lin:
        return lin["q"].float(), False, lin["scale"].float(), None, 0
    w = qm.unpack_int4(lin["q4"])
    if qm.grouped(lin):
        gs = lin["scale"].float()
        return w, True, None, gs, w.shape[0] // gs.shape[0]
    return w, True, lin["scale"].float(), None, 0


def skinny_model(x, lin, ks):
    """skinny_kernel's sum for x (rows, K) float32 (rounded where the
    kernel rounds): slice q of the stored rows meets x's columns [q s, ..)
    (int4: and K/2 + q s.. with the high nibbles); q4_0 nibbles times their
    group's scale; each slice's float32 partial, the slices summed in rank
    order; then the per-channel scale and the bias."""
    w, packed, pc, gs, group = _weights(lin)
    if gs is not None:
        w = w * gs.repeat_interleave(group, dim=0)
    k = w.shape[0]
    stored = k // 2 if packed else k
    srows = stored // ks
    v = None
    for q in range(ks):
        idx = list(range(q * srows, (q + 1) * srows))
        if packed:
            idx += [stored + r for r in idx]
        part = x[:, idx] @ w[idx]
        v = part if v is None else v + part
    if pc is not None:
        v = v * pc
    b = lin.get("b")
    return v if b is None else v + b.float()


def mma_model(x, lin, plan):
    """rows_mma_kernel's sum (K4b from 16 rows): k-tiles of 32 stored rows
    (the last may hold 16) in k16 steps, int4's high nibbles against x[:,
    K/2 + p..], a float32 partial a step (q4_0: times the step's scale), the
    slices summed in rank order; then scales."""
    w, packed, pc, gs, group = _weights(lin)
    k = w.shape[0]
    stored = k // 2 if packed else k
    _, splits, per = plan
    kt = -(-stored // 32)
    v = None
    for z in range(splits):
        acc = torch.zeros(x.shape[0], w.shape[1])
        for t in range(z * per, min(kt, (z + 1) * per)):
            steps = list(range(t * 32, min(t * 32 + 32, stored), 16))
            if packed:
                steps += [stored + r for r in steps]
            for r0 in steps:
                part = x[:, r0:r0 + 16] @ w[r0:r0 + 16]
                acc = acc + (part if gs is None else part * gs[r0 // group])
        v = acc if v is None else v + acc
    return v if pc is None else v * pc


def close_rel(got, want):
    want = np.asarray(want, dtype=np.float32)
    scale = np.abs(want).max()
    np.testing.assert_allclose(np.asarray(got) / scale, want / scale,
                               atol=REL, rtol=0)


def _layer(kind, which):
    if which == "backbone":
        sj, st, eps = QJ[kind]["layers"], QT[kind]["layers"], 1e-5
    else:
        sj = QJ[kind]["mimi"]["decoder_transformer"]["layers"]
        st = QT[kind]["mimi"]["decoder_transformer"]["layers"]
        eps = CFG.mimi.transformer.norm_eps
    return j_slice(sj, 1), slice_layer_params(st, 1), eps


@pytest.mark.parametrize("kind", list(KINDS))
@pytest.mark.parametrize("which", ["backbone", "mimi"])
@pytest.mark.parametrize("rows", [1, 2, 15])
def test_skinny_k5a_model_equals_plain_and_jax(rows, which, kind):
    pj, pt, eps = _layer(kind, which)
    dm = pt["norm1"]["scale"].shape[0]
    lin = pt["in_proj"]
    n = lin["scale"].shape[-1]
    kd, group = _layout(kind, dm)
    plan = fused_layer.skinny_plan(rows, dm, n, kd, group, True)
    x = (np.random.RandomState(rows * 7 + dm).randn(rows, dm) * 0.5
         ).astype(np.float32)
    xt = torch.from_numpy(x)
    got = skinny_model(layer_norm(pt["norm1"], xt, eps=eps), lin,
                       plan["ks"])
    close_rel(got, fused_layer.pre_attention_plain(pt, xt, eps))
    want = jax.vmap(lambda xi: j_fused_layer.pre_attention(
        pj, xi[None], eps=eps, interpret=True)[0])(jnp.asarray(x))
    close_rel(got, want)


@pytest.mark.parametrize("ks", [1, 2, 4])
@pytest.mark.parametrize("kind", list(KINDS))
def test_skinny_slices_sum_to_the_same_product(kind, ks):
    """Every slice count the plan may take gives the plain product (rank
    order; the partials differ only in float32 summation order)."""
    _, pt, _ = _layer(kind, "backbone")
    lin = pt["linear2"]
    k = pt["linear1"]["scale"].shape[-1]          # the hidden width
    kd, group = _layout(kind, k)
    n = lin["scale"].shape[-1]
    plan = fused_layer.skinny_plan(3, k, n, kd, group, False, ks)
    x = torch.from_numpy((np.random.RandomState(ks).randn(3, k) * 0.5)
                         .astype(np.float32))
    close_rel(skinny_model(x, lin, plan["ks"]), qm.deq_dot(x, lin))


def _k4b_case(t, k, n, group, seed):
    """x (t, k), a packed int4 linear (per-channel float32 scales, or
    bfloat16 scales of `group` rows) and the JAX kernel's product."""
    rng = np.random.RandomState(seed)
    q4 = qm.pack_int4(rng.randint(-8, 8, size=(k, n)))
    s = (rng.rand(*((k // group, n) if group else (n,))) * 0.02 + 0.01
         ).astype(np.float32)
    x = (rng.randn(t, k) * 0.5).astype(np.float32)
    sj = jnp.asarray(s).astype(jnp.bfloat16) if group else jnp.asarray(s)
    want = j_qmm.int4_matmul_pallas(jnp.asarray(x), jnp.asarray(q4), sj,
                                    interpret=True)
    st = torch.from_numpy(s)
    lin = {"q4": torch.from_numpy(q4),
           "scale": st.bfloat16() if group else st}
    return torch.from_numpy(x), lin, want


@pytest.mark.parametrize("group", [0, 32])
@pytest.mark.parametrize("t", [1, 2, 15, 16, 32])
@pytest.mark.parametrize("k,n", [(256, 384), (32, 64)])
def test_k4b_route_models_equal_plain_and_jax(k, n, t, group):
    """K4b's bf16 routes in float32 arithmetic: below 16 rows the skinny
    kernel's (ROWS_LOAD: the slice's columns only), from 16 the tensor
    cores' (K = 32: one k-tile of 16 packed rows); q4_0 at K = 32 keeps
    per-channel scales, as io/quant.py stores input_linear."""
    if k == 32 and group:
        group = 0
    x, lin, want = _k4b_case(t, k, n, group, t * 3 + k + group)
    kd = qm.INT4_GROUPED if group else qm.INT4
    if fused_layer.rows_route(torch.bfloat16, t) == "skinny":
        plan = fused_layer.skinny_plan(t, k, n, kd, group, False)
        got = skinny_model(x, lin, plan["ks"])
    else:
        got = mma_model(x, lin, fused_layer.rows_plan(t, k, n, True, 0))
    plain = qm.int4_matmul(x, lin["q4"], lin["scale"])     # CPU: plain
    close_rel(got, plain)
    close_rel(plain, qm.int4_matmul_plain(x, lin["q4"], lin["scale"]))
    # the JAX kernel's T = 1 per-channel scheme sums raw bytes and cancels
    # (test_torch_int4.py): its float32 rounding is ~16x the nibbles'
    if not (t == 1 and not group):
        close_rel(got, want)
    else:
        np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                   atol=3e-5, rtol=0)


# ------------------------------------------------------------- routes ---

def test_rows_route_three_ways():
    for rows in (1, 2, 8, 15):
        assert fused_layer.rows_route(torch.bfloat16, rows) == "skinny"
    for rows in (16, 32, 512):
        assert fused_layer.rows_route(torch.bfloat16, rows) == "mma"
    for rows in (1, 15, 16, 512):
        assert fused_layer.rows_route(torch.float32, rows) == "simt"


class FakeLib:
    """Records which entry point a launch reaches (and its plan)."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        if not name.startswith("ptt_"):
            raise AttributeError(name)

        def entry(*args):
            self.calls.append((name, args))
            return 0
        return entry


@pytest.mark.parametrize("dtype,rows,entry", [
    (torch.bfloat16, 1, "ptt_rows_skinny"),
    (torch.bfloat16, 15, "ptt_rows_skinny"),
    (torch.bfloat16, 16, "ptt_rows_mma"),
    (torch.bfloat16, 128, "ptt_rows_mma"),
    (torch.float32, 1, "ptt_fused_rows"),
    (torch.float32, 128, "ptt_fused_rows")])
@pytest.mark.parametrize("group", [0, 32])
def test_k4b_launches_the_kernel_of_its_route(group, dtype, rows, entry):
    """K4b's operands (ROWS_LOAD, EPI_ROUND, no bias) through rows_launch:
    one launch of the route's entry point, counted by no row counter; K5a
    through _rows_call counts the skinny and tensor-core launches."""
    k, n = 1024, 3072
    lin = {"q4": torch.zeros(k // 2, n, dtype=torch.int8),
           "scale": (torch.ones(k // group, n, dtype=torch.bfloat16)
                     if group else torch.ones(n))}
    x = torch.zeros(rows, k, dtype=dtype)
    y = torch.empty(rows, n, dtype=dtype)
    ops, layout = qm.kernel_operands(lin, k, n, x)
    lib = FakeLib()
    mma0 = fused_layer._rows_call.launches_mma
    sk0 = fused_layer._rows_call.launches_skinny
    route = fused_layer.rows_launch(
        lib, dtype, x, (None, None), ops, layout, None, None, y, rows, k, n,
        fused_layer.ROWS_LOAD, fused_layer.EPI_ROUND, False, 0.0, 0)
    assert [c[0] for c in lib.calls] == [entry]
    assert route == fused_layer.rows_route(dtype, rows)
    assert (fused_layer._rows_call.launches_mma,
            fused_layer._rows_call.launches_skinny) == (mma0, sk0)
    if entry == "ptt_rows_skinny":
        plan = lib.calls[0][1][-2]
        assert isinstance(plan, ctypes.Array)
        want = fused_layer.skinny_plan(rows, k, n, layout[0], layout[1])
        assert list(plan) == [want[key]
                              for key in fused_layer.SKINNY_PLAN_KEYS]
    # the counted call of K5a and K5b counts its route once more
    fused_layer._rows_call(lib, dtype, x, (None, None), ops, layout, None,
                           None, y, rows, k, n, fused_layer.ROWS_LOAD,
                           fused_layer.EPI_ROUND, False, 0.0, 0)
    assert (fused_layer._rows_call.launches_mma - mma0,
            fused_layer._rows_call.launches_skinny - sk0) == {
        "ptt_rows_mma": (1, 0), "ptt_rows_skinny": (0, 1),
        "ptt_fused_rows": (0, 0)}[entry]


def test_skinny_route_raises_and_never_takes_another_kernel():
    """A width the skinny kernel does not take raises ValueError before any
    launch (N not a multiple of 32)."""
    k, n = 256, 48
    lin = {"q": torch.zeros(k, n, dtype=torch.int8), "scale": torch.ones(n)}
    x = torch.zeros(1, k, dtype=torch.bfloat16)
    ops, layout = qm.kernel_operands(lin, k, n, x)
    lib = FakeLib()
    with pytest.raises(ValueError, match="skinny"):
        fused_layer.rows_launch(
            lib, torch.bfloat16, x, (None, None), ops, layout, None, None,
            torch.empty(1, n, dtype=torch.bfloat16), 1, k, n,
            fused_layer.ROWS_LOAD, fused_layer.EPI_ROUND, False, 0.0, 0)
    assert lib.calls == []


def test_cuda_library_has_no_int4_matmul_entry():
    """K4b has no kernel of its own: the row-block entry points serve it."""
    assert "ptt_int4_matmul" not in cuda_lib.SIGNATURES
    assert "ptt_rows_skinny" in cuda_lib.SIGNATURES
