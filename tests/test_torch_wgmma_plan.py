"""How K4a's warpgroup kernel (csrc/wgmma_matmul.cu `wgmma_int8_kernel`:
bf16 calls of WGMMA_ROWS rows or more) cuts its work, and K4a's four-way
route, checked on the CPU:

- `wgmma_plan`: at DEFAULT_CONFIG's four prefill linears (in_proj 1024 x
  3072, out_proj 1024 x 1024, linear1 1024 x 4096, linear2 4096 x 1024)
  at 64, 128, 130 and 256 rows, the blocks cover every output element
  once and, over a tile's cluster, every K row once, every output is
  stored by one block; the shared-memory regions fit in 232448 bytes,
  the rings sit on the swizzle's 1024-byte period, the float32 tile lies
  in the rings clear of the mbarriers; stages >= 3, clusters <= 8;
- a numpy model of the kernel's arithmetic (its tiles, each slice's
  float32 partial, the cluster's sum in rank order, the scale once in the
  epilogue) equals `int8_matmul_plain` and the JAX package's
  `int8_matmul_pallas(interpret=True)` within 1e-5 relative in float32;
- the same plan checks and model at the shapes a rank of a mesh gives
  K4a (chip_smoke.mesh_k4_shapes: the column shards of in_proj and
  linear1 at "model" 2 and 4, the whole out_proj / linear2, the flow
  net's linears) at 256 rows, the prefill's, with 2 and 16 rows on the
  row-block routes;
- `int8_route` (dtype, rows) -> simt / skinny / mma / wgmma, and on a
  stand-in for the kernel library each route launches its entry point
  once, counted in `int8_matmul.launches` only (the warpgroup kernel once
  more in `launches_wgmma`, no row counter); the library has no
  `ptt_int8_matmul` entry.
"""
import ctypes
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from pocket_tts_tpu.ops import quant_matmul as j_qmm
from pocket_tts_tpu_torch.config import DEFAULT_CONFIG
from pocket_tts_tpu_torch.ops import cuda_lib, fused_layer
from pocket_tts_tpu_torch.ops import quant_matmul as qm

torch.set_num_threads(1)
REL = 1e-5
SMEM_MAX = 232448
DM = DEFAULT_CONFIG.backbone.d_model
HID = DEFAULT_CONFIG.backbone.hidden_dim
# the prefill linears as K4a takes them: (K, N)
SHAPES = {"in_proj": (DM, 3 * DM), "out_proj": (DM, DM),
          "linear1": (DM, HID), "linear2": (HID, DM)}
ROWS = (64, 128, 130, 256)
CASES = [(name, rows) for name in SHAPES for rows in ROWS]


def _blocks(plan):
    """(z, y, x) of every block of the plan's grid."""
    sp, ny, nx = plan["grid"]
    return [(z, y, x) for z in range(sp) for y in range(ny)
            for x in range(nx)]


# the K4 shapes of one rank of a mesh, model 2 and 4 (each once)
MESH = sorted({(k, n): name for model in (2, 4) for name, k, n in
               chip_smoke.mesh_k4_shapes(DEFAULT_CONFIG, model)}.items())
MESH_CASES = [(name, k, n) for (k, n), name in MESH]
MESH_IDS = [f"{k}x{n}" for _, k, n in MESH_CASES]


@pytest.mark.parametrize("name,rows", CASES)
def test_plan_covers_every_output_and_k_row_once(name, rows):
    k, n = SHAPES[name]
    check_cover(qm.wgmma_plan(rows, k, n), rows, k, n)


def check_cover(plan, rows, k, n):
    """The blocks cover every output element once per slice and store it
    once; every K row once in a tile's cluster."""
    bt, sp, per = plan["bt"], plan["splits"], plan["kb_per"]
    kb = -(-k // qm.WGMMA_BK)
    assert plan["grid"] == (sp, -(-n // qm.WGMMA_BN), -(-rows // bt))
    # every k-block of a tile in exactly one slice, no slice empty
    slices = [range(z * per, min(kb, z * per + per)) for z in range(sp)]
    assert all(len(s) for s in slices)
    assert sorted(b for s in slices for b in s) == list(range(kb))
    kcover = np.zeros(k, np.int64)
    for s in slices:
        for b in s:
            kcover[b * qm.WGMMA_BK:min(k, (b + 1) * qm.WGMMA_BK)] += 1
    assert (kcover == 1).all()
    # every output element in one tile per slice, stored by one block
    cover = np.zeros((rows, n), np.int64)
    stored = np.zeros((rows, n), np.int64)
    for z, y, x in _blocks(plan):
        c0, t0 = y * qm.WGMMA_BN, x * bt
        cover[t0:t0 + bt, c0:c0 + qm.WGMMA_BN] += 1
        for r in range(z, bt, sp):          # block z's token rows
            if t0 + r < rows:
                stored[t0 + r, c0:c0 + qm.WGMMA_BN] += 1
    assert (cover == sp).all()
    assert (stored == 1).all()


@pytest.mark.parametrize("name,rows", CASES)
def test_plan_shared_memory_fits_and_is_aligned(name, rows):
    k, n = SHAPES[name]
    check_smem(qm.wgmma_plan(rows, k, n))


def check_smem(plan):
    """The regions fit, apart, the rings on the swizzle's period, the
    float32 tile over the rings clear of the mbarriers."""
    bt, s = plan["bt"], plan["stages"]
    assert s >= 3 and 1 <= plan["splits"] <= 8 and bt in qm.WGMMA_BTS
    rings = [(plan["o_x"], s * bt * 128), (plan["o_q"], s * qm.WGMMA_BK *
                                           qm.WGMMA_BN),
             (plan["o_w"], s * 2 * qm.WGMMA_BK * qm.WGMMA_BN)]
    bars = (plan["o_bar"], 24 * s)
    regions = rings + [bars]
    # within the shared memory left once the base is aligned to 1024
    assert plan["smem"] <= SMEM_MAX
    assert all(o >= 0 and o + size <= plan["smem"] - qm.WGMMA_ALIGN
               for o, size in regions)
    for i, (oi, si) in enumerate(regions):
        for oj, sj in regions[:i]:
            assert oi + si <= oj or oj + sj <= oi
    # the TMA's and wgmma's swizzled boxes: every stage on the 1024 period
    for o, size in rings:
        assert o % 1024 == 0 and (size // s) % 1024 == 0
    assert bars[0] % 8 == 0
    # the float32 tile over the rings, clear of the mbarriers
    c0, c1 = plan["o_c"], plan["o_c"] + bt * qm.WGMMA_CS_LD * 4
    assert c0 % 128 == 0
    assert min(o for o, _ in rings) <= c0 and c1 <= max(o + size
                                                         for o, size in rings)
    assert c1 <= bars[0] or bars[0] + bars[1] <= c0


def _case(rows, k, n, seed):
    rng = np.random.RandomState(seed)
    x = (rng.randn(rows, k) * 0.5).astype(np.float32)
    q = rng.randint(-127, 128, size=(k, n)).astype(np.int8)
    scale = ((rng.rand(n) + 0.5) / 127).astype(np.float32)
    return x, q, scale


def wgmma_model(x, q, scale, plan):
    """The kernel's arithmetic in float32: per output tile (bt token rows x
    WGMMA_BN channels) each slice's float32 partial over its k-blocks, the
    cluster's partials summed in rank order (from zero), times the
    per-channel scale once."""
    rows, k = x.shape
    n = q.shape[1]
    bt, per = plan["bt"], plan["kb_per"]
    sp = plan["splits"]
    w = q.astype(np.float32)
    y = np.zeros((rows, n), np.float32)
    for _, yb, xb in _blocks(dict(plan, grid=(1,) + plan["grid"][1:])):
        t0, c0 = xb * bt, yb * qm.WGMMA_BN
        ts = slice(t0, min(rows, t0 + bt))
        cs = slice(c0, min(n, c0 + qm.WGMMA_BN))
        v = np.zeros((ts.stop - ts.start, cs.stop - cs.start), np.float32)
        for z in range(sp):
            ks = slice(z * per * qm.WGMMA_BK,
                       min(k, (z + 1) * per * qm.WGMMA_BK))
            v = v + x[ts, ks] @ w[ks, cs]
        y[ts, cs] = v * scale[cs]
    return y


@pytest.mark.parametrize("name,rows", CASES)
def test_model_matches_plain_and_pallas(name, rows):
    k, n = SHAPES[name]
    x, q, scale = _case(rows, k, n, rows * 7 + k + n)
    got = wgmma_model(x, q, scale, qm.wgmma_plan(rows, k, n))
    plain = qm.int8_matmul(torch.from_numpy(x), torch.from_numpy(q),
                           torch.from_numpy(scale)).numpy()   # CPU: plain
    want = np.asarray(j_qmm.int8_matmul_pallas(
        jnp.asarray(x), jnp.asarray(q), jnp.asarray(scale), interpret=True))
    top = float(np.abs(want).max())
    assert float(np.abs(got - plain).max()) <= REL * top
    assert float(np.abs(got - want).max()) <= REL * top
    assert float(np.abs(plain - want).max()) <= REL * top


@pytest.mark.parametrize("name,k,n", MESH_CASES, ids=MESH_IDS)
def test_plan_and_model_at_mesh_rank_shapes(name, k, n):
    """A rank's shapes at 256 rows (the warpgroup kernel): the plan covers
    and fits, its model equals the plain version; 2 and 16 rows take the
    skinny and tensor-core row-block kernels
    (tests/test_torch_skinny_plan.py, test_torch_qmma_plan.py)."""
    rows = 256
    assert qm.int8_route(torch.bfloat16, rows) == "wgmma"
    assert [qm.int8_route(torch.bfloat16, r) for r in (2, 16)] == \
        ["skinny", "mma"]
    plan = qm.wgmma_plan(rows, k, n)
    check_cover(plan, rows, k, n)
    check_smem(plan)
    x, q, scale = _case(rows, k, n, k + n)
    got = wgmma_model(x, q, scale, plan)
    want = qm.int8_matmul_plain(torch.from_numpy(x), torch.from_numpy(q),
                                torch.from_numpy(scale)).numpy()
    assert float(np.abs(got - want).max()) <= REL * float(
        np.abs(want).max())


def test_model_holds_at_every_split():
    """The rank-order sum equals the unsplit product at every split count
    the sweep times (in_proj at 128 rows, both tile heights)."""
    k, n = SHAPES["in_proj"]
    x, q, scale = _case(128, k, n, 3)
    want = qm.int8_matmul_plain(torch.from_numpy(x), torch.from_numpy(q),
                                torch.from_numpy(scale)).numpy()
    top = float(np.abs(want).max())
    for bt in qm.WGMMA_BTS:
        for sp in (1, 2, 3, 4, 6, 8):
            plan = qm.wgmma_plan(128, k, n, bt, sp)
            got = wgmma_model(x, q, scale, plan)
            assert float(np.abs(got - want).max()) <= REL * top, (bt, sp)


def test_plan_refuses_widths_the_tma_does_not_take():
    for k, n in ((1020, 1024), (1024, 1000)):
        with pytest.raises(ValueError, match="warpgroup route"):
            qm.wgmma_plan(128, k, n)


# ------------------------------------------------------------- routes ---

ROUTE_ROWS = (1, 2, 15, 16, 32, 63, 64, 128, 130, 256)


def _want_route(dtype, rows):
    if dtype == torch.float32:
        return "simt"
    return ("skinny" if rows < fused_layer.MMA_ROWS else
            "mma" if rows < qm.WGMMA_ROWS else "wgmma")


@pytest.mark.parametrize("rows", ROUTE_ROWS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_int8_route_four_ways(dtype, rows):
    assert qm.WGMMA_ROWS == 64 and fused_layer.MMA_ROWS == 16
    assert qm.int8_route(dtype, rows) == _want_route(dtype, rows)
    # the row-block family's own route never takes the warpgroup kernel
    assert fused_layer.rows_route(dtype, rows) == (
        "mma" if _want_route(dtype, rows) == "wgmma"
        else _want_route(dtype, rows))


class FakeLib:
    """Records which entry point a launch reaches (and its arguments); asked
    how many clusters fit, answers the model's count (not recorded)."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        if not name.startswith("ptt_"):
            raise AttributeError(name)
        if name == "ptt_wgmma_max_clusters":
            return lambda bt, splits, smem: qm.WGMMA_WAVE // splits

        def entry(*args):
            self.calls.append((name, args))
            return 0
        return entry


ENTRY = {"wgmma": "ptt_wgmma_int8", "mma": "ptt_rows_mma",
         "skinny": "ptt_rows_skinny", "simt": "ptt_fused_rows"}


@pytest.mark.parametrize("rows", [1, 15, 16, 63, 64, 128, 130])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k4a_launches_the_kernel_of_its_route(dtype, rows, monkeypatch):
    """int8_matmul's card branch on a stand-in library (CPU tensors): one
    launch of the route's entry point, counted in int8_matmul.launches
    (the warpgroup kernel once more in launches_wgmma) and by no row
    counter; the warpgroup launch carries wgmma_plan."""
    k, n = SHAPES["in_proj"]
    lib = FakeLib()
    monkeypatch.setattr(cuda_lib, "library", lambda: lib)
    monkeypatch.setattr(cuda_lib, "stream_ptr", lambda device: 0)
    monkeypatch.setattr(qm, "_wgmma_state", {})
    x = torch.zeros(rows, k, dtype=dtype)
    q = torch.zeros(k, n, dtype=torch.int8)
    scale = torch.ones(n)
    before = (qm.int8_matmul.launches, qm.int8_matmul.launches_wgmma,
              qm.int4_matmul.launches, fused_layer._rows_call.launches_mma,
              fused_layer._rows_call.launches_skinny)
    y = qm._int8_cuda(x, q, scale)
    assert y.shape == (rows, n) and y.dtype == dtype
    route = qm.int8_route(dtype, rows)
    assert [c[0] for c in lib.calls] == [ENTRY[route]]
    after = (qm.int8_matmul.launches, qm.int8_matmul.launches_wgmma,
             qm.int4_matmul.launches, fused_layer._rows_call.launches_mma,
             fused_layer._rows_call.launches_skinny)
    assert [a - b for a, b in zip(after, before)] == [
        1, int(route == "wgmma"), 0, 0, 0]
    if route == "wgmma":
        plan, marks = lib.calls[0][1][-3:-1]
        assert isinstance(plan, ctypes.Array) and marks == 0
        assert qm.wgmma_fits(lib) == qm.model_fits()
        want = qm.wgmma_plan(rows, k, n, fits=qm.wgmma_fits(lib))
        assert list(plan) == [want[key] for key in qm.WGMMA_PLAN_KEYS]
        assert lib.calls[0][1][4:7] == (rows, k, n)


def test_k4a_route_raises_and_never_takes_another_kernel(monkeypatch):
    """A width the warpgroup route does not take (K not a multiple of 8)
    raises ValueError before any launch."""
    lib = FakeLib()
    monkeypatch.setattr(cuda_lib, "library", lambda: lib)
    monkeypatch.setattr(cuda_lib, "stream_ptr", lambda device: 0)
    monkeypatch.setattr(qm, "_wgmma_state", {})
    x = torch.zeros(128, 1020, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="warpgroup route"):
        qm._int8_cuda(x, torch.zeros(1020, 1024, dtype=torch.int8),
                      torch.ones(1024))
    assert lib.calls == []


def test_cuda_library_has_no_int8_matmul_entry():
    """K4a's SIMT kernel is gone: the row-block entry points and the
    warpgroup kernel serve it."""
    assert "ptt_int8_matmul" not in cuda_lib.SIGNATURES
    assert "ptt_wgmma_int8" in cuda_lib.SIGNATURES
    assert len(cuda_lib.SIGNATURES["ptt_wgmma_int8"]) == 10
    assert cuda_lib.SIGNATURES["ptt_wgmma_max_clusters"] == [ctypes.c_int] * 3
    names = {os.path.basename(p) for p in cuda_lib.sources()}
    assert "wgmma_matmul.cu" in names and "int8_matmul.cu" not in names
