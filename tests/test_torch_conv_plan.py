"""The plans K4a and K4b take at the seven quantized SEANet convs of
DEFAULT_CONFIG (quantize_params(convs=True): window products K*Cin x Cout,
transposed convs Cin x K*Cout), solo rows and 32 lanes' rows, and at the
four quantized convs of the SEANet encoder (one call of 1920 samples) and
the mimi gating linears (16 rows and 32 lanes' rows), checked on the CPU:

- chip_smoke.conv_shapes(DEFAULT_CONFIG) names exactly these seven;
- K4a (int8): bf16 calls of 64 rows or more take the warpgroup kernel,
  whose `wgmma_plan` (the model of the card's cluster fits) covers every
  output once and every K row once per tile, fits its shared memory, and
  whose numpy model of the arithmetic equals `int8_matmul_plain` within
  1e-5 relative, including N = 64 (one half-empty channel tile) and
  K = 128 (two k-blocks); 16-row calls take the tensor-core row-block
  kernel, whose width checks and `rows_plan` hold;
- K4b (int4): every bf16 call takes rows_mma_kernel, K = 3584 over 512
  rows included (its A columns within MMA_A_BYTES), and 15360 rows;
- float32 calls take rows_kernel, whose row blocks keep the grid within
  the card's 65535 blocks in y.
"""
import numpy as np
import pytest
import torch

import chip_smoke
from pocket_tts_tpu_torch.config import DEFAULT_CONFIG
from pocket_tts_tpu_torch.ops import fused_layer as fl
from pocket_tts_tpu_torch.ops import quant_matmul as qm
from test_torch_wgmma_plan import _blocks, wgmma_model

torch.set_num_threads(1)
SMEM_MAX = 232448
# (module, K, N, rows a lane a frame), the quantized convs' products
CONVS = [("model_0", 3584, 512, 16), ("model_2", 512, 3072, 16),
         ("model_3.block_1", 768, 128, 96), ("model_3.block_3", 128, 256, 96),
         ("model_5", 256, 1280, 96), ("model_6.block_1", 384, 64, 480),
         ("model_8", 128, 512, 480)]
# the SEANet encoder's four quantized convs at 1920 samples a call
# (chip_smoke.encoder_conv_shapes), solo only: no path runs it over lanes
ENCODER = [("model_4.block_1", 384, 64, 480),
           ("model_7.block_1", 768, 128, 96),
           ("model_7.block_3", 128, 256, 96), ("model_11", 1536, 512, 16)]
# the mimi layers' SwiGLU gating linears at hidden 1024 (chip_smoke
# GATING_HIDDEN), 16 rows a frame solo and 32 lanes' rows
GATING = [("gating.linear_in", 512, 2048, 16),
          ("gating.linear_out", 1024, 512, 16)]
CASES = ([(name, k, n, rows * lanes) for name, k, n, rows in CONVS + GATING
          for lanes in (1, 32)]
         + [("encoder." + c[0], *c[1:]) for c in ENCODER])
IDS = [f"{c[0]}-{c[3]}" for c in CASES]


def test_conv_shapes_are_the_seven():
    assert chip_smoke.conv_shapes(DEFAULT_CONFIG) == CONVS


def test_encoder_conv_shapes_are_the_four():
    assert chip_smoke.encoder_conv_shapes(DEFAULT_CONFIG) == ENCODER


@pytest.mark.parametrize("name,k,n,rows", CASES, ids=IDS)
def test_int8_route_and_plan(name, k, n, rows):
    route = qm.int8_route(torch.bfloat16, rows)
    assert route == ("wgmma" if rows >= qm.WGMMA_ROWS else "mma")
    if route == "mma":
        fl._mma_check("rows_mma", k, n, qm.INT8, 0, False)
        bm, splits, per = fl.rows_plan(rows, k, n, False)
        kt = -(-k // fl.MMA_BKS)
        assert splits <= fl.MMA_MAX_SPLITS and splits * per >= kt
        assert (splits - 1) * per < kt
        assert fl.rows_mma_smem(bm, per, False, k) <= SMEM_MAX
        return
    plan = qm.wgmma_plan(rows, k, n)
    bt, sp, per = plan["bt"], plan["splits"], plan["kb_per"]
    kb = -(-k // qm.WGMMA_BK)
    assert plan["grid"] == (sp, -(-n // qm.WGMMA_BN), -(-rows // bt))
    assert sp * per >= kb and (sp - 1) * per < kb and sp <= 8
    assert plan["smem"] <= SMEM_MAX
    stored = np.zeros((rows, n), np.int64)
    for z, y, x in _blocks(plan):
        c0, t0 = y * qm.WGMMA_BN, x * bt
        for r in range(z, bt, sp):
            if t0 + r < rows:
                stored[t0 + r, c0:c0 + qm.WGMMA_BN] += 1
    assert (stored == 1).all()


@pytest.mark.parametrize("name,k,n,rows", [
    c for c in CASES if c[3] >= qm.WGMMA_ROWS and c[3] <= 3072],
    ids=[i for c, i in zip(CASES, IDS)
         if c[3] >= qm.WGMMA_ROWS and c[3] <= 3072])
def test_wgmma_model_equals_plain(name, k, n, rows):
    """The warpgroup kernel's arithmetic (numpy model) at the conv's
    shape equals the plain version; N = 64 leaves half of each channel
    tile empty (the TMA reads zeros past N, the store is guarded)."""
    rng = np.random.RandomState(rows + k)
    x = (rng.randn(rows, k) * 0.5).astype(np.float32)
    q = rng.randint(-127, 128, size=(k, n)).astype(np.int8)
    scale = ((rng.rand(n) + 0.5) / 127).astype(np.float32)
    got = wgmma_model(x, q, scale, qm.wgmma_plan(rows, k, n))
    want = qm.int8_matmul_plain(torch.from_numpy(x), torch.from_numpy(q),
                                torch.from_numpy(scale)).numpy()
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_the_routes_the_convs_reach_first():
    """N = 64 and K = 128 on the warpgroup kernel; K4b's tensor-core
    kernel at K = 3584 over 512 rows; 15360 rows."""
    wg = {(k, n) for _, k, n, rows in CASES
          if qm.int8_route(torch.bfloat16, rows) == "wgmma"}
    assert any(n == 64 for _, n in wg) and any(k == 128 for k, _ in wg)
    assert fl.rows_route(torch.bfloat16, 512) == "mma"
    bm, splits, per = fl.rows_plan(512, 3584, 512, True)
    assert per * fl.MMA_BKS * 2 * bm * 2 <= fl.MMA_A_BYTES
    assert max(rows for *_, rows in CASES) == 15360


@pytest.mark.parametrize("name,k,n,rows", CASES, ids=IDS)
def test_int4_route_and_plan(name, k, n, rows):
    assert fl.rows_route(torch.bfloat16, rows) == "mma"
    fl._mma_check("rows_mma", k, n, qm.INT4, 0, False)
    bm, splits, per = fl.rows_plan(rows, k, n, True)
    kt = -(-(k // 2) // fl.MMA_BKS)
    assert bm in fl.MMA_BMS and splits <= fl.MMA_MAX_SPLITS
    assert splits * per >= kt and (splits - 1) * per < kt
    assert fl.rows_mma_smem(bm, per, True, k) <= SMEM_MAX
    assert -(-rows // bm) <= 65535


@pytest.mark.parametrize("name,k,n,rows", CASES, ids=IDS)
def test_float32_rows_kernel_grid(name, k, n, rows):
    """rows_kernel (csrc/fused_layer.cu `launch_rows`): row blocks of at
    most FL_ROW_FLOATS activations, one a grid row."""
    assert fl.rows_route(torch.float32, rows) == "simt"
    per_block = max(1, min(rows, fl.ROW_FLOATS // k))
    assert -(-rows // per_block) <= 65535 and n % 4 == 0
