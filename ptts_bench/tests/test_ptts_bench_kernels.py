"""Each kernel count against a hand count at one shape."""
import torch

from ptts_bench import run

SPECS = run.kernel_specs()


def test_k4b():
    x = torch.zeros(3, 64, dtype=torch.bfloat16)
    q4 = torch.zeros(32, 128, dtype=torch.int8)
    scale = torch.zeros(128)
    fl, by = SPECS["k4b"].cost(SPECS["k4b"].record(
        {"x": x, "q4": q4, "scale": scale}))
    assert fl == 2 * 3 * 64 * 128
    assert by == 32 * 128 + 128 * 4 + 3 * 64 * 2 + 3 * 128 * 2


def test_k7_counts_the_valid_slots():
    b, h, d, s = 2, 4, 64, 8
    pos = torch.full((b, s), -1, dtype=torch.int32)
    pos[0, :3] = torch.arange(3)
    pos[1, :5] = torch.arange(5)
    a = {"q": torch.zeros(b, h, d, dtype=torch.bfloat16),
         "k_new": torch.zeros(b, 1, h * d, dtype=torch.int8),
         "v_new": torch.zeros(b, 1, h * d, dtype=torch.int8),
         "cur_pos": torch.zeros(b, dtype=torch.int32),
         "k_cache": torch.zeros(b, s, h * d, dtype=torch.int8),
         "v_cache": None, "pos": pos, "read_end": s - 1, "write_slot": 0,
         "k_scale": torch.zeros(b, s), "v_scale": None, "ks_new": None,
         "vs_new": None, "stats": True}
    fl, by = SPECS["k7"].cost(SPECS["k7"].record(a))
    assert fl == 4 * 8 * h * d
    assert by == (2 * 8 * (h * d + 4) + b * s * 4
                  + 2 * b * h * d * 2 + 2 * b * h * d + b * 4 + b * h * 8)


def test_k2_counts_the_window():
    # one lane, 2 new rows at steps 4 and 5, window 5, ring of 8 slots
    a = {"q": torch.zeros(1, 2, 64), "k_new": torch.zeros(1, 2, 64),
         "v_new": torch.zeros(1, 2, 64),
         "k_cache": torch.zeros(1, 8, 64), "v_cache": None, "offset": 4,
         "start": torch.zeros(1, dtype=torch.int32), "num_heads": 1,
         "context": 5, "k_scale": None}
    fl, by = SPECS["k2"].cost(SPECS["k2"].record(a))
    assert fl == 4 * 64 * (5 + 5)        # keys 0-4, then 1-5
    assert by == 2 * 6 * 64 * 4 + 4 * 2 * 64 * 4


def test_k3_full_width_frame():
    from pocket_tts_tpu_torch.config import DEFAULT_CONFIG
    cfg = DEFAULT_CONFIG.mimi.seanet
    x = torch.zeros(1, 16, 512, dtype=torch.bfloat16)
    p = {"w": torch.zeros(10, dtype=torch.bfloat16)}
    state = {"c": torch.zeros(6, dtype=torch.bfloat16)}
    fl, by = SPECS["k3"].cost(SPECS["k3"].record(
        {"p": p, "cfg": cfg, "state": state, "x": x, "weights": None}))
    # model_0, then per stage its transposed conv and resnet, model_11
    assert fl == (58_720_256 + 50_331_648 + 25_165_824 + 62_914_560
                  + 31_457_280 + 62_914_560 + 31_457_280 + 737_280)
    assert by == 20 + 16 * 512 * 2 + 2 * 12 + 1920 * 2


def test_k5a_k5b_k6_linear_counts():
    def lin(k, n):
        return {"q4": torch.zeros(k // 2, n, dtype=torch.int8),
                "scale": torch.zeros(n)}
    x = torch.zeros(4, 1, 64, dtype=torch.bfloat16)
    p = {"in_proj": lin(64, 192), "norm1": {"scale": torch.zeros(64)},
         "out_proj": lin(64, 64), "linear1": lin(64, 256),
         "linear2": lin(256, 64), "norm2": {"scale": torch.zeros(64)}}
    fl, by = SPECS["k5a"].cost(SPECS["k5a"].record({"p": p, "x": x}))
    assert fl == 2 * 4 * 64 * 192
    assert by == 32 * 192 + 192 * 4 + 64 * 4 + 4 * 64 * 2 + 4 * 192 * 2
    fl, by = SPECS["k5b"].cost(SPECS["k5b"].record(
        {"p": p, "x": x, "attn": x}))
    assert fl == 2 * 4 * (64 * 64 + 64 * 256 + 256 * 64)
    assert by == (32 * 64 + 64 * 4 + 32 * 256 + 256 * 4 + 128 * 64 + 64 * 4
                  + 64 * 4 + 3 * 4 * 64 * 2)
    flow = {"input_proj": lin(8, 32), "cond_embed": lin(64, 32),
            "res_blocks": {"adaln": {"q4": torch.zeros(2, 16, 96,
                                                       dtype=torch.int8),
                                     "scale": torch.zeros(2, 96)},
                           "mlp_0": {"q4": torch.zeros(2, 16, 32,
                                                       dtype=torch.int8),
                                     "scale": torch.zeros(2, 32)},
                           "mlp_2": {"q4": torch.zeros(2, 16, 32,
                                                       dtype=torch.int8),
                                     "scale": torch.zeros(2, 32)}},
            "final": {"adaln": lin(32, 64), "linear": lin(32, 8)}}
    c = torch.zeros(4, 64, dtype=torch.bfloat16)
    z = torch.zeros(4, 8, dtype=torch.bfloat16)
    fl, _ = SPECS["k6"].cost(SPECS["k6"].record(
        {"p": flow, "c": c, "x": z, "t_combined": torch.zeros(32)}))
    assert fl == 2 * 4 * (8 * 32 + 64 * 32 + 2 * (32 * 96 + 32 * 32
                                                   + 32 * 32)
                          + 32 * 64 + 32 * 8)
