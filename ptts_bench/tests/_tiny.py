"""A cell at tiny sizes for the CPU tests: the same configuration keys and
traffic parameters as the benchmark's files, small widths and few lanes."""
import copy
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def conf(name="pocket-tts.int4-kv8", dtype="float32"):
    c = json.loads((ROOT / "configs" / f"{name}.json").read_text())
    c = copy.deepcopy(c)
    d = 16
    c["model"] = {
        "backbone": {"d_model": 4 * d, "hidden_scale": 2, "num_heads": 4,
                     "num_layers": 2, "kv_capacity": 256,
                     "max_period": 10000},
        "flow": {"depth": 2, "dim": 2 * d, "mlp_hidden": 2 * d,
                 "freq_half": 8},
        "lut": {"n_bins": 256, "dim": 4 * d},
        "latent_dim": 8, "eos_threshold": -4.0,
        "mimi": {"dim": 2 * d, "latent_dim": 8, "upsample_kernel": 32,
                 "upsample_stride": 16, "frame_rate": 12.5,
                 "sample_rate": 24000,
                 "transformer": {"d_model": 2 * d, "num_heads": 2,
                                 "num_layers": 2, "hidden_dim": 4 * d,
                                 "context": 40, "capacity": 48,
                                 "max_period": 10000},
                 "seanet": {"in_ch": 2 * d, "first_kernel": 7,
                            "resnet_kernel": 3, "last_kernel": 3,
                            "out_ch": 1,
                            "stages": [
                                {"in_ch": 2 * d, "out_ch": d, "kernel": 12,
                                 "stride": 6},
                                {"in_ch": d, "out_ch": d // 2, "kernel": 10,
                                 "stride": 5},
                                {"in_ch": d // 2, "out_ch": d // 4,
                                 "kernel": 8, "stride": 4}]}}}
    c["serving"]["dtype"] = dtype
    # float32 on both sides agrees to ~1e-7 at these sizes, ~5e-5 of
    # bfloat16's distance in the PCM (the cells' limits are set from bf16
    # runs on the card)
    c["limits"] = {"latent_rel": 1e-4, "pcm_vs_bf16": 0.01, "eos_miss": 0}
    return c


def mix():
    m = json.loads((ROOT / "traffic" / "sessions256.json").read_text())
    m.update(lanes=4, capacity=256, text_bucket=32, pool=256, sample=8,
             warm_groups=4, trace_chunks=2)
    m["arrivals"] = dict(m["arrivals"], sessions=4, ramp_chunks=2)
    m["words"] = dict(m["words"], median=3, min=2, max=5)
    m["voices"] = dict(m["voices"], count=3, min_frames=8, max_frames=20)
    return m


def cell(name="tiny"):
    return {"name": name, "config": "tiny", "traffic": "tiny", "chips": 1}


def bench():
    return json.loads((ROOT.parent / "BENCHMARK.json").read_text())
