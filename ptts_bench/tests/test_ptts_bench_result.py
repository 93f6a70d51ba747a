"""The result line's keys, the refusal without a card, and the modules a
run loads."""
import json
import subprocess
import sys
from pathlib import Path

import torch

import _tiny
from ptts_bench import run

REPO = Path(__file__).resolve().parents[2]
CONTRACT = ["correct", "attempted", "failed", "metrics", "device"]


def test_result_line_keys_and_metrics():
    out, rec = run.run_cell(_tiny.cell(), _tiny.conf(), _tiny.mix(),
                            _tiny.bench(), 77, 5.0, False, False,
                            torch.device("cpu"), torch.float32)
    line = json.loads(json.dumps(out))
    assert list(line)[:5] == CONTRACT and list(line)[-1] == "checks"
    assert set(line["device"]) >= {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    assert set(line["checks"]) == {"latent_rel", "pcm_vs_bf16", "eos_miss"}
    assert all(set(c) == {"value", "limit"} for c in line["checks"].values())
    # every end-to-end metric of the tiny cell is read, with its unit
    units = {m["name"]: m["unit"] for m in _tiny.bench()["end_to_end"]
             if "tiny" in m.get("workloads", ["tiny"])}
    assert {k: v["unit"] for k, v in line["metrics"].items()} == units
    assert line["metrics"]["audio_frames_per_s"]["value"] > 0


def test_no_card_no_result(capsys):
    assert run.main(["--workload", "int4kv8.sessions256", "--seed", "1",
                     "--seconds", "1", "--trace", "0"]) == 3
    assert capsys.readouterr().out == ""


def test_a_run_loads_neither_jax_nor_the_jax_package():
    code = (
        "import sys, torch\n"
        f"sys.path[:0] = [{str(REPO)!r}, {str(Path(__file__).parent)!r}]\n"
        "torch.set_num_threads(2)\n"
        "import _tiny\n"
        "from ptts_bench import run\n"
        "run.kernel_specs()\n"
        "for m in ('audio_frames_per_s', 'kernels_roofline', 'step_mfu'):\n"
        "    run.load_reader('metrics', m)\n"
        "out, _ = run.run_cell(_tiny.cell(), _tiny.conf(), _tiny.mix(),\n"
        "    _tiny.bench(), 5, 2.0, True, False, torch.device('cpu'),\n"
        "    torch.float32)\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}))\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=str(REPO), timeout=600)
    assert res.returncode == 0, res.stderr[-2000:]
    top = set(eval(res.stdout.strip().splitlines()[-1]))
    assert "pocket_tts_tpu_torch" in top
    assert not top & run.FORBIDDEN, top & run.FORBIDDEN
