"""The port's utils/profiling.py against `pocket_tts_tpu/utils/
profiling.py`: FrameMeter gives the same report under one patched clock
(and `skip` takes back an empty step, first-frame time included);
device_trace writes a Chrome trace on the CPU; enable_compile_cache picks
the kernel library's build directory and raises where the JAX function
would swallow the error."""
import json
import os

import pytest

from pocket_tts_tpu.utils import profiling as jprof
from pocket_tts_tpu_torch.ops import cuda_lib
from pocket_tts_tpu_torch.utils import profiling as tprof


class Clock:
    def __init__(self, ticks):
        self.ticks = list(ticks)

    def __call__(self):
        return self.ticks.pop(0)


@pytest.mark.parametrize("steps", [0, 1, 5])
def test_frame_meter_report_equals_jax(steps, monkeypatch):
    """reset, `steps` steps of 80 ms after a 0.3 s start, report: every key
    equal, on the same sequence of clock readings."""
    ticks = [10.0] + [t for i in range(steps)
                      for t in (10.3 + i * 0.1, 10.38 + i * 0.1)] + [11.5]
    reps = []
    for mod in (jprof, tprof):
        monkeypatch.setattr(mod.time, "perf_counter", Clock(ticks))
        m = mod.FrameMeter(12.5)
        for _ in range(steps):
            with m.step():
                pass
        reps.append(m.report())
    assert reps[0] == reps[1]
    assert set(reps[1]) == {"frames", "frames_per_second", "rtf", "ttfa_ms",
                            "wall_s"}


def test_frame_meter_skip(monkeypatch):
    """An empty first receive (skip) leaves no frame and no first-frame
    time; its busy time stays, as the JAX CLI's pump leaves it."""
    monkeypatch.setattr(tprof.time, "perf_counter",
                        Clock([0.0, 0.1, 0.2, 0.3, 0.5, 0.75, 1.0]))
    m = tprof.FrameMeter(12.5)
    with m.step():
        pass
    m.skip()
    rep = m.report()
    assert rep["frames"] == 0 and rep["ttfa_ms"] is None
    with m.step():
        pass
    rep = m.report()
    assert rep["frames"] == 1 and rep["ttfa_ms"] == 750.0
    assert rep["frames_per_second"] == 2.857   # 1 frame / 0.35 s busy


def test_device_trace_writes_a_chrome_trace_on_cpu(tmp_path):
    import torch
    with tprof.device_trace(str(tmp_path / "tr"), "cpu") as path:
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert path == str(tmp_path / "tr" / "trace.json")
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in str(e.get("name", "")) for e in events)


def test_enable_compile_cache_picks_the_build_dir(tmp_path, monkeypatch):
    monkeypatch.setitem(cuda_lib._state, "build_dir", cuda_lib.BUILD_DIR)
    monkeypatch.setitem(cuda_lib._state, "lib", None)
    d = str(tmp_path / "cache" / "a")
    assert tprof.enable_compile_cache(d) == d and os.path.isdir(d)
    assert cuda_lib.build_dir() == d
    off = tprof.enable_compile_cache("off")
    assert os.path.isdir(off) and off != d and cuda_lib.build_dir() == off
    os.rmdir(off)
    assert tprof.enable_compile_cache(None) == cuda_lib.BUILD_DIR
    # a directory that cannot be made raises (the JAX function prints and
    # returns None)
    blocker = tmp_path / "file"
    blocker.write_text("x")
    with pytest.raises(OSError):
        tprof.enable_compile_cache(str(blocker / "sub"))
    # once the library is loaded, only its own directory is accepted
    monkeypatch.setitem(cuda_lib._state, "lib", object())
    assert tprof.enable_compile_cache(None) == cuda_lib.BUILD_DIR
    with pytest.raises(RuntimeError, match="loaded already"):
        tprof.enable_compile_cache(d)

