"""The port's AudioPlayer (runtime/player.py, its own copy of the JAX
package's) against `pocket_tts_tpu.runtime.player`: the same bytes into a
file sink for the same frames (int16, clipped, with backpressure on the
3-frame ring), the same player commands, and the same RuntimeError when
no player binary is on PATH and no sink is given."""
import io

import numpy as np
import pytest

from pocket_tts_tpu.runtime import player as jplayer
from pocket_tts_tpu_torch.runtime import player as tplayer


def _play(mod, frames, frame_size):
    sink = io.BytesIO()
    p = mod.AudioPlayer(24000, sink=sink, capacity_frames=3,
                        frame_size=frame_size)
    for f in frames:
        p.play(f)
    p.close()
    return sink.getvalue()


@pytest.mark.parametrize("frame_size,n", [(1920, 8), (160, 25)])
def test_player_bytes_equal_jax(frame_size, n):
    rng = np.random.RandomState(frame_size)
    frames = [(rng.randn(frame_size) * 0.7).astype(np.float32)
              for _ in range(n)]
    frames.append(np.array([2.0, -2.0, 0.5], np.float32))   # clipped
    got = _play(tplayer, frames, frame_size)
    assert got == _play(jplayer, frames, frame_size)
    want = np.clip(np.concatenate(frames) * 32767.0, -32768,
                   32767).astype(np.int16)
    np.testing.assert_array_equal(np.frombuffer(got, np.int16), want)


def test_player_commands_and_gating_equal_jax(monkeypatch):
    import shutil
    for found in ("aplay", "pw-play", "ffplay", None):
        monkeypatch.setattr(shutil, "which",
                            lambda name, f=found: name if name == f else None)
        assert tplayer._player_cmd(16000) == jplayer._player_cmd(16000)
        assert tplayer.playback_available() == jplayer.playback_available()
    monkeypatch.setattr(shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError) as ej:
        jplayer.AudioPlayer(24000)
    with pytest.raises(RuntimeError) as et:
        tplayer.AudioPlayer(24000)
    assert str(et.value) == str(ej.value)
