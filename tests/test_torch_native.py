"""The port's PcmFifo (native.py: the JAX class's pure-Python path)
against `pocket_tts_tpu.native.PcmFifo` (whichever path that takes here):
the same counts accepted by push, the same popped samples and lengths over
one random sequence of pushes and pops, and across threads."""
import threading

import numpy as np
import pytest

from pocket_tts_tpu import native as jnative
from pocket_tts_tpu_torch import native as tnative


@pytest.mark.parametrize("cap,seed", [(10, 0), (1920 * 3, 1), (1, 2)])
def test_pcm_fifo_sequences_equal_jax(cap, seed):
    rng = np.random.RandomState(seed)
    j, t = jnative.PcmFifo(cap), tnative.PcmFifo(cap)
    for _ in range(300):
        if rng.rand() < 0.5:
            data = rng.randn(rng.randint(0, 2 * cap + 2)).astype(np.float64)
            assert t.push(data) == j.push(data)
        else:
            n = rng.randint(0, 2 * cap + 2)
            a, b = t.pop(n), j.pop(n)
            assert a.dtype == b.dtype == np.float32
            np.testing.assert_array_equal(a, b)
        assert len(t) == len(j)


def test_pcm_fifo_threads_keep_order():
    """A producer and a consumer thread: every sample arrives once, in
    order, and the ring never holds more than its capacity."""
    f = tnative.PcmFifo(64)
    src = np.arange(5000, dtype=np.float32)
    got = []

    def produce():
        off = 0
        while off < src.size:
            off += f.push(src[off:off + 37])

    th = threading.Thread(target=produce)
    th.start()
    while sum(g.size for g in got) < src.size:
        assert len(f) <= 64
        got.append(f.pop(50))
    th.join()
    np.testing.assert_array_equal(np.concatenate(got), src)
