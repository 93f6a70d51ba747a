"""The port's native library (native.py, csrc/native/) against its plain
versions, exactly: the PCM FIFO against the pure-Python PcmFifoPlain and
the JAX package's PcmFifo over random push/pop sequences and across two
threads; the safetensors reader against io/safetensors_io (BF16
included); the sentence splitter against text.preprocess.StrProcessor
over chunk splits and Unicode text; WAV bytes against io/wav.save_wav.
The build: concurrent builds into one directory leave one library, a
broken source raises with the compiler's output, and the engine's Stream
splits with the native splitter."""
import os
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

from pocket_tts_tpu import native as jnative
from pocket_tts_tpu_torch import native as tnative
from pocket_tts_tpu_torch.io.safetensors_io import (load_safetensors,
                                                    save_safetensors)
from pocket_tts_tpu_torch.io.wav import save_wav
from pocket_tts_tpu_torch.text.preprocess import StrProcessor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("cap,seed", [(10, 0), (1920 * 3, 1), (1, 2)])
def test_pcm_fifo_sequences_equal_jax(cap, seed):
    rng = np.random.RandomState(seed)
    fifos = (tnative.PcmFifo(cap), tnative.PcmFifoPlain(cap),
             jnative.PcmFifo(cap))
    for _ in range(300):
        if rng.rand() < 0.5:
            data = rng.randn(rng.randint(0, 2 * cap + 2)).astype(np.float64)
            counts = {f.push(data) for f in fifos}
            assert len(counts) == 1
        else:
            n = rng.randint(0, 2 * cap + 2)
            a, b, c = (f.pop(n) for f in fifos)
            assert a.dtype == b.dtype == c.dtype == np.float32
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(a, c)
        assert len({len(f) for f in fifos}) == 1


def test_pcm_fifo_threads_keep_order():
    """A producer and a consumer thread: every sample arrives once, in
    order, and the native ring never holds more than its capacity."""
    _threads_keep_order(tnative.PcmFifo)


def test_pcm_fifo_plain_threads_keep_order():
    """The same for the pure-Python ring."""
    _threads_keep_order(tnative.PcmFifoPlain)


def _threads_keep_order(fifo):
    f = fifo(64)
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


def test_safetensors_native_equals_python(tmp_path):
    rng = np.random.RandomState(0)
    tensors = {
        "a.weight": rng.randn(4, 8).astype(np.float32),
        "b.bias": rng.randn(16).astype(np.float64),
        "c.int": np.arange(10, dtype=np.int32),
        "d.i8": rng.randint(-128, 127, (3, 5)).astype(np.int8),
        "e.u8": rng.randint(0, 255, 7).astype(np.uint8),
        "f.half": rng.randn(6).astype(np.float16),
        "g.flag": rng.rand(5) > 0.5,
        "h.empty": np.zeros((0, 3), np.float32),
        "i.scalar": np.asarray(2.5, np.float32),
        "j.bf16": torch.from_numpy(rng.randn(5, 3).astype(
            np.float32)).to(torch.bfloat16),
    }
    path = str(tmp_path / "x.safetensors")
    save_safetensors(tensors, path, metadata={"note": 'a "quoted" {x}'})
    got, want = tnative.load_safetensors_native(path), load_safetensors(path)
    assert sorted(got) == sorted(want) == sorted(tensors)
    for k in want:
        assert got[k].dtype == want[k].dtype and \
            got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    np.testing.assert_array_equal(
        got["j.bf16"], tensors["j.bf16"].float().numpy())


def test_safetensors_native_missing_file():
    with pytest.raises(IOError):
        tnative.load_safetensors_native("/nonexistent/x.safetensors")


TEXTS = [
    "hello world. and then some! more? yes",
    "  spaces   merge.  caps happen",
    "wait... what? no",
    "no punctuation at all",
    "héllo wörld. ünïcode ok! ßtraße? ǆemo. été",
    "日本語のテキスト。 ok. ﬁne ǳ",
    "tab\tand nbsp em space.\x1cseparators\x1f too.  line",
    "émoji 👍🏽 fine. 🎉 party! İstanbul. ǅ",
    "a" * 70000 + ". short one.",
]


@pytest.mark.parametrize("chunk", [1, 7, 15, None])
@pytest.mark.parametrize("text", range(len(TEXTS)))
def test_splitter_equals_python(text, chunk):
    text = TEXTS[text]
    py, nat = StrProcessor(), tnative.NativeStrProcessor()
    step = chunk or len(text)
    for i in range(0, len(text), step):
        py.ingest(text[i:i + step])
        nat.ingest(text[i:i + step])
        assert list(nat.sentences) == list(py.sentences)
    py.flush()
    nat.flush()
    assert list(nat.sentences) == list(py.sentences)
    nat.reset()
    py.reset()
    assert not nat.sentences and not py.sentences
    nat.ingest("after reset. x")
    py.ingest("after reset. x")
    assert list(nat.sentences) == list(py.sentences)


@pytest.mark.parametrize("n", [0, 1, 2400])
def test_wav_bytes_equal_python(tmp_path, n):
    pcm = (np.sin(np.linspace(0, 50, n)) * 1.3).astype(np.float32)
    a, b = str(tmp_path / "n.wav"), str(tmp_path / "p.wav")
    tnative.wav_write_native(a, pcm, 24000)
    save_wav(b, pcm, 24000)
    assert open(a, "rb").read() == open(b, "rb").read()


def test_concurrent_builds_leave_one_library(tmp_path):
    """Four processes build into one empty directory at once: each gets
    the same library, which loads, and no temporary is left behind."""
    code = ("import sys; from pocket_tts_tpu_torch import native; "
            "print(native.build(sys.argv[1]))")
    env = dict(os.environ, PYTHONPATH=ROOT)
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path)],
                              cwd=ROOT, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(4)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert all(p.returncode == 0 for p in procs), outs
    paths = {o.strip() for o, _ in outs}
    assert len(paths) == 1
    files = sorted(os.listdir(tmp_path))
    assert files == sorted([os.path.basename(paths.pop()), "native.lock"])


def test_failed_build_raises_with_compiler_output(tmp_path, monkeypatch):
    bad = tmp_path / "bad.cpp"
    bad.write_text("this is not C++;\n")
    monkeypatch.setattr(tnative, "SOURCE", str(bad))
    with pytest.raises(RuntimeError, match="error"):
        tnative.build(str(tmp_path / "b"))


def test_stream_splits_with_the_native_splitter():
    from pocket_tts_tpu_torch.config import tiny_config
    from pocket_tts_tpu_torch.io.params import (random_params,
                                                random_voice_prompt)
    from pocket_tts_tpu_torch.runtime.engine import TTSEngine
    from pocket_tts_tpu_torch.text.tokenizer import MockTokenizer
    p, cfg = random_params(tiny_config(), seed=9)
    eng = TTSEngine(params=p, cfg=cfg, device="cpu",
                    tokenizer=MockTokenizer(cfg.lut.n_bins))
    stream = eng.open_stream(random_voice_prompt(cfg, 12), temp=0.0)
    assert isinstance(stream.sproc, tnative.NativeStrProcessor)
    stream.send("One sentence. And another!")
    stream.flush()
    assert list(stream.sproc.sentences) == ["One sentence.", "And another!"]
    for _ in range(3):
        pcm = stream.receive()
        assert pcm is not None and np.isfinite(pcm).all()
    assert list(stream.sproc.sentences) == ["And another!"]
