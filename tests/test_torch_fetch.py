"""The port's model downloader (io/fetch.download_models, CLI
--fetch-models) against the JAX package's, on temporary manifests of
file:// URLs (no network): files made from a numpy seed, fetched into two
roots by the two packages."""
import hashlib
import json
import os

import numpy as np
import pytest

from pocket_tts_tpu.io import fetch as jfetch
from pocket_tts_tpu_torch.io import fetch

MODEL = "kyutai/pocket-tts-without-voice-cloning"
FILES = ("tts_b6369a24.safetensors", "tokenizer.model",
         "embeddings/cosette.safetensors")


def make_manifest(tmp_path, seed=5, pin=True):
    """A manifest of file:// URLs to seeded random files under
    tmp_path/src, in the release manifest's layout."""
    rng = np.random.RandomState(seed)
    src = tmp_path / "src"
    entries = []
    for i, rel in enumerate(FILES):
        path = src / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        data = rng.randint(0, 256, 1000 + 700 * i).astype(np.uint8)
        path.write_bytes(data.tobytes())
        entry = {"path": f"{MODEL}/{rel}", "url": path.as_uri()}
        if pin:
            entry["sha256"] = hashlib.sha256(data.tobytes()).hexdigest()
        entries.append(entry)
    return {"model": MODEL, "files": entries}


def _rel(paths, root):
    return [os.path.relpath(p, root) for p in paths]


def test_download_matches_jax(tmp_path):
    """The same relative paths written, the same bytes, the same
    verify_model_dir, no .part left."""
    man = make_manifest(tmp_path)
    roots = [str(tmp_path / "jax"), str(tmp_path / "port")]
    got = [jfetch.download_models(roots[0], man),
           fetch.download_models(roots[1], man)]
    assert _rel(got[0], roots[0]) == _rel(got[1], roots[1])
    assert _rel(got[1], roots[1]) == [f"{MODEL}/{f}" for f in FILES]
    for a, b in zip(*got):
        with open(a, "rb") as fa, open(b, "rb") as fb:
            assert fa.read() == fb.read()
    for root in roots:
        model_dir = os.path.join(root, MODEL)
        assert fetch.verify_model_dir(model_dir, man) == \
            jfetch.verify_model_dir(model_dir, man) == \
            {f: "ok" for f in FILES}
        assert not any(n.endswith(".part") for _, _, names in os.walk(root)
                       for n in names)


def test_skip_existing(tmp_path):
    """A second call writes nothing; a file whose pin no longer matches
    is fetched again; skip_existing=False fetches everything."""
    man = make_manifest(tmp_path)
    root = str(tmp_path / "root")
    assert len(fetch.download_models(root, man)) == len(FILES)
    assert fetch.download_models(root, man) == []
    bad = os.path.join(root, MODEL, FILES[1])
    with open(bad, "ab") as f:
        f.write(b"x")
    assert fetch.verify_model_dir(os.path.join(root, MODEL), man)[
        FILES[1]] == "corrupt"
    assert _rel(fetch.download_models(root, man), root) == \
        [f"{MODEL}/{FILES[1]}"]
    assert len(fetch.download_models(root, man, skip_existing=False)) == \
        len(FILES)


def test_wrong_pin_raises_and_writes_nothing(tmp_path):
    """Both packages raise with both digests, remove the .part and write
    no file."""
    man = make_manifest(tmp_path)
    real = man["files"][0]["sha256"]
    man["files"][0]["sha256"] = "0" * 64
    root = tmp_path / "root"
    for mod in (fetch, jfetch):
        with pytest.raises(RuntimeError, match="sha256 mismatch") as e:
            mod.download_models(str(root), man)
        assert f"expected {'0' * 64}, got {real}" in str(e.value)
    assert not any(names for _, _, names in os.walk(root))


def test_missing_file_url_raises_naming_it(tmp_path):
    man = make_manifest(tmp_path)
    url = (tmp_path / "src" / "gone.bin").as_uri()
    man["files"][1]["url"] = url
    with pytest.raises(RuntimeError, match="download failed") as e:
        fetch.download_models(str(tmp_path / "root"), man)
    assert url in str(e.value)
    assert "pocket_tts_tpu_torch/data/manifest.json" in str(e.value)
    part = tmp_path / "root" / MODEL / (FILES[1] + ".part")
    assert not part.exists()


def test_unpinned_files_download(tmp_path):
    man = make_manifest(tmp_path, pin=False)
    root = str(tmp_path / "root")
    assert len(fetch.download_models(root, man)) == len(FILES)
    assert fetch.download_models(root, man) == []


def test_cli_fetch_models(tmp_path, monkeypatch, capsys):
    """--fetch-models -r ROOT with the manifest path pointed at a
    temporary manifest: the files land under ROOT and the CLI prints
    "fetched N files into ROOT"."""
    from pocket_tts_tpu_torch import cli
    path = tmp_path / "manifest.json"
    path.write_text(json.dumps(make_manifest(tmp_path)))
    monkeypatch.setattr(fetch, "_MANIFEST", str(path))
    root = str(tmp_path / "models")
    assert cli.main(["--fetch-models", "-r", root]) == 0
    assert capsys.readouterr().out.strip() == \
        f"fetched {len(FILES)} files into {root}"
    assert set(fetch.verify_model_dir(os.path.join(root, MODEL),
                                      fetch.load_manifest()).values()) == \
        {"ok"}
    monkeypatch.setenv("MODEL_CACHE", root)
    assert cli.main(["--fetch-models"]) == 0
    assert capsys.readouterr().out.strip() == f"fetched 0 files into {root}"
