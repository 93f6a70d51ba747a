"""The release manifest, the check of a model directory against it, and
the downloader.

Counterpart of `pocket_tts_tpu/io/fetch.py`: the release's files with
their sha256 pins (the port's own copy of the JSON,
`pocket_tts_tpu_torch/data/manifest.json`), the sha256 of a file,
`verify_model_dir`, which says of each manifest file under a directory
whether it is there and matches its pin, and `download_models`, which
fetches the files with the standard library's urllib (any URL it opens:
https, or file:// for a local mirror), each into `<path>.part`, checks
its pin and only then moves it into place. A failed fetch or a wrong pin
raises RuntimeError and leaves nothing behind.
"""
from __future__ import annotations

import hashlib
import json
import os
from typing import Optional

_MANIFEST = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                         "data", "manifest.json")


def load_manifest(path: Optional[str] = None) -> dict:
    with open(path or _MANIFEST) as f:
        return json.load(f)


def sha256_file(path: str, chunk: int = 1 << 20) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while block := f.read(chunk):
            h.update(block)
    return h.hexdigest()


def verify_model_dir(root: str, manifest: Optional[dict] = None) -> dict:
    """Check which manifest files exist under `root` and whether their
    sha256 pins match. Returns {relpath: "ok"|"missing"|"corrupt"}."""
    manifest = manifest or load_manifest()
    prefix = manifest["model"] + "/"
    status = {}
    for entry in manifest["files"]:
        rel = entry["path"]
        rel = rel[len(prefix):] if rel.startswith(prefix) else rel
        path = os.path.join(root, rel)
        if not os.path.exists(path):
            status[rel] = "missing"
        elif "sha256" in entry and sha256_file(path) != entry["sha256"]:
            status[rel] = "corrupt"
        else:
            status[rel] = "ok"
    return status


def download_models(dest_root: str, manifest: Optional[dict] = None,
                    skip_existing: bool = True) -> list:
    """Fetch every manifest file into dest_root (MODEL_CACHE layout:
    dest_root/kyutai/pocket-tts-without-voice-cloning/...), verifying
    sha256; a file already there with a matching pin is skipped under
    skip_existing. Raises RuntimeError naming the URL when a fetch fails,
    or both digests when a pin does not match (the partial file removed).
    Returns the list of files written."""
    import urllib.request
    manifest = manifest or load_manifest()
    written = []
    for entry in manifest["files"]:
        path = os.path.join(dest_root, entry["path"])
        pin = entry.get("sha256")
        if skip_existing and os.path.exists(path) \
                and (pin is None or sha256_file(path) == pin):
            continue
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = path + ".part"
        try:
            urllib.request.urlretrieve(entry["url"], tmp)
        except Exception as e:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise RuntimeError(
                f"download failed for {entry['url']}: {e}. This "
                "environment may have no network egress; fetch the files "
                "listed in pocket_tts_tpu_torch/data/manifest.json manually "
                f"into {dest_root}.") from e
        if pin is not None:
            got = sha256_file(tmp)
            if got != pin:
                os.unlink(tmp)
                raise RuntimeError(
                    f"sha256 mismatch for {entry['path']}: expected "
                    f"{pin}, got {got}")
        os.replace(tmp, path)
        written.append(path)
    return written
