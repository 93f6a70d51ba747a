"""The release manifest and the check of a model directory against it.

Counterpart of the manifest half of `pocket_tts_tpu/io/fetch.py`: the
release's files with their sha256 pins (the port's own copy of the JSON,
`pocket_tts_tpu_torch/data/manifest.json`), the sha256 of a file, and
`verify_model_dir`, which says of each manifest file under a directory
whether it is there and matches its pin. The downloader is not ported.
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
