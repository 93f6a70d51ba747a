"""Model families: `families/<family>.py` holds all the harness knows of one
architecture. A configuration names it under "family" (none: `pocket_tts`).

A family gives `frame_size(conf)`, `build(conf, mix, seed, device, dtype)`
(the server), `plan(mix, seed)` (requests with `due_s`), `submit(srv, p)`,
`warm(srv, mix, plan)`, `Capture(srv, chunk_frames)` (`lanes`, `annotate`,
`close()`), `TIMED` / `PHASES` ({Run list / range name: (module, function)}),
`model_flops(run, cap, conf, mix)`, `sample(run, cap, mix, seed)` and
`judge(conf, mix, cases, seed, device, control)`. Its server has `step()`
(frames emitted), `steps`, `completed`, `_live` (each lane's request) and
`_admit`; a request `admit_step`, `first_audio_step`, `pcm`, `submitted_at`.
"""
from __future__ import annotations

import importlib.util
import sys
from pathlib import Path

DEFAULT = "pocket_tts"


def load(conf: dict, root: Path):
    """The family module a configuration names, loaded by file from
    `root/families/` (once a process)."""
    name = conf.get("family", DEFAULT)
    path = root / "families" / f"{name}.py"
    if not (name.isidentifier() and path.is_file()):
        raise SystemExit(f"model family {name!r}: no file {path}")
    key = f"{__name__}.{name}"
    mod = sys.modules.get(key)
    if mod is None or Path(mod.__file__) != path:
        spec = importlib.util.spec_from_file_location(key, path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[key] = mod
        try:
            spec.loader.exec_module(mod)
        except BaseException:
            del sys.modules[key]
            raise
    return mod
