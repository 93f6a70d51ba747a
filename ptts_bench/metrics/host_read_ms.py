"""Mean host milliseconds of a step's read of its chunk (the program's
`ptt.read` span: from the chunk's last launch returning to PCM, valid and
done in host memory), over the traced chunks.

`traced(run)` hands the program's spans of the traced chunks to the other
span readers: each `ptt.step` that starts after the window closed, with
its `step` attribute within `run.notes["traced_steps"]`, and the spans
under it. A program that records no spans gives none."""


def traced(run):
    """[(the ptt.step span, [every span under it])] of the traced chunks;
    [] where the program records no spans."""
    try:
        from pocket_tts_tpu_torch.utils.profiling import recorded_spans
    except ImportError:
        return []
    lo, hi = run.notes.get("traced_steps", (0, 0))
    spans = [s for s in recorded_spans() if s.end_ns is not None]
    kids = {}
    for s in spans:
        kids.setdefault(s.parent, []).append(s)
    out = []
    for s in spans:
        if (s.name == "ptt.step" and s.start_ns * 1e-9 > run.t_close
                and lo <= s.attrs.get("step", -1) < hi):
            under, todo = [], list(kids.get(s.i, []))
            while todo:
                k = todo.pop()
                under.append(k)
                todo += kids.get(k.i, [])
            out.append((s, under))
    return out


def ms(s):
    return (s.end_ns - s.start_ns) * 1e-6


def read(run):
    xs = [ms(k) for _, under in traced(run) for k in under
          if k.name == "ptt.read"]
    return sum(xs) / len(xs) if xs else None
