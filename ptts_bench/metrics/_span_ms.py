"""Mean device milliseconds a frame step of the kernels launched under one
of the program's spans over the traced chunks (the trace summary's
"span_device_s", which Moshi's family adds: `moshi/spans.py`); nothing
where the program records no such span."""


def span_ms(run, name: str):
    t = run.trace
    if not t or not t.get("frame_steps"):
        return None
    s = (t.get("span_device_s") or {}).get(name)
    return 1e3 * s / t["frame_steps"] if s else None
