"""Mean device milliseconds a frame step of the kernels launched under the
program's `ptt.depth` span (Moshi's depth transformer: its 8 sub-steps
and their draws), over the traced chunks."""
from ._span_ms import span_ms


def read(run):
    return span_ms(run, "ptt.depth")
