"""Mean device milliseconds a frame step of the kernels launched under the
program's `ptt.mimi` span (the RVQ, the upsample, Mimi's transformer on
K2 and SEANet on K3), over the traced chunks."""
from ._span_ms import span_ms


def read(run):
    return span_ms(run, "ptt.mimi")
