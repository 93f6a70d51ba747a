"""Mean device milliseconds a frame step of the kernels launched under the
program's `ptt.temporal` span (Moshi's temporal transformer and text
head, K7 and the cuBLAS linears among them), over the traced chunks."""
from ._span_ms import span_ms


def read(run):
    return span_ms(run, "ptt.temporal")
