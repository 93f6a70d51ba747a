"""K2 in Moshi's cell (2 new rows a frame, Mimi's 8 layers): its calls'
share of their roofline over the traced chunks (`kernels/k2.py`), in %."""
from ._kernel_roofline import share


def read(run):
    return share(run, "k2")
