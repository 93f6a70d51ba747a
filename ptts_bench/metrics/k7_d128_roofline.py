"""K7 at head width 128 (Moshi's temporal attention): its calls' share of
their roofline over the traced chunks (`kernels/k7.py`), in %."""
from ._kernel_roofline import share


def read(run):
    return share(run, "k7", lambda rec: rec["d"] == 128)
