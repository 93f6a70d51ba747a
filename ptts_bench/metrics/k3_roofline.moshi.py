"""K3 in Moshi's cell (four stages): its calls' share of their roofline
over the traced chunks (`kernels/k3.py`, whose operations count the first
conv as in_ch -> in_ch: 512 -> 512 where Moshi's widens to 1024, about
2.5% of the frame's, so the share reads that much low), in %."""
from ._kernel_roofline import share


def read(run):
    return share(run, "k3")
