"""Shared arithmetic of the kernel counts: bytes of tensors and of the
linears of a params dict, as each input byte read once and each output
byte written once."""
from __future__ import annotations


def nbytes(t) -> int:
    return 0 if t is None else t.numel() * t.element_size()


def rows_of(x) -> int:
    return x.numel() // x.shape[-1]


def linear_shape(p) -> tuple:
    """(K, N) of a linear params dict: float {"w"}, int8 {"q"} or int4
    {"q4": (K/2, N)}."""
    if "w" in p:
        return tuple(p["w"].shape[-2:])
    if "q" in p:
        return tuple(p["q"].shape[-2:])
    k2, n = p["q4"].shape[-2:]
    return 2 * k2, n


def tree_bytes(p) -> int:
    """Bytes of every tensor of a (nested) params dict."""
    if isinstance(p, dict):
        return sum(tree_bytes(v) for v in p.values())
    if isinstance(p, (list, tuple)):
        return sum(tree_bytes(v) for v in p)
    return nbytes(p) if hasattr(p, "element_size") else 0
