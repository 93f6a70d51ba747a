"""The kernel library's ctypes table (ops/cuda_lib.SIGNATURES) against
the C entry points of the sources under csrc/: each entry exists, with as
many parameters as the table gives it. A missing or renamed entry would
otherwise show only when the library loads on the card."""
import glob
import os
import re

from pocket_tts_tpu_torch.ops import cuda_lib


def c_entries():
    out = {}
    for path in glob.glob(os.path.join(cuda_lib.CSRC, "*.cu")):
        with open(path) as f:
            src = f.read()
        for m in re.finditer(r'extern "C" int (\w+)\(([^)]*)\)', src):
            out[m.group(1)] = len([a for a in m.group(2).split(",")
                                   if a.strip()])
    return out


def test_signatures_match_the_c_entry_points():
    entries = c_entries()
    assert set(cuda_lib.SIGNATURES) == set(entries)
    for name, argtypes in cuda_lib.SIGNATURES.items():
        assert len(argtypes) == entries[name], name
