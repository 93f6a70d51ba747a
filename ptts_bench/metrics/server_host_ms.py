"""Mean host milliseconds a traced chunk's step spends outside its
prefill, decode chunk and host read: the program's `ptt.step` span less
the `ptt.prefill`, `ptt.chunk` and `ptt.read` spans under it (queue scan,
validation, lane writes, noise draws, the lane loop)."""
from .host_read_ms import ms, traced

TIMED = ("ptt.prefill", "ptt.chunk", "ptt.read")


def read(run):
    xs = [ms(step) - sum(ms(k) for k in under if k.name in TIMED)
          for step, under in traced(run)]
    return sum(xs) / len(xs) if xs else None
