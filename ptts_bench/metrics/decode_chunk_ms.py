"""Mean host milliseconds of one decode chunk
(`runtime/batched.continuous_decode_chunk`), synchronized before and after,
over the window of the traced run."""


def read(run):
    xs = run.chunk_s
    return 1e3 * sum(xs) / len(xs) if xs else None
