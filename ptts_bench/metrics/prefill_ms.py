"""Mean host milliseconds of one admission group's prefill
(`runtime/batched.batched_sentence_prefill`), synchronized before and
after, over the window of the traced run."""


def read(run):
    xs = run.prefill_s
    return 1e3 * sum(xs) / len(xs) if xs else None
