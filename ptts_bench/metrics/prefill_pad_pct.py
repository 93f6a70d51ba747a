"""Share of the admission prefills' token rows that were padding, over the
traced chunks, in %: 100 x (1 - real text tokens / (lanes padded to a
power of two x text bucket)), from the attributes of the program's
`ptt.prefill` spans."""
from .host_read_ms import traced


def read(run):
    tokens = slots = 0
    for _, under in traced(run):
        for k in under:
            if k.name == "ptt.prefill":
                tokens += k.attrs["tokens"]
                slots += k.attrs["token_slots"]
    return 100.0 * (1.0 - tokens / slots) if slots else None
