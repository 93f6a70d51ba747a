"""The reading of `queue_wait_p95_ms`, by its reader, as a per-layer metric
that moves `audio_frames_per_s`: in the cells whose tails spread too widely
between runs to be held to a bound, and which report `audio_frames_per_s`
and `setup_s` end to end (BENCHMARK.json lists them)."""
from .queue_wait_p95_ms import read  # noqa: F401
