"""The port's benchmark: see run.py and BENCHMARK.json."""
