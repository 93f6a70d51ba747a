"""Moshi's parts of the benchmark: its traffic, plain reference, judge,
operation count and span reader (the family is `families/moshi.py`)."""
