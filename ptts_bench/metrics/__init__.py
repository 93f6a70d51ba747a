"""Per-metric readers: read(run) -> the value, or None when there is
nothing to read."""
