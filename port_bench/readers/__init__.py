"""Per-layer metric readers: one module each, `read(readings, **args)`, which
returns the metric's value, or None where the run holds nothing to read."""
