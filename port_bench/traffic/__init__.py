"""Traffic kinds: one module each, `run(cell) -> spec.Outcome`."""
