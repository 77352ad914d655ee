"""Device milliseconds a unit (step or request) launched inside the ranges
named `range`, in the units traced on host and card."""


def read(r, range: str):
    if r is None or r.range_trace is None or not r.range_units:
        return None
    s = r.range_trace.device_s_in(lambda name: name == range)
    return None if s is None else 1e3 * s / r.range_units
