"""A kernel entry's share of its roofline, in %: the least time of its
calls in the units traced on host and card (`costs.py`, `flops.bound_s`)
over the device time of everything launched inside them: forward, inside the `bench::<entry>`
ranges that the traced run puts around the entry; backward, inside the
autograd nodes that ran the backward of those calls. Nothing to read where
the entry made no call in the profiled units."""

from ..flops import bound_s


def read(r, entry: str, direction: str = "forward"):
    if r is None or r.range_trace is None or not r.range_units:
        return None
    calls = r.entries.get(entry)
    if calls is None:
        return None
    if direction == "forward":
        costs = calls.forward
        seconds = r.range_trace.device_s_in(lambda name: name == calls.range_name())
    else:
        costs = calls.backward
        nodes = calls.nodes
        seconds = r.range_trace.device_s_in(
            lambda name: name in nodes or name.rsplit(": ", 1)[-1] in nodes)
    if not costs or not seconds:
        return None
    least = sum(bound_s(n_bytes, ops, peak) for n_bytes, ops, peak in costs)
    return 100.0 * least / seconds
