"""The mean over the units that no profiler touched of a per-unit reading
in seconds, in milliseconds: a host span that the traffic timed by the
host's clock, or the growth of a program counter of seconds."""


def read(r, span: str):
    if r is None or not r.spans.get(span):
        return None
    values = r.spans[span]
    return 1e3 * sum(values) / len(values)
