"""The FLOPs counted for the units traced on the card alone (`flops.py`, on
the reference at the units' own shapes) over that trace's window, as a
share of a peak of `flops.PEAK_FLOPS`, in %."""

from ..flops import PEAK_FLOPS


def read(r, peak: str = "tf32"):
    if r is None or r.device_trace is None or not r.device_units or not r.flops:
        return None
    return 100.0 * r.flops / r.device_trace.window_s / PEAK_FLOPS[peak]
