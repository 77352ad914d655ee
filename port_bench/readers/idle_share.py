"""The share of the window traced on the card alone in which no kernel,
copy or fill ran on the device, in %."""


def read(r):
    if r is None or r.device_trace is None or not r.device_units:
        return None
    return 100.0 * (1.0 - r.device_trace.busy_s / r.device_trace.window_s)
