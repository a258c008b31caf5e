"""device_idle_pct (%): 1 - the union of the intervals in which a device
operation (kernel, copy or set) ran, over the traced window's wall time."""

from audiobench import trace


def read(rec):
    return trace.idle_pct(rec)
