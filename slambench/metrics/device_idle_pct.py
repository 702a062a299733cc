"""The device's idle share of the profiled part of the window: 100 less
the union of its operations' intervals over the part's wall time, %."""

from slambench.metrics._layer import profiled


def read(run):
    tr = profiled(run)
    if tr is None:
        return None
    return 100.0 * (1.0 - tr["profile"]["busy_s"] / tr["window_s"])
