"""Device busy time (the union of its operations' intervals) per scan of
the profiled part, ms."""

from slambench.metrics._layer import profiled


def read(run):
    tr = profiled(run)
    if tr is None:
        return None
    return 1000.0 * tr["profile"]["busy_s"] / tr["prof_scans"]
