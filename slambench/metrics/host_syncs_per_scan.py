"""Host calls that wait for the device (stream, device and event
synchronisations, blocking copies) per scan of the profiled part."""

from slambench.metrics._layer import profiled


def read(run):
    tr = profiled(run)
    if tr is None:
        return None
    return tr["profile"]["syncs"] / tr["prof_scans"]
