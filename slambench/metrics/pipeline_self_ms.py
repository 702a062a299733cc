"""Self time of the host pipeline (``LioSam.process_scan``,
``process_window``, ``process_window_async``, ``_dispatch_window``: the
packing, upload, readback, loop pre-gate and flushes, less the step and the
loop attempts they enclose), synced spans, ms a scan."""

from slambench.metrics._layer import per_scan


def read(run):
    return per_scan(run, "pipeline", self_time=True)
