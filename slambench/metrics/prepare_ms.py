"""The frontend and IMU preintegration (``mapping.prepare_scan`` and
``prepare_scan_grid``), synced spans, ms a scan."""

from slambench.metrics._layer import per_scan


def read(run):
    return per_scan(run, "prepare")
