"""Scan-to-map registration (``registration.scan_to_map_voxel``, with
kernel B1 inside), synced spans, ms a scan."""

from slambench.metrics._layer import per_scan


def read(run):
    return per_scan(run, "s2m")
