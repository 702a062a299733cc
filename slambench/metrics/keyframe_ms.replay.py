"""Keyframe and map update (``mapping._insert_keyframe``, graph solves
inside), synced spans, ms a scan."""

from slambench.metrics._layer import per_scan


def read(run):
    return per_scan(run, "keyframe")
