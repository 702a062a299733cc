"""Keyframe and map update (``mapping._insert_keyframe``), synced spans,
ms a keyframe scan: the cost the keyframe scans add to the tail."""

from slambench.metrics._layer import per_call


def read(run):
    return per_call(run, "keyframe")
