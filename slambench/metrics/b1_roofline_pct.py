"""Kernel B1's share of its roofline (``csrc/voxel_lookup.cu``, profiler
part): the least time of its calls (``slambench.kernel_work``: each
distinct probe row, the queries and outputs once, against 3.35 TB/s and
67 TFLOP/s f32) over the device time of its launches, %."""

from slambench import kernel_work
from slambench.metrics._layer import profiled

KERNEL = "voxel_lookup"


def read(run):
    tr = profiled(run)
    if tr is None:
        return None
    events = [e for e in tr["profile"]["device_events"] if KERNEL in e[0]]
    calls = [c for c in tr["b1_calls"] if c[0][2].shape[0] > 0]
    if not events or len(events) != len(calls):
        return None
    device_s = sum(e[2] - e[1] for e in events) / 1e6
    least = 0.0
    for args, kwargs in calls:
        vmap_a, vmap_b, q_xyz, q_mask, n_a = args
        least += kernel_work.least_seconds(kernel_work.voxel_lookup_work(
            vmap_a, vmap_b, q_xyz, q_mask, n_a))
    return 100.0 * least / device_s
