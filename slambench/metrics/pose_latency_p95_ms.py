"""Live latency, 95th percentile by nearest rank over every scan due in
the window: its pose on the host less its due time; a scan without a pose
counts as inf."""

from slambench import stats


def read(run):
    w = run["window"]
    if w["mode"] != "live":
        return None
    return 1000.0 * stats.nearest_rank(w["latencies"], 95)
