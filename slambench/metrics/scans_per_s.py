"""Replay rate: every scan fed in the window over the time from the
window's start until all their poses are on the host (the pipeline's own
readback; a loop attempt counts in the scan that dispatched it)."""

from slambench import stats


def read(run):
    w = run["window"]
    if w["mode"] != "replay":
        return None
    return stats.rate(w["attempted"], w["t0"], w["t_end"])
