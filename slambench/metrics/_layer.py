"""Shared arithmetic of the span readers."""


def per_scan(run, key: str, self_time: bool = False):
    """ms of span `key` per scan of the span part (None without spans)."""
    tr = run.get("trace")
    if not tr or not tr["span_scans"]:
        return None
    rec = tr["spans"].get(key)
    if rec is None:
        return 0.0
    return (rec[1] if self_time else rec[0]) / tr["span_scans"]


def per_call(run, key: str):
    """ms of span `key` per call (None without a call)."""
    tr = run.get("trace")
    if not tr:
        return None
    rec = tr["spans"].get(key)
    if not rec or not rec[2]:
        return None
    return rec[0] / rec[2]


def profiled(run):
    """The profiler part's reduction, or None where it saw no device work."""
    tr = run.get("trace")
    if not tr or not tr["profile"]["device_events"] or not tr["prof_scans"]:
        return None
    return tr
