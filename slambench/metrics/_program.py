"""The program's own log of the profiled part: the spans and counters that
``msst_torch.utils.profiling`` records while a torch.profiler profile is
active (the traced window's second half is the one such part of a run)."""


def program_log(run):
    """The log, or None where the run has no traced part or the program
    records nothing (a program without the tracer included)."""
    tr = run.get("trace")
    if not tr or not tr.get("prof_scans"):
        return None
    try:
        from msst_torch.utils import profiling
        read = profiling.log
    except (ImportError, AttributeError):
        return None
    lg = read()
    return lg if lg["spans"] else None


def ancestors(rec: dict, index: dict) -> list:
    """The names of a span's enclosing spans, innermost first."""
    out = []
    p = rec["parent"]
    while p is not None and p in index:
        out.append(index[p]["name"])
        p = index[p]["parent"]
    return out
