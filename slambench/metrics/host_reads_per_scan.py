"""Explicit device-to-host reads of the program (its ``host_read:<site>``
counters, every site, kept under whichever span made them) over the
profiled part, per scan of that part."""

from slambench.metrics._program import program_log


def read(run):
    lg = program_log(run)
    if lg is None:
        return None
    counts = [r["counts"] for r in lg["spans"]] + [lg["counts"]]
    n = sum(v for c in counts for k, v in c.items()
            if k.startswith("host_read:"))
    return n / run["trace"]["prof_scans"]
