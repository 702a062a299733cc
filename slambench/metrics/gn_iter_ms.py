"""One Gauss-Newton iteration of the odometry's scan-to-map (the program's
``gn_iter`` spans inside ``s2m`` inside ``core``, never inside a loop
attempt; each runs to its iteration's flag readback): the mean of their
device intervals over the profiled part, ms (their host intervals where
the spans carry none, as on the CPU)."""

from slambench.metrics._program import ancestors, program_log


def read(run):
    lg = program_log(run)
    if lg is None:
        return None
    index = {r["i"]: r for r in lg["spans"]}
    ms = []
    for r in lg["spans"]:
        if r["name"] != "gn_iter" or r["t1"] is None:
            continue
        up = ancestors(r, index)
        if up[:2] != ["s2m", "core"] or "loop_attempt" in up:
            continue
        if r["d0"] is not None:
            ms.append((r["d1"] - r["d0"]) / 1e6)
        else:
            ms.append((r["t1"] - r["t0"]) / 1e6)
    return sum(ms) / len(ms) if ms else None
