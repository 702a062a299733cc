"""Set-up: from the process's start (imports, the drive's simulation, the
kernels' build in a fresh checkout, the boot and fast-forward scans, the
loop warm-up) to the window's start, on the host clock."""


def read(run):
    return run["setup_s"]
