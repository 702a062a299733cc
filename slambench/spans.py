"""Synced spans and profiler reductions, put on the program from outside.

Frozen copy of the technique of ``msst_torch/utils/profile_drive.py`` at
commit e686079 (its run B, ``_synced_spans``, and run C, ``_device_events``
and ``_api_counts``), kept here so that the yardstick does not change with
the program.  Changed from the source: a span records its self time (its
duration less that of the spans it encloses on the same thread) beside its
duration; an entry point the program no longer has is listed (the
harness then refuses the run); the profiler's device intervals are merged for the busy
time and the idle gaps are named by the host op they fall in.
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager

import torch

# host calls that wait for the device
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize", "cudaMemcpy")


class MissingTargets(RuntimeError):
    """Entry points of the program that a traced run reads and cannot find
    (renamed or removed): the run is refused, so that a rename cannot
    quietly change what a layer's metric sums."""

    def __init__(self, names):
        self.names = list(names)
        super().__init__("the program lacks the traced entry points "
                         + ", ".join(self.names))


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@contextmanager
def synced_spans(targets, device, totals: dict):
    """Replace each entry point of `targets` ((owner, attribute, key): a
    module or class and the name of a function on it) by a version that
    synchronises the device before and after and adds to ``totals[key]``
    [ms, self ms, calls].  Spans nest per thread: a span's self time leaves
    out the spans it encloses.  Yields the entry points the program lacks,
    as ``Owner.attribute``."""
    local = threading.local()
    saved, missing = [], []
    for owner, name, key in targets:
        fn = owner.__dict__.get(name) if isinstance(owner, type) else getattr(
            owner, name, None)
        if fn is None:
            missing.append(f"{owner.__name__}.{name}")
            continue

        def timed(*args, _fn=fn, _key=key, **kwargs):
            stack = getattr(local, "stack", None)
            if stack is None:
                stack = local.stack = []
            _sync(device)
            t0 = time.perf_counter()
            stack.append(0.0)
            try:
                return _fn(*args, **kwargs)
            finally:
                _sync(device)
                ms = 1000.0 * (time.perf_counter() - t0)
                inner = stack.pop()
                if stack:
                    stack[-1] += ms
                rec = totals.setdefault(_key, [0.0, 0.0, 0])
                rec[0] += ms
                rec[1] += ms - inner
                rec[2] += 1

        # the kernel wrappers count their launches on the attribute
        timed.launches = getattr(fn, "launches", 0)
        saved.append((owner, name, fn))
        setattr(owner, name, timed)
    try:
        yield missing
    finally:
        for owner, name, fn in saved:
            setattr(owner, name, fn)


@contextmanager
def recorded_calls(owner, name, calls: list):
    """Append the arguments of every call of ``owner.name`` to `calls`
    while the context lasts (no synchronisation).  Raises where the
    program lacks it."""
    fn = getattr(owner, name, None)
    if fn is None:
        raise MissingTargets([f"{owner.__name__}.{name}"])

    def recorded(*args, **kwargs):
        calls.append((args, kwargs))
        return fn(*args, **kwargs)

    recorded.launches = getattr(fn, "launches", 0)
    setattr(owner, name, recorded)
    try:
        yield
    finally:
        setattr(owner, name, fn)


def short_name(name: str, width: int = 120) -> str:
    """A device op's name without the argument list of a C++ symbol, cut
    to `width` characters."""
    if "::" in name and name.endswith(")"):
        depth = 0
        for i in range(len(name) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(name[i], 0)
            if depth == 0:
                name = name[:i]
                break
    if name.startswith("void "):
        name = name[5:]
    return name[:width]


def _interval(ev):
    tr = ev.time_range
    return tr.start, tr.end


def reduce_profile(prof, top: int = 10) -> dict:
    """What a finished ``torch.profiler`` run saw on the device: the
    device events (name, start us, end us), the busy time as the union of
    their intervals, the span from the first to the last, the host calls
    that wait for the device, the `top` device ops by time, and the idle
    gaps between device work summed by the innermost host op each gap
    starts in."""
    events = prof.events()
    dev, host = [], []
    for ev in events:
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            s, e = _interval(ev)
            dev.append((ev.name, s, e))
        else:
            host.append(ev)
    dev.sort(key=lambda x: x[1])
    busy_us, gaps = 0.0, []
    cur_s = cur_e = None
    for _, s, e in dev:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy_us += cur_e - cur_s
                gaps.append((cur_e, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy_us += cur_e - cur_s
    by_op: dict = {}
    for ev in dev:
        key = short_name(ev[0])
        by_op[key] = by_op.get(key, 0.0) + (ev[2] - ev[1])
    syncs = sum(1 for ev in host if ev.name in SYNC_CALLS)
    # a gap is named by the innermost host op open at its start
    host_iv = sorted(((ev.name,) + _interval(ev) for ev in host),
                     key=lambda x: x[1])
    gap_by: dict = {}
    j, open_ops = 0, []
    for gs, ge in gaps:
        while j < len(host_iv) and host_iv[j][1] <= gs:
            open_ops.append(host_iv[j])
            j += 1
        open_ops = [op for op in open_ops if op[2] > gs]
        name = (min(open_ops, key=lambda op: op[2] - op[1])[0]
                if open_ops else "(no host op)")
        gap_by[name] = gap_by.get(name, 0.0) + (ge - gs)
    return {
        "device_events": dev,
        "busy_s": busy_us / 1e6,
        "syncs": syncs,
        "device_ops": sorted(([k, v / 1e6] for k, v in by_op.items()),
                             key=lambda kv: -kv[1])[:top],
        "idle_gaps": sorted(([k, v / 1e6] for k, v in gap_by.items()),
                            key=lambda kv: -kv[1])[:top],
    }
