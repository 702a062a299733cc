"""The port's tracer: spans and counters placed at its layer boundaries,
and ``torch.profiler`` around a region written as one Chrome trace.

    with profiling.tracing():          # or under any torch.profiler profile
        lio.process_scan(...)
    log = profiling.drain()             # {"spans": [...], "counts": {...}}

* :func:`span` (a context manager) and :func:`traced` (its decorator form):
  a named interval of the program.  Each record holds its name, the scans
  it serves as ``[first, count]`` (inherited from the enclosing span unless
  given; a window slot's is its own scan), the thread, the index of its
  parent span (on the same thread, or for the dispatch worker the span that
  dispatched it), its host start and end in ns on the profiler's clock
  (``time.time_ns``, the clock ``torch.profiler`` converts its events to),
  small args, and the counts kept under it.  On the card a span also holds
  a device interval: two CUDA events recorded on the current stream at its
  start and end, put on the same clock through one synchronised anchor
  event taken when recording starts, and resolved only when the log is
  read, never while the program runs.
* :func:`count`: adds to a counter of the innermost open span.
* :func:`to_host`: every explicit device-to-host read of the LIO path
  (``.tolist()``, ``.item()``, ``.cpu()``, ``bool``/``int``/``float`` of a
  tensor) goes through it; it returns what the bare conversion returns and
  counts ``host_read:<site>``, sites named ``<layer>.<what>``.
* Recording is on while :func:`tracing` is open and while a
  ``torch.profiler`` profile is active anywhere in the process; the
  decision holds for every thread.  Off, each span, count and read costs one
  check of two module-level flags: nothing is allocated, no torch or CUDA
  call is made and no clock is read.  The one exception is a span given a
  ``sink``: it always adds its host seconds to ``sink[key]`` (the stage
  clocks of ``LioSam.timings``).
* While a profiler is active each span is also a profiler range
  ``msst/<name>``, and each read a range ``msst/read:<site>``, so that they
  land in the profiler's trace beside the kernels and name what the host
  was doing.  They are torch's fast record-function ranges, which the
  profiler keeps on the host's timeline alone: a ``record_function``
  range would also appear on the device's (as a user annotation), where
  it would count as device work.  torch's profiler records only the thread that
  started it unless started with ``profile_all_threads`` (:func:`trace`
  does so where torch offers it); otherwise :func:`trace` merges the other
  threads' spans into the written trace from the log.

The spans (name: where):

* ``pipeline``: ``LioSam.process_scan``, ``process_window``,
  ``process_window_async`` and the dispatch worker's window; under it
  ``pack``, ``upload``, ``dispatch`` (a window's upload and step),
  ``flush`` (the batched pose readback), ``resync``, ``boot_refeed``,
  ``loop_gate``;
* ``step`` (``odometry_step_packed``, ``odometry_window_flat*``, one
  ``slot`` a window slot), ``prepare``, ``core``, ``s2m``, ``gn_iter`` (one
  a Gauss-Newton iteration, to its flag readback);
* ``keyframe`` and under it ``evict``, ``factors``, ``graph_solve``,
  ``merge``, ``refit``, ``rebake``, ``rebuild``;
* ``loop_attempt`` (``loop_closure_step``, with its result as args) and
  under it ``candidates``, ``submap``, ``coarse_icp``, ``fine``, ``close``.

Counters: ``host_read:<site>``, ``gn_iters``, ``b1_lookups``,
``icp_iters``, ``keyframes``, ``graph_solves``, ``graph_gn_iters`` (one a
Gauss-Newton iteration of a graph solve, whose span has ``iters`` among
its args), ``loop_closures``.

:func:`trace` is ``torch.profiler`` around a region with recording on,
written to ``logdir/trace.json`` (chrome://tracing or Perfetto): the device
kernels and the program's spans from every thread on one timeline.
"""

from __future__ import annotations

import contextlib
import functools
import json
import os
import threading
import time
from typing import Optional

import torch
import torch.autograd.profiler as _tap

try:
    from torch._C._profiler import _RecordFunctionFast as _Range
except ImportError:  # a torch without it: ranges also on the device's line
    _Range = _tap.record_function

# open tracing() blocks, over all threads
_on = 0
_lock = threading.Lock()
_tls = threading.local()
_session: Optional["_Session"] = None

# the clock of every record (torch.profiler's events are on the same one),
# and the CUDA event type of the device intervals
_now = time.time_ns
_Event = torch.cuda.Event


def recording() -> bool:
    """Whether spans and counts are recorded now: inside :func:`tracing`
    or while a torch.profiler profile is active."""
    return bool(_on) or _tap._is_profiler_enabled


class _Session:
    """One recording: the spans in the order they opened, the counts made
    outside any span, and the device clock's anchor."""

    started = 0

    def __init__(self):
        _Session.started += 1
        self.number = _Session.started
        self.spans: list = []
        self.counts: dict = {}
        self.lock = threading.Lock()
        self.anchor = None
        # the first profiler range of a process loads a module (~1 ms):
        # here, at the recording's start, not inside its first span
        with _Range("msst/recording"):
            pass
        self.on_card()

    def on_card(self) -> bool:
        """Whether spans take device intervals: once the process uses the
        card, the first span takes the anchor (one synchronisation a
        recording)."""
        if self.anchor is None and torch.cuda.is_initialized():
            with self.lock:
                if self.anchor is None:
                    torch.cuda.synchronize()
                    ev = _Event(enable_timing=True)
                    t0 = _now()
                    ev.record()
                    t1 = _now()
                    ev.synchronize()
                    self.anchor = (ev, (t0 + t1) // 2)
        return self.anchor is not None


def _stream():
    """This thread's current CUDA stream.  Its Stream object is kept while
    the stream stays the same: ``torch.cuda.current_stream()``, which
    ``Event.record()`` calls without one, builds a new object each call
    (7 us on the card, twice a span)."""
    data = torch._C._cuda_getCurrentStream(torch._C._cuda_getDevice())
    kept = getattr(_tls, "stream", None)
    if kept is None or kept[0] != data:
        kept = _tls.stream = (data, torch.cuda.Stream(
            stream_id=data[0], device_index=data[1], device_type=data[2]))
    return kept[1]


def _current_session() -> _Session:
    global _session
    s = _session
    if s is None:
        with _lock:
            if _session is None:
                _session = _Session()
            s = _session
    return s


def _stack() -> list:
    """This thread's open spans; the thread's id and name on first use."""
    st = getattr(_tls, "stack", None)
    if st is None:
        st = _tls.stack = []
        _tls.who = (threading.get_native_id(),
                    threading.current_thread().name)
    return st


class _Off:
    """What :func:`span` gives while recording is off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def __bool__(self):
        return False

    def note(self, **args):
        pass


_OFF = _Off()


class _Clock(_Off):
    """A span with a sink while recording is off: its host seconds alone."""

    __slots__ = ("sink", "key", "t0")

    def __init__(self, sink: dict, key: str):
        self.sink, self.key = sink, key

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.sink[self.key] = self.sink.get(self.key, 0.0) + (
            time.perf_counter() - self.t0)
        return False


class _Span:
    """A recorded span (see the module's docstring)."""

    __slots__ = ("name", "scans", "slot", "tid", "thread", "parent", "t0",
                 "t1", "args", "counts", "ev0", "ev1", "rf", "sink", "key",
                 "idx", "session")

    def __init__(self, name, scans=None, args=None, sink=None, key=None,
                 parent=None, slot=None):
        self.name, self.scans, self.args = name, scans, args
        self.sink, self.key, self.parent, self.slot = sink, key, parent, slot
        self.counts = self.ev0 = self.ev1 = self.rf = self.t1 = None

    def __bool__(self):
        return True

    def note(self, **args):
        """Add args to the record (tensors are read when the log is)."""
        if self.args is None:
            self.args = args
        else:
            self.args.update(args)

    def __enter__(self):
        s = _current_session()
        st = _stack()
        up = st[-1] if st else None
        if up is not None and up.session != s.number:
            up = None      # a span of a recording drained while it was open
        if up is not None:
            self.parent = up.idx
        elif self.parent is not None and self.parent < len(s.spans):
            up = s.spans[self.parent]
        else:
            self.parent = None
        if self.scans is None and up is not None and up.scans is not None:
            self.scans = ((up.scans[0] + self.slot, 1) if self.slot is not None
                          else up.scans)
        self.tid, self.thread = _tls.who
        self.session = s.number
        with s.lock:
            self.idx = len(s.spans)
            s.spans.append(self)
        st.append(self)
        if _tap._is_profiler_enabled:
            self.rf = _Range("msst/" + self.name)
            self.rf.__enter__()
        self.t0 = _now()
        if s.on_card():
            self.ev0 = _Event(enable_timing=True)
            self.ev0.record(_stream())
        return self

    def __exit__(self, *exc):
        if self.ev0 is not None:
            self.ev1 = _Event(enable_timing=True)
            self.ev1.record(_stream())
        self.t1 = _now()
        if self.rf is not None:
            self.rf.__exit__(None, None, None)
            self.rf = None
        st = _stack()
        if st and st[-1] is self:
            st.pop()
        elif self in st:
            st.remove(self)
        if self.sink is not None:
            self.sink[self.key] = self.sink.get(self.key, 0.0) + (
                self.t1 - self.t0) / 1e9
        return False


def span(name: str, scans=None, sink: Optional[dict] = None,
         key: Optional[str] = None, parent: Optional[int] = None, **args):
    """A span `name` over a ``with`` block.  `scans`: ``(first, count)``
    of the scans it serves (default: the enclosing span's); `parent`: the
    index of the span it belongs to where it runs on another thread than
    that span (:func:`current` on the dispatching thread); `sink`, `key`:
    the block's host seconds are added to ``sink[key]`` whether or not
    recording is on; `args`: small values kept on the record.  The object
    the ``with`` gives is false while recording is off; ``.note(**args)``
    adds args."""
    if not (_on or _tap._is_profiler_enabled):
        return _OFF if sink is None else _Clock(sink, key)
    return _Span(name, scans, args or None, sink, key, parent)


def slot(i: int):
    """The span of slot `i` of a window: its scan is the window's first
    plus `i`."""
    if not (_on or _tap._is_profiler_enabled):
        return _OFF
    return _Span("slot", None, {"slot": i}, slot=i)


def traced(name: str):
    """Decorator: every call of the function is a span `name`."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            if not (_on or _tap._is_profiler_enabled):
                return fn(*args, **kwargs)
            with _Span(name):
                return fn(*args, **kwargs)
        return wrapper
    return deco


def current() -> Optional[int]:
    """The index of this thread's innermost open span, or None."""
    if not (_on or _tap._is_profiler_enabled):
        return None
    st = getattr(_tls, "stack", None)
    return st[-1].idx if st else None


def _count(name: str, n) -> None:
    st = getattr(_tls, "stack", None)
    if st:
        sp = st[-1]
        if sp.counts is None:
            sp.counts = {}
        sp.counts[name] = sp.counts.get(name, 0) + n
        return
    s = _current_session()    # outside any span: shared by the threads
    with s.lock:
        s.counts[name] = s.counts.get(name, 0) + n


def count(name: str, n=1) -> None:
    """Add `n` to counter `name` of the innermost open span."""
    if _on or _tap._is_profiler_enabled:
        _count(name, n)


def to_host(x: torch.Tensor, site: str, conv=None):
    """``conv(x)`` (default ``x.cpu()``): an explicit device-to-host read,
    counted as ``host_read:<site>`` under the innermost open span."""
    if not (_on or _tap._is_profiler_enabled):
        return x.cpu() if conv is None else conv(x)
    _count("host_read:" + site, 1)
    if not _tap._is_profiler_enabled:
        return x.cpu() if conv is None else conv(x)
    with _Range("msst/read:" + site):
        return x.cpu() if conv is None else conv(x)


@contextlib.contextmanager
def tracing():
    """Record while the block is open (every thread); the log is kept
    until :func:`drain`."""
    global _on
    with _lock:
        _on += 1
    try:
        _current_session()
        yield
    finally:
        with _lock:
            _on -= 1


# -- reading the log -----------------------------------------------------


def _plain(v):
    """A record's arg as plain data: tensors read to the host."""
    if isinstance(v, torch.Tensor):
        return v.tolist()
    if isinstance(v, (list, tuple)):
        return [_plain(x) for x in v]
    return v


def _record(sp: _Span, s: _Session) -> dict:
    d0 = d1 = None
    if sp.ev1 is not None and s.anchor is not None:
        ev, ns = s.anchor
        d0 = ns + int(ev.elapsed_time(sp.ev0) * 1e6)
        d1 = ns + int(ev.elapsed_time(sp.ev1) * 1e6)
    return {"i": sp.idx, "name": sp.name,
            "scans": list(sp.scans) if sp.scans is not None else None,
            "tid": sp.tid, "thread": sp.thread, "parent": sp.parent,
            "t0": sp.t0, "t1": sp.t1, "d0": d0, "d1": d1,
            "args": {k: _plain(v) for k, v in (sp.args or {}).items()},
            "counts": dict(sp.counts or {})}


def log(drain: bool = False, since: int = 0) -> dict:
    """The recording as plain data: ``{"spans": [record, ...], "counts":
    {...}}``, each record a dict (``i``, ``name``, ``scans``, ``tid``,
    ``thread``, ``parent``, ``t0``, ``t1``, ``d0``, ``d1`` in ns, ``args``,
    ``counts``; ``t1`` None while open, ``d0``/``d1`` None off the card),
    from span `since` on.  Waits for the device once, to read its events.
    `drain` ends the recording: the next span starts a new one."""
    global _session
    with _lock:
        s = _session
        if drain:
            _session = None
    if s is None:
        return {"spans": [], "counts": {}}
    if s.anchor is not None:
        torch.cuda.synchronize()
    with s.lock:
        spans = list(s.spans[since:])
    return {"spans": [_record(sp, s) for sp in spans if sp.t1 is not None
                      or not drain],
            "counts": dict(s.counts)}


def drain() -> dict:
    """:func:`log` and end the recording."""
    return log(drain=True)


def mark() -> int:
    """The number of spans recorded so far (for ``log(since=...)``)."""
    s = _session
    return len(s.spans) if s is not None else 0


def by_index(spans: list) -> dict:
    return {r["i"]: r for r in spans}


def ancestors(rec: dict, index: dict) -> list:
    """The names of a record's enclosing spans, innermost first."""
    out = []
    p = rec["parent"]
    while p is not None and p in index:
        out.append(index[p]["name"])
        p = index[p]["parent"]
    return out


def self_ns(spans: list, device: bool = False) -> dict:
    """Each closed span's self time (index -> ns): its duration less the
    part of it that its child spans cover.  `device`: of the device
    intervals (spans without one are left out)."""
    a, b = ("d0", "d1") if device else ("t0", "t1")
    kids: dict = {}
    for r in spans:
        if r["parent"] is not None and r[b] is not None and r[a] is not None:
            kids.setdefault(r["parent"], []).append((r[a], r[b]))
    out = {}
    for r in spans:
        if r[a] is None or r[b] is None:
            continue
        lo, hi = r[a], r[b]
        cov, end = 0, lo
        for s, e in sorted(kids.get(r["i"], ())):
            s, e = max(s, end), min(e, hi)
            if e > s:
                cov += e - s
                end = e
        out[r["i"]] = (hi - lo) - cov
    return out


def summary(lg: dict) -> dict:
    """Per span name: calls, host and device ms, and their self ms, summed
    over a log; a span inside a loop attempt is keyed ``loop/<name>``."""
    index = by_index(lg["spans"])
    host, dev = self_ns(lg["spans"]), self_ns(lg["spans"], device=True)
    out: dict = {}
    for r in lg["spans"]:
        if r["t1"] is None:
            continue
        key = r["name"]
        if r["name"] != "loop_attempt" and "loop_attempt" in ancestors(
                r, index):
            key = "loop/" + key
        e = out.setdefault(key, {"calls": 0, "host_ms": 0.0,
                                 "self_host_ms": 0.0, "device_ms": 0.0,
                                 "self_device_ms": 0.0})
        e["calls"] += 1
        e["host_ms"] += (r["t1"] - r["t0"]) / 1e6
        e["self_host_ms"] += host[r["i"]] / 1e6
        if r["d0"] is not None:
            e["device_ms"] += (r["d1"] - r["d0"]) / 1e6
            e["self_device_ms"] += dev[r["i"]] / 1e6
    return out


def host_reads(lg: dict) -> dict:
    """Explicit host reads by site over a log."""
    out: dict = {}
    for c in [r["counts"] for r in lg["spans"]] + [lg["counts"]]:
        for k, n in c.items():
            if k.startswith("host_read:"):
                site = k[len("host_read:"):]
                out[site] = out.get(site, 0) + n
    return out


def counter_total(lg: dict, name: str) -> int:
    """Counter `name` summed over every span of a log and outside them."""
    return sum(r["counts"].get(name, 0) for r in lg["spans"]) + lg[
        "counts"].get(name, 0)


# -- the Chrome trace ----------------------------------------------------


def chrome_events(lg: dict, base_ns: int = 0, skip_tids=()) -> list:
    """One complete ("X") event a closed span, on its thread (category
    ``msst``; args: scans, parent, self us, its args and counts), and one a
    device interval on a track of its own (category ``msst_device``);
    times in us from `base_ns`."""
    pid = os.getpid()
    selfs = self_ns(lg["spans"])
    ev, threads, dev = [], {}, False
    for r in lg["spans"]:
        if r["t1"] is None or r["tid"] in skip_tids:
            continue
        threads[r["tid"]] = r["thread"]
        args = {"scans": r["scans"], "span": r["i"], "parent": r["parent"],
                "self_us": selfs.get(r["i"], 0) / 1e3}
        args.update(r["args"])
        args.update(r["counts"])
        ev.append({"ph": "X", "cat": "msst", "name": "msst/" + r["name"],
                   "pid": pid, "tid": r["tid"],
                   "ts": (r["t0"] - base_ns) / 1e3,
                   "dur": (r["t1"] - r["t0"]) / 1e3, "args": args})
        if r["d0"] is not None:
            dev = True
            ev.append({"ph": "X", "cat": "msst_device",
                       "name": "msst/" + r["name"], "pid": pid, "tid": 0,
                       "ts": (r["d0"] - base_ns) / 1e3,
                       "dur": max(r["d1"] - r["d0"], 0) / 1e3,
                       "args": {"scans": r["scans"], "span": r["i"]}})
    for tid, name in threads.items():
        ev.append({"ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
                   "args": {"name": name}})
    if dev:
        ev.append({"ph": "M", "name": "thread_name", "pid": pid, "tid": 0,
                   "args": {"name": "msst spans on the device"}})
    return ev


def write_chrome(path: str, lg: Optional[dict] = None) -> int:
    """Write a log (default: the current one, kept) as a Chrome trace;
    returns the number of span events."""
    lg = log() if lg is None else lg
    ev = chrome_events(lg)
    with open(path, "w") as f:
        json.dump({"traceEvents": ev, "displayTimeUnit": "ms"}, f)
    return sum(1 for e in ev if e.get("cat") == "msst")


def _all_threads_config():
    """torch.profiler's option to record every thread, where this torch
    has it (else None)."""
    try:
        from torch._C._profiler import _ExperimentalConfig

        return _ExperimentalConfig(profile_all_threads=True)
    except (ImportError, TypeError):
        return None


@contextlib.contextmanager
def trace(logdir: str):
    """``torch.profiler`` around a region (the CPU, and the card where one
    is present) with recording on, written to ``logdir/trace.json``: the
    device kernels, every thread's host ops where torch can record them,
    and the program's spans (``msst/<name>``) from every thread."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    cfg = _all_threads_config()
    kw = {"experimental_config": cfg} if cfg is not None else {}
    me = threading.get_native_id()
    with tracing():
        start = mark()
        with profile(activities=acts, **kw) as prof:
            yield prof
    path = os.path.join(logdir, "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        doc = json.load(f)
    lg = log(since=start)
    if cfg is None:
        # the profiler recorded this thread's spans only
        others = {r["tid"] for r in lg["spans"]} - {me}
        lg = {"spans": [r for r in lg["spans"] if r["tid"] in others],
              "counts": lg["counts"]}
    else:
        lg = {"spans": [r for r in lg["spans"] if r["d0"] is not None],
              "counts": lg["counts"]}
    ev = chrome_events(lg, int(doc.get("baseTimeNanoseconds", 0)))
    if cfg is not None:
        ev = [e for e in ev if e.get("cat") != "msst"]
    doc.setdefault("traceEvents", []).extend(ev)
    with open(path, "w") as f:
        json.dump(doc, f)
