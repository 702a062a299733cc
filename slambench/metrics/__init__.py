"""One reader per metric: ``metrics/<name>.py`` (or, for a metric named
``<quantity>.<suffix>``, ``metrics/<quantity>.py``) defines ``read(run)``,
which gives the metric's value from one run's record, or None where the run
has nothing to read (the harness then leaves the metric out).

A run's record: ``setup_s``; ``window`` (``mode``, ``t0``, ``t_end``,
``attempted``, and in live mode ``latencies``, seconds, inf where a scan
never got its pose); ``trace`` in a ``--trace 1`` run (``spans``: key ->
[ms, self ms, calls] over the span part, ``span_scans``; ``profile``: the
profiler part's reduction, ``prof_scans``, ``window_s``; ``b1_calls``: the
arguments of every ``voxelmap.lookup_cat`` call in the profiler part).
"""
