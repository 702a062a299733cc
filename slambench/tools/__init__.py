"""Tools beside the benchmark: cells run in series with their spreads, and
the control of `correct`."""
