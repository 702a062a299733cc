"""Pose-graph solve (``graph.optimize`` or ``optimize_cg``, at keyframes
after a closure and in each closure's re-solve), synced spans, ms a solve."""

from slambench.metrics._layer import per_call


def read(run):
    return per_call(run, "graph_solve")
