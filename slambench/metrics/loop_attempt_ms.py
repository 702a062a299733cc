"""Loop closure (``loop_closure_step`` as the pipeline dispatches it, past
its host pre-gate), synced spans, ms an attempt."""

from slambench.metrics._layer import per_call


def read(run):
    return per_call(run, "loop_attempt")
