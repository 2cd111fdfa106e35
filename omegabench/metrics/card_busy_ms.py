"""The card's busy time a step, in milliseconds: the union of the
intervals in which a kernel, copy or set ran on the card over the window,
from the profiler's trace, over the steps completed in it."""

from omegabench.readers import window_steps


def read(run):
    if run.device_trace is None:
        raise LookupError("no device trace")
    busy, _ = run.device_trace.busy()
    if busy <= 0:
        raise LookupError("the trace holds no device activity")
    return 1e3 * busy / len(window_steps(run))
