"""Share of the traced window in which no kernel, copy or set ran on the
card: 100 x (1 - union of their intervals / window)."""


def read(run):
    if run.device_trace is None:
        raise LookupError("no device trace")
    busy, _ = run.device_trace.busy()
    if busy <= 0:
        raise LookupError("the trace holds no device activity")
    return 100.0 * (1.0 - busy / run.device_trace.window_s)
