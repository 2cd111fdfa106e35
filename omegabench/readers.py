"""Arithmetic the metric readers share.  A reader raises LookupError with
its reason where the run holds nothing for it to read."""

from omegabench import peaks


def window_steps(run):
    if not run.steps:
        raise LookupError("no step completed in the window")
    return run.steps


def per_step(values, run, what):
    """Mean over the window's steps of the per-step sums of
    (step, value) pairs; steps without one count as 0."""
    n = len(window_steps(run))
    vals = [v for s, v in values if 0 <= s < n]
    if not vals:
        raise LookupError("no %s in the window's steps" % what)
    return sum(vals) / n


def host_span_s(run, name):
    return per_step([(s, b - a) for n, s, a, b in run.probe.spans
                     if n == name], run, "%s span" % name)


def device_ms(run, name):
    return per_step([(s, ms) for n, s, ms in run.probe.device_ms
                     if n == name], run, "%s device span" % name)


def roofline_pct(run, kernel):
    """100 x least time / kernel time over the window's launches of
    `kernel`: least time from the bytes the probe counted a launch (its
    inputs read once, its outputs written once) at the data sheet's HBM
    rate, kernel time from the device trace."""
    if run.device_trace is None:
        raise LookupError("no device trace")
    times = run.device_trace.kernel_times(kernel + "_kernel")
    if not times:
        raise LookupError("the trace holds no %s_kernel" % kernel)
    n = len(window_steps(run))
    nbytes = [b for k, s, b in run.probe.launches
              if k == kernel and 0 <= s < n]
    if len(nbytes) != len(times):
        raise LookupError("%d %s launches counted, %d in the trace"
                          % (len(nbytes), kernel, len(times)))
    return 100.0 * peaks.least_seconds(sum(nbytes)) / sum(times)


def phase_s(run, part):
    if not run.phases:
        raise LookupError("no assembly log in the window")
    return sum(p[part] for p in run.phases) / len(run.phases)
