"""The device's side of a traced run: torch.profiler over the measured
window, read back from its Chrome trace.

Device activity is every kernel, copy and set on the card.  The window is
the `omegabench.window` annotation, and the benchmark's host spans are
placed on the trace's clock through it: its start is the host clock's
window start.
"""

import contextlib
import json
import os
import re

WINDOW = "omegabench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


@contextlib.contextmanager
def profiled(enabled, workdir, device):
    """Profile the block on `device` where enabled; yields a dict that holds,
    once the block has ended, `trace` (the parsed events) or nothing."""
    out = {}
    if not enabled:
        yield out
        return
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    path = os.path.join(workdir, "trace.json")
    with profile(activities=acts) as prof:
        with record_function(WINDOW):
            yield out
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    prof.export_chrome_trace(path)
    with open(path) as f:
        out["trace"] = json.load(f)
    os.remove(path)


class DeviceTrace:
    """Device intervals (trace microseconds) inside the window."""

    def __init__(self, trace):
        events = trace.get("traceEvents", [])
        win = [e for e in events if e.get("name") == WINDOW
               and e.get("ph") == "X"]
        if not win:
            raise LookupError("the trace holds no %s annotation" % WINDOW)
        self.t0 = float(win[0]["ts"])
        self.t1 = self.t0 + float(win[0]["dur"])
        self.ops = []                       # (name, start, end)
        for e in events:
            if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS:
                s = max(float(e["ts"]), self.t0)
                t = min(float(e["ts"]) + float(e.get("dur", 0)), self.t1)
                if t > s:
                    self.ops.append((e.get("name", "?"), s, t))
        self.ops.sort(key=lambda o: o[1])

    @property
    def window_s(self):
        return (self.t1 - self.t0) / 1e6

    def busy(self):
        """Union of the device intervals: (busy seconds, idle gaps as
        (start, end) in trace microseconds)."""
        gaps = []
        busy = 0.0
        cur = self.t0
        run_s = run_e = None
        for _, s, e in self.ops:
            if run_e is None or s > run_e:
                if run_e is not None:
                    busy += run_e - run_s
                gaps.append((cur if run_e is None else run_e, s))
                run_s, run_e = s, e
            else:
                run_e = max(run_e, e)
        if run_e is not None:
            busy += run_e - run_s
            gaps.append((run_e, self.t1))
        else:
            gaps.append((self.t0, self.t1))
        return busy / 1e6, [(s, e) for s, e in gaps if e > s]

    def kernel_times(self, pattern):
        """Durations (s) of the kernels whose name has `pattern` as a whole
        word."""
        rx = re.compile(r"(?<![\w])%s(?![\w])" % re.escape(pattern))
        return [(e - s) / 1e6 for n, s, e in self.ops if rx.search(n)]

    def top_ops(self, k=10):
        tot = {}
        for n, s, e in self.ops:
            tot[n] = tot.get(n, 0.0) + (e - s) / 1e6
        return sorted(tot.items(), key=lambda x: -x[1])[:k]


def name_gaps(gaps, spans, host_t0, trace_t0, k=10):
    """The k longest idle stretches, in seconds, each named by the
    innermost host span the host was in ("other" where none): every idle
    gap is cut where that span changes."""
    placed = [(trace_t0 + (a - host_t0) * 1e6,
               trace_t0 + (b - host_t0) * 1e6, n) for n, _, a, b in spans]
    pieces = []
    for s, e in gaps:
        cuts = sorted({s, e} | {t for a, b, _ in placed for t in (a, b)
                                if s < t < e})
        cur = None
        for a, b in zip(cuts, cuts[1:]):
            mid = (a + b) / 2
            inside = [(y - x, n) for x, y, n in placed if x <= mid <= y]
            name = min(inside)[1] if inside else "other"
            if cur is not None and cur[0] == name:
                cur[2] = b
            else:
                if cur is not None:
                    pieces.append(cur)
                cur = [name, a, b]
        pieces.append(cur)
    pieces.sort(key=lambda p: p[1] - p[2])
    return [[n, (b - a) / 1e6] for n, a, b in pieces[:k]]
