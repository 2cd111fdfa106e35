"""The port's one recorder of spans and counters, and the reference's
per-phase clock (Common.h:52-76 parity) as a view of it.

Every span and counter increment of the process goes into one bounded
in-memory buffer, `recorder` (always on; nothing is written to a file):

* a span is a named interval on one thread: `with span(name, **attrs):`,
  or `@traced(name)` around a function.  It records its id, the id of the
  span open on the same thread when it opened (its parent, 0 for none),
  the thread id, its start and end in time.perf_counter_ns() and its
  attrs.  It is recorded when it closes, also when the block raises;
* a counter increment, `count(name, n)`, records the thread id and its
  time, so a reader can sum the increments inside any interval.

While a torch.profiler records, each span also enters
torch.profiler.record_function(name): the span then sits in the profiler's
trace on the trace's own clock, around the kernels and copies it launched.

phase_clock, clock_start and clock_stop print the reference's
CLOCKSTART/CLOCKSTOP lines around a span named after the reference
function; the printed seconds are the span's.  With MGTPU_PROFILE_DIR set,
each outermost phase is also captured as a torch.profiler trace (one
trace directory per outermost phase), which holds the phase's spans.
"""

import collections
import contextlib
import functools
import itertools
import os
import sys
import threading
import time

# a closed span; start and end in time.perf_counter_ns()
Span = collections.namedtuple("Span", "name id parent tid start end attrs")
# a counter increment of n at time t (time.perf_counter_ns())
Count = collections.namedtuple("Count", "name tid t n")
_SPAN_FIELDS = len(Span._fields)


def _time(record):
    """A record's latest time: a span's end, a count's time."""
    return record[5] if len(record) == _SPAN_FIELDS else record[2]


# records the buffer holds: a construction of the benchmark's cami-low
# cell records 25, an assembly of its cami-medium cell 126, so a 51 s
# window of either (ten or six steps) fills under 2% of it
CAPACITY = 1 << 16


def check_memory_usage() -> int:
    """Current VmData in MB from /proc/self/status — the same counter the
    reference's checkMemoryUsage() parses (Common.h:56-76).  Returns 0 where
    /proc is unavailable (macOS, sandboxes)."""
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmData:"):
                    return int(line.split()[1]) // 1024
    except OSError:
        pass
    return 0


def _annotation(name):
    """torch.profiler.record_function(name), entered, while a profiler
    records; else None.  Reads the profiler's state without importing
    anything: where torch is not loaded, no profiler records."""
    torch = sys.modules.get("torch")
    if torch is None or not torch._C._autograd._profiler_enabled():
        return None
    rf = torch.autograd.profiler.record_function(name)
    rf.__enter__()
    return rf


class _Span:
    """An open span: a context manager that opens it on entry and closes
    (records) it on exit."""

    __slots__ = ("recorder", "name", "attrs", "id", "parent", "start", "end",
                 "annotation")

    def __init__(self, recorder, name, attrs):
        self.recorder = recorder
        self.name = name
        self.attrs = attrs
        self.end = None

    def __enter__(self):
        self.recorder._push(self)
        return self

    def __exit__(self, *exc):
        self.recorder._pop(self)
        return False

    @property
    def seconds(self):
        return (self.end - self.start) / 1e9


class Recorder:
    """Spans and counter increments in one buffer of `capacity` records,
    oldest first (in the order they were recorded: a span when it closes).
    The buffer holds them as plain tuples; snapshot() gives them as Span
    and Count.  A full buffer drops its oldest record: `dropped` counts
    them, and `dropped_until` is the latest time a dropped record held (a
    span's end, a count's time), so a reader can tell whether its interval
    lost any."""

    def __init__(self, capacity=CAPACITY):
        self.capacity = capacity
        self.records = collections.deque(maxlen=capacity)
        # beside each record, the latest time of it and every record before
        # it: threads append in an order a little off their times, and this
        # lets snapshot() stop at the first record it can skip
        self._latest = collections.deque(maxlen=capacity)
        self._high = 0
        self.dropped = 0
        self.dropped_until = 0
        self._ids = itertools.count(1)
        self._local = threading.local()
        self._lock = threading.Lock()

    def span(self, name, **attrs):
        return _Span(self, name, attrs or None)

    def count(self, name, n=1):
        self.add((name, threading.get_ident(), time.perf_counter_ns(), n))

    def add(self, record):
        """Append a finished record: a span's or a count's fields, in the
        order of Span's or Count's."""
        t = _time(record)
        with self._lock:
            if len(self.records) == self.capacity:
                self.dropped += 1
                self.dropped_until = max(self.dropped_until,
                                         _time(self.records[0]))
            self._high = max(self._high, t)
            self.records.append(record)
            self._latest.append(self._high)

    def snapshot(self, since=0):
        """The records held whose latest time (a span's end, a count's
        time) is `since` or later, as Span and Count, oldest first.  A
        span's ancestors end after it, so they are among them."""
        out = []
        with self._lock:
            for r, latest in zip(reversed(self.records),
                                 reversed(self._latest)):
                if latest < since:
                    break
                if _time(r) >= since:
                    out.append(r)
        out.reverse()
        return [Span(*r) if len(r) == _SPAN_FIELDS else Count(*r)
                for r in out]

    def _stack(self):
        try:
            return self._local.stack
        except AttributeError:
            self._local.stack = []
            return self._local.stack

    def _push(self, s):
        stack = self._stack()
        s.id = next(self._ids)
        s.parent = stack[-1].id if stack else 0
        s.annotation = _annotation(s.name)
        stack.append(s)
        s.start = time.perf_counter_ns()

    def _pop(self, s):
        end = time.perf_counter_ns()
        if s.end is not None:
            return
        stack = self._stack()
        if s in stack:
            # spans opened inside s and never closed (a clock_start whose
            # function raised) go: their time is s's own
            while stack[-1] is not s:
                self._discard(stack.pop(), end)
            stack.pop()
        s.end = end
        if s.annotation is not None:
            s.annotation.__exit__(None, None, None)
        self.add((s.name, s.id, s.parent, threading.get_ident(), s.start, end,
                  s.attrs))

    def _discard(self, s, t):
        s.end = t
        if s.annotation is not None:
            s.annotation.__exit__(None, None, None)
        self.count("trace.unclosed")

    def abandon(self, s):
        """Discard the open span s unrecorded (counted under
        trace.unclosed): its time falls into its parent's."""
        if s.end is not None:
            return
        stack = self._stack()
        if s in stack:
            stack.remove(s)
        self._discard(s, time.perf_counter_ns())


# the process's recorder; the functions below look it up at each call
recorder = Recorder()


def span(name, **attrs):
    """A span of the process's recorder, as a context manager."""
    return recorder.span(name, **attrs)


def count(name, n=1):
    """A counter increment of the process's recorder."""
    recorder.count(name, n)


def traced(name):
    """Decorator: every call of the function is a span `name`."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            with recorder.span(name):
                return fn(*args, **kwargs)
        return wrapper
    return deco


# ------------------------------------------------------ the reference's clock

# set while a phase is being traced: torch.profiler sessions do not nest,
# so a phase inside a traced phase lands in the outer phase's trace
_tracing = False


@contextlib.contextmanager
def _profile(trace_dir):
    """torch.profiler over one phase, written as a TensorBoard trace
    directory (CPU activity, plus CUDA kernels where a card is present)."""
    import torch
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)
    global _tracing
    if _tracing:
        yield
        return
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    _tracing = True
    try:
        with profile(activities=acts,
                     on_trace_ready=tensorboard_trace_handler(trace_dir)):
            yield
    finally:
        _tracing = False


def _log_start(name, log, src):
    log("Currently in file: %s Function: %s()" % (src or __file__, name))


def _log_stop(name, seconds, mem0, log):
    mem1 = check_memory_usage()
    # C++ default ostream double formatting == printf %g
    log("Function %s() finished in %g Seconds." % (name, seconds))
    log("Memory used: %d - %d = %d MB." % (mem1, mem0, mem1 - mem0))
    log("")


@contextlib.contextmanager
def phase_clock(name, log=print, src=None):
    """CLOCKSTART/CLOCKSTOP equivalent, byte-compatible with the reference
    macros (Common.h:52-53), around a span `name`:

        Currently in file: <file> Function: <name>()
        ...phase output...
        Function <name>() finished in <%g> Seconds.
        Memory used: <end> - <start> = <delta> MB.
        <blank line>

    A phase that raises closes its span and prints no CLOCKSTOP lines.
    If MGTPU_PROFILE_DIR is set, the phase is additionally captured as a
    torch.profiler trace (one trace directory per outermost phase; a nested
    phase is part of its outer phase's trace) for device-timeline
    inspection in TensorBoard or chrome://tracing."""
    _log_start(name, log, src)
    mem0 = check_memory_usage()
    trace_dir = os.environ.get("MGTPU_PROFILE_DIR")
    ctx = contextlib.nullcontext()
    if trace_dir:
        ctx = _profile(os.path.join(trace_dir, name.replace("/", "_")))
    with ctx, recorder.span(name) as s:
        yield
    _log_stop(name, s.seconds, mem0, log)


class _Clock:
    """What clock_start returns: the open span and the memory reading.  A
    clock that is never stopped (the reference returns before CLOCKSTOP in
    calculateMeanAndSdOfInsertSize and findSupportByMatepairsAndMerge)
    discards its span when the caller drops it, at that return, so the
    spans opened after it keep their true parent."""

    __slots__ = ("span", "mem0")

    def __init__(self, span, mem0):
        self.span = span
        self.mem0 = mem0

    def __del__(self):
        try:
            self.span.recorder.abandon(self.span)
        except Exception:         # at interpreter exit, modules are gone
            pass


def clock_start(name, log=print, src=None):
    """Manual CLOCKSTART for functions that return early without a
    CLOCKSTOP (the reference does exactly this in
    calculateMeanAndSdOfInsertSize and findSupportByMatepairsAndMerge)."""
    _log_start(name, log, src)
    mem0 = check_memory_usage()
    return _Clock(recorder.span(name).__enter__(), mem0)


def clock_stop(name, state, log=print):
    """Manual CLOCKSTOP matching clock_start."""
    state.span.__exit__(None, None, None)
    _log_stop(name, state.span.seconds, state.mem0, log)
