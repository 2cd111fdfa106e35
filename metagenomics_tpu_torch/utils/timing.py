"""Per-phase wall-clock + memory accounting (Common.h:52-76 parity)."""

import contextlib
import os
import time


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


@contextlib.contextmanager
def phase_clock(name, log=print, src=None):
    """CLOCKSTART/CLOCKSTOP equivalent, byte-compatible with the reference
    macros (Common.h:52-53):

        Currently in file: <file> Function: <name>()
        ...phase output...
        Function <name>() finished in <%g> Seconds.
        Memory used: <end> - <start> = <delta> MB.
        <blank line>

    If MGTPU_PROFILE_DIR is set, the phase is additionally captured as a
    torch.profiler trace (one trace directory per outermost phase; a nested
    phase is part of its outer phase's trace) for device-timeline
    inspection in TensorBoard or chrome://tracing."""
    log("Currently in file: %s Function: %s()" % (src or __file__, name))
    mem0 = check_memory_usage()
    t0 = time.time()
    trace_dir = os.environ.get("MGTPU_PROFILE_DIR")
    ctx = contextlib.nullcontext()
    if trace_dir:
        ctx = _profile(os.path.join(trace_dir, name.replace("/", "_")))
    with ctx:
        yield
    dt = time.time() - t0
    mem1 = check_memory_usage()
    # C++ default ostream double formatting == printf %g
    log("Function %s() finished in %g Seconds." % (name, dt))
    log("Memory used: %d - %d = %d MB." % (mem1, mem0, mem1 - mem0))
    log("")


def clock_start(name, log=print, src=None):
    """Manual CLOCKSTART for functions that return early without a
    CLOCKSTOP (the reference does exactly this in
    calculateMeanAndSdOfInsertSize and findSupportByMatepairsAndMerge)."""
    log("Currently in file: %s Function: %s()" % (src or __file__, name))
    return time.time(), check_memory_usage()


def clock_stop(name, state, log=print):
    """Manual CLOCKSTOP matching clock_start."""
    t0, mem0 = state
    mem1 = check_memory_usage()
    log("Function %s() finished in %g Seconds." % (name, time.time() - t0))
    log("Memory used: %d - %d = %d MB." % (mem1, mem0, mem1 - mem0))
    log("")


class PhaseTimer:
    """Collects named phase durations silently (the assembler's
    self.timings for bench consumers); reference-format log emission lives
    in the phase functions themselves via phase_clock."""

    def __init__(self, log=print):
        self.log = log
        self.timings = {}

    @contextlib.contextmanager
    def phase(self, name):
        t0 = time.time()
        yield
        self.timings[name] = time.time() - t0
