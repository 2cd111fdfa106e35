"""Observability utilities: the port's span-and-counter recorder, the
reference's phase clock, memory, profiler traces.

`timing.recorder` holds every span and counter increment of the process
in one bounded buffer (spans on time.perf_counter_ns(), with parent ids;
entered into a torch.profiler trace while one records).  The reference's
CLOCKSTART/CLOCKSTOP macro pair and checkMemoryUsage()
(MetaGenomics/Common.h:52-76) print in the same stdout format around spans
named after the reference's functions; `Assembler.timings` is derived
from those spans; MGTPU_PROFILE_DIR adds a torch.profiler trace per
outermost phase, which holds the spans.
"""

from .timing import check_memory_usage, count, phase_clock, span

__all__ = ["check_memory_usage", "count", "phase_clock", "span"]
