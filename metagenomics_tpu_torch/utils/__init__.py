"""Observability utilities: per-phase timing, memory, profiler traces.

The reference's CLOCKSTART/CLOCKSTOP macro pair and checkMemoryUsage()
(MetaGenomics/Common.h:52-76) in the same stdout format, plus an optional
torch.profiler trace per phase (env MGTPU_PROFILE_DIR).
"""

from .timing import check_memory_usage, phase_clock, PhaseTimer

__all__ = ["check_memory_usage", "phase_clock", "PhaseTimer"]
