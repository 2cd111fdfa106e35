"""Seconds a step spends re-reading the paired-end files for mate pairs
(CLOCK spans storeMatePairInformation), mean over the window's steps."""

from omegabench.program_trace import span_s


def read(run):
    return span_s(run, ("storeMatePairInformation",))
