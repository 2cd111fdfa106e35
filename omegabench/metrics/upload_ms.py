"""Host milliseconds a construction spends packing the reads' codes and
copying them and the read lengths to the card (span overlap.upload), mean
over the window's constructions."""

from omegabench.program_trace import span_s


def read(run):
    return 1e3 * span_s(run, ("overlap.upload",))
