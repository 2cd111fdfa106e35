"""Host milliseconds a construction spends reading back survivor words,
per-read counts, supers and first hits from the card (span
overlap.fetch), mean over the window's constructions."""

from omegabench.program_trace import span_s


def read(run):
    return 1e3 * span_s(run, ("overlap.fetch",))
