"""Megabytes (1e6 bytes) copied from the host to the card a construction
(counter device.h2d_bytes), mean over the window's constructions."""

from omegabench.program_trace import count_sum


def read(run):
    return count_sum(run, "device.h2d_bytes") / 1e6
