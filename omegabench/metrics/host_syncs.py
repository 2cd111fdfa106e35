"""Blocking read-backs from the card a construction, each a wait of the
host for the card (counter device.syncs), mean over the window's
constructions."""

from omegabench.program_trace import count_sum


def read(run):
    return count_sum(run, "device.syncs")
