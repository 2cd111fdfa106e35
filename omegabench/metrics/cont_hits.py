"""Containment hits the device shard hands back a construction (counter
overlap.cont_hits: fetched words with the containment flag), mean over
the window's constructions."""

from omegabench.program_trace import count_sum


def read(run):
    return count_sum(run, "overlap.cont_hits")
