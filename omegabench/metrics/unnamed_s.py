"""Seconds a step that no program span names: the self time of the
spans that drive it (main, assembler.run, buildOverlapGraphFromHashTable),
their duration less their child spans', mean over the window's steps.
Construction's share is the native replay, the wait for the hybrid's CPU
shard, the shards' merge and the graph's materialisation."""

from omegabench.program_trace import OUTER_SPANS, self_s


def read(run):
    return self_s(run, OUTER_SPANS)
