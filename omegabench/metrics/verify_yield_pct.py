"""Share of the device shard's overlap candidates that verification keeps:
100 x survivors fetched (counter overlap.survivors) over candidates
probed (counter overlap.candidates), each the mean a construction over
the window's constructions."""

from omegabench.program_trace import count_sum


def read(run):
    candidates = count_sum(run, "overlap.candidates")
    if candidates <= 0:
        raise LookupError("no overlap candidates in the window")
    return 100.0 * count_sum(run, "overlap.survivors") / candidates
