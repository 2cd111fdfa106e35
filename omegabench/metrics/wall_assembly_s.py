"""The window's time up to the end of its last completed assembly, over
the assemblies completed."""

from omegabench.readers import window_steps


def read(run):
    steps = window_steps(run)
    return (steps[-1][1] - run.window_t0) / len(steps)
