"""Unique reads of every construction completed in the window, over the
time from the window's start to the end of the last one."""

from omegabench.readers import window_steps


def read(run):
    steps = window_steps(run)
    return run.units * len(steps) / (steps[-1][1] - run.window_t0)
