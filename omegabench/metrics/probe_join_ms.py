"""Device milliseconds of ops/device_overlap.py's _probe_join a
construction (CUDA events around each call, summed), mean over the
window's constructions."""

from omegabench.readers import device_ms


def read(run):
    return device_ms(run, "probe_join")
