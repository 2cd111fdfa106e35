"""Device milliseconds of _emit2 over every chunk, plus _cont_canon where
it runs, a construction (CUDA events, summed), mean over the window's
constructions."""

from omegabench.readers import device_ms


def read(run):
    return device_ms(run, "emit_verify")
