"""Seconds of flow, the late loops and output an assembly: main less
ingest, construction and the I/O between, mean over the window's
assemblies."""

from omegabench.readers import phase_s


def read(run):
    return phase_s(run, "late")
