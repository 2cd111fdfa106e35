"""Seconds of construction an assembly (CLOCKSTOP insertDataset +
buildOverlapGraphFromHashTable), mean over the window's assemblies."""

from omegabench.readers import phase_s


def read(run):
    return phase_s(run, "construction")
