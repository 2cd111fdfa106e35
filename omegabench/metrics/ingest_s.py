"""Seconds of ingest an assembly (CLOCKSTOP readDataset + sortReads +
removeDupicateReads), mean over the window's assemblies."""

from omegabench.readers import phase_s


def read(run):
    return phase_s(run, "ingest")
