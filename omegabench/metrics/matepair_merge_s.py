"""Seconds of mate-pair merging an assembly (CLOCK spans
calculateMeanAndSdOfInsertSize + findSupportByMatepairsAndMerge), mean
over the window's assemblies."""

from omegabench.program_trace import span_s


def read(run):
    return span_s(run, ("calculateMeanAndSdOfInsertSize",
                        "findSupportByMatepairsAndMerge"))
