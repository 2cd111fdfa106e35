"""Seconds of flow an assembly (CLOCK spans calculateFlow +
removeAllSimpleEdgesWithoutFlow), mean over the window's assemblies."""

from omegabench.program_trace import span_s


def read(run):
    return span_s(run, ("calculateFlow", "removeAllSimpleEdgesWithoutFlow"))
