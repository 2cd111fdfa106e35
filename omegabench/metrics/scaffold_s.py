"""Seconds of scaffolding and node resolution an assembly (CLOCK spans
scaffolder + resolveNodes), mean over the window's assemblies."""

from omegabench.program_trace import span_s


def read(run):
    return span_s(run, ("scaffolder", "resolveNodes"))
