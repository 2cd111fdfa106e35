"""Seconds of graph simplification an assembly after construction (CLOCK
spans removeDeadEndNodes, contractCompositePaths, removeSimilarEdges,
reduceTrees, reduceLoops outside buildOverlapGraphFromHashTable), mean
over the window's assemblies."""

from omegabench.program_trace import span_s


def read(run):
    return span_s(run, ("removeDeadEndNodes", "contractCompositePaths",
                        "removeSimilarEdges", "reduceTrees", "reduceLoops"),
                  outside=("buildOverlapGraphFromHashTable",))
