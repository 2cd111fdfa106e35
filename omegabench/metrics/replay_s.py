"""Seconds a construction spends in the native replay
(native.build_graph_stream_canon_words), mean over the window's
constructions."""

from omegabench.readers import host_span_s


def read(run):
    return host_span_s(run, "replay")
