"""Seconds a construction spends in the hybrid engine's CPU shard
(native.scan_canon, on its worker thread), mean over the window's
constructions."""

from omegabench.readers import host_span_s


def read(run):
    return host_span_s(run, "cpu_scan")
