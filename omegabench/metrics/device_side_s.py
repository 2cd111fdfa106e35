"""Host seconds a construction spends in the device pipeline
(DeviceOverlapPipeline's configure, upload, index and probe, span
overlap.pipeline, and its survivor stream, span overlap.stream), mean
over the window's constructions.  Beside cpu_scan_s it says how long the
main thread then waits for the hybrid's CPU shard."""

from omegabench.program_trace import span_s


def read(run):
    return span_s(run, ("overlap.pipeline", "overlap.stream"))
