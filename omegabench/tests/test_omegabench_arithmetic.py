"""Rates, the union of device intervals, idle gaps and roofline shares on
synthetic steps, spans and trace events."""

import pytest

from omegabench import peaks, tracing
from omegabench.layout import load_module
from omegabench_helpers import BENCH_DIR


def reader(name):
    return load_module("%s/metrics/%s.py" % (BENCH_DIR, name)).read


class FakeProbe:
    def __init__(self):
        self.spans = []
        self.device_ms = []
        self.launches = []


class FakeRun:
    def __init__(self, steps, t0=0.0, units=1):
        self.steps = steps
        self.window_t0 = t0
        self.units = units
        self.probe = FakeProbe()
        self.device_trace = None
        self.phases = None


def trace(events, t0=1000.0, dur=1000.0):
    evs = [{"name": tracing.WINDOW, "ph": "X", "ts": t0, "dur": dur,
            "cat": "user_annotation"}]
    for name, cat, ts, d in events:
        evs.append({"name": name, "ph": "X", "cat": cat, "ts": ts, "dur": d})
    return {"traceEvents": evs}


def test_rate_counts_all_window_time():
    run = FakeRun([(10.0, 13.0), (13.5, 16.0)], t0=10.0, units=600)
    assert reader("wall_reads_per_s")(run) == pytest.approx(1200 / 6.0)
    assert reader("wall_assembly_s")(run) == pytest.approx(6.0 / 2)


def test_rate_without_steps_has_no_reading():
    with pytest.raises(LookupError):
        reader("wall_reads_per_s")(FakeRun([]))


def test_busy_union_and_gaps():
    dt = tracing.DeviceTrace(trace([
        ("k1", "kernel", 1100, 100),          # 1100-1200
        ("k2", "kernel", 1150, 100),          # overlaps: 1100-1250
        ("m", "gpu_memcpy", 1500, 50),        # 1500-1550
        ("cpu_op", "cpu_op", 1300, 500),      # not device activity
        ("late", "kernel", 1950, 200),        # clipped at 2000
        ("before", "kernel", 900, 50),        # outside the window
    ]))
    busy, gaps = dt.busy()
    assert busy == pytest.approx((150 + 50 + 50) / 1e6)
    assert gaps == [(1000, 1100), (1250, 1500), (1550, 1950)]
    assert dt.window_s == pytest.approx(1e-3)
    run = FakeRun([(0, 1)])
    run.device_trace = dt
    assert reader("device_idle_pct")(run) == pytest.approx(75.0)
    run.steps = [(0, 1), (1, 2)]
    assert reader("card_busy_ms")(run) == pytest.approx(250e-3 / 2)


def test_card_busy_needs_device_activity():
    run = FakeRun([(0, 1)])
    with pytest.raises(LookupError):
        reader("card_busy_ms")(run)
    run.device_trace = tracing.DeviceTrace(trace([
        ("cpu_op", "cpu_op", 1300, 500)]))
    with pytest.raises(LookupError):
        reader("card_busy_ms")(run)


def test_idle_gaps_named_by_innermost_span():
    spans = [("step", 0, 5.0, 6.0), ("replay", 0, 5.2, 5.65)]
    # host 5.0 s is trace 1000 us; one gap over the step's start, the
    # replay and after the step; one gap inside the step alone
    gaps = [(1000 + 0.1e6, 1000 + 1.5e6), (1000 + 0.01e6, 1000 + 0.05e6)]
    named = tracing.name_gaps(gaps, spans, 5.0, 1000.0)
    assert named == [["other", pytest.approx(0.5)],
                     ["replay", pytest.approx(0.45)],
                     ["step", pytest.approx(0.35)],
                     ["step", pytest.approx(0.1)],
                     ["step", pytest.approx(0.04)]]


def test_roofline_share():
    run = FakeRun([(0, 1), (1, 2)])
    run.device_trace = tracing.DeviceTrace(trace([
        ("window_hash_kernel(unsigned char const*, long*)", "kernel",
         1100, 100),
        ("window_hash_kernel(unsigned char const*, long*)", "kernel",
         1300, 300),
        ("window_hash_at_kernel(unsigned char const*)", "kernel", 1700, 10),
    ]))
    nbytes = int(peaks.HBM_BYTES_PER_S * 100e-6)      # 100 us at the peak
    run.probe.launches = [("window_hash", -1, nbytes),  # warm-up: left out
                          ("window_hash", 0, nbytes),
                          ("window_hash", 1, nbytes),
                          ("window_hash_at", 0, 1)]
    assert reader("window_hash_roofline")(run) == pytest.approx(
        100 * 200 / 400, rel=1e-6)
    assert reader("window_hash_at_roofline")(run) == pytest.approx(
        100 * peaks.least_seconds(1) / 10e-6)


def test_roofline_needs_the_kernel_in_the_trace():
    run = FakeRun([(0, 1)])
    run.device_trace = tracing.DeviceTrace(trace([]))
    run.probe.launches = [("window_hash", 0, 10)]
    with pytest.raises(LookupError):
        reader("window_hash_roofline")(run)


def test_per_step_means():
    run = FakeRun([(0, 1), (1, 2)])
    run.probe.spans = [("cpu_scan", -1, 0.0, 9.0), ("cpu_scan", 0, 0.0, 1.0),
                       ("cpu_scan", 1, 1.0, 4.0), ("replay", 0, 0.0, 0.5)]
    run.probe.device_ms = [("probe_join", 0, 2.0), ("emit_verify", 0, 1.0),
                           ("emit_verify", 0, 3.0), ("emit_verify", 1, 2.0)]
    assert reader("cpu_scan_s")(run) == pytest.approx(2.0)
    assert reader("replay_s")(run) == pytest.approx(0.25)
    assert reader("probe_join_ms")(run) == pytest.approx(1.0)
    assert reader("emit_verify_ms")(run) == pytest.approx(3.0)


def test_phase_means():
    from omegabench.layout import load_module as lm
    assemble = lm("%s/entries/assemble.py" % BENCH_DIR)
    log = "\n".join("Function %s() finished in %g Seconds." % kv for kv in [
        ("readDataset", 1.0), ("readDataset", 0.5), ("sortReads", 0.25),
        ("removeDupicateReads", 0.25), ("insertDataset", 0.5),
        ("printDataset", 0.1), ("buildOverlapGraphFromHashTable", 2.0),
        ("saveGraphToFile", 0.4), ("main", 10.0)])
    p = assemble.log_phases(log)
    assert p["ingest"] == pytest.approx(2.0)
    assert p["construction"] == pytest.approx(2.5)
    assert p["late"] == pytest.approx(10.0 - 2.0 - 2.5 - 0.5)
    run = FakeRun([(0, 1)])
    run.phases = [p, dict(p, late=p["late"] + 2)]
    assert reader("late_s")(run) == pytest.approx(p["late"] + 1)
    assert reader("ingest_s")(run) == pytest.approx(2.0)
    assert reader("construct_s")(run) == pytest.approx(2.5)
