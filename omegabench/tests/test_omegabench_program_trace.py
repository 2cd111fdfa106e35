"""The readers of the program's own spans and counters
(omegabench/program_trace.py) on a synthetic recorder and step list: a
record belongs to the step its start lies in, the warm step's records are
not read, a span that straddles two steps counts in the first, and a
recorder that dropped a record inside the window gives no reading."""

import pytest

from metagenomics_tpu_torch.utils import timing
from omegabench.layout import load_module
from omegabench_helpers import BENCH_DIR

NEW = ["device_side_s", "upload_ms", "h2d_mb", "d2h_fetch_ms", "host_syncs",
       "verify_yield_pct", "mate_pairs_read_s", "unnamed_s", "flow_s",
       "simplify_s", "matepair_merge_s", "scaffold_s"]


def reader(name):
    return load_module("%s/metrics/%s.py" % (BENCH_DIR, name)).read


class FakeRun:
    def __init__(self, steps, t0):
        self.steps = steps
        self.window_t0 = t0


def ns(t):
    return int(round(t * 1e9))


class Spans:
    """Builds a recorder from spans (name, start s, end s, the key of the
    parent) and counts; a span's key is its name unless given."""

    def __init__(self, capacity=timing.CAPACITY):
        self.rec = timing.Recorder(capacity)
        self.ids = {}

    def id(self, key):
        """The id of the span `key` names, given at its first mention."""
        return self.ids.setdefault(key, len(self.ids) + 1)

    def span(self, name, a, b, parent=None, key=None):
        self.rec.add(timing.Span(name, self.id(key or name),
                                 self.id(parent) if parent else 0, 1, ns(a),
                                 ns(b), None))

    def count(self, name, t, n):
        self.rec.add(timing.Count(name, 1, ns(t), n))


@pytest.fixture
def use(monkeypatch):
    def install(spans):
        monkeypatch.setattr(timing, "recorder", spans.rec)
    return install


def construct_steps(s):
    """A warm step at [0, 1) and window steps at [1, 2) and [2, 3)."""
    for k, t in enumerate((0.0, 1.0, 2.0)):
        scale = 1 + k            # the warm step reads differently
        b = "build%d" % k
        s.span("overlap.upload", t + 0.10, t + 0.12, "p%d" % k,
               key="up%d" % k)
        s.span("overlap.fetch", t + 0.45, t + 0.45 + 0.01 * scale,
               "s%d" % k, key="f%d" % k)
        s.count("device.h2d_bytes", t + 0.11, 2_000_000 * scale)
        s.count("device.syncs", t + 0.2, 2)
        s.count("overlap.candidates", t + 0.2, 1000 * scale)
        s.count("device.syncs", t + 0.46, 3)
        s.count("overlap.survivors", t + 0.46, 50)
        s.span("overlap.pipeline", t + 0.10, t + 0.30, b, key="p%d" % k)
        s.span("overlap.stream", t + 0.30, t + 0.30 + 0.2 * scale, b,
               key="s%d" % k)
        s.span("storeMatePairInformation", t + 0.6, t + 0.7, b,
               key="m%d" % k)
        s.span("buildOverlapGraphFromHashTable", t + 0.05, t + 0.95, key=b)


def test_device_pipeline_metrics(use):
    s = Spans()
    construct_steps(s)
    use(s)
    run = FakeRun([(1.0, 2.0), (2.0, 3.0)], 1.0)
    # step 1: scale 2, step 2: scale 3
    assert reader("device_side_s")(run) == pytest.approx(
        (0.2 + 0.4 + 0.2 + 0.6) / 2)
    assert reader("upload_ms")(run) == pytest.approx(20.0)
    assert reader("h2d_mb")(run) == pytest.approx((4 + 6) / 2)
    assert reader("d2h_fetch_ms")(run) == pytest.approx((20 + 30) / 2)
    assert reader("host_syncs")(run) == 5
    assert reader("verify_yield_pct")(run) == pytest.approx(
        100 * 50 / 2500)
    assert reader("mate_pairs_read_s")(run) == pytest.approx(0.1)
    # the build's 0.9 s less its children: pipeline, stream, mate pairs
    assert reader("unnamed_s")(run) == pytest.approx(
        ((0.9 - 0.2 - 0.4 - 0.1) + (0.9 - 0.2 - 0.6 - 0.1)) / 2)


def test_a_straddling_span_counts_in_the_step_it_starts(use):
    s = Spans()
    s.span("overlap.fetch", 1.9, 2.3)
    s.span("overlap.fetch", 2.5, 2.6, key="second")
    use(s)
    run = FakeRun([(1.0, 2.0), (2.0, 3.0)], 1.0)
    assert reader("d2h_fetch_ms")(run) == pytest.approx((400 + 100) / 2)
    run = FakeRun([(1.0, 2.0), (2.0, 2.4)], 1.0)
    assert reader("d2h_fetch_ms")(run) == pytest.approx(400 / 2)


def test_nothing_in_the_window_gives_no_reading(use):
    s = Spans()
    s.span("overlap.fetch", 0.5, 0.6)       # the warm step's
    s.count("device.syncs", 0.5, 5)
    use(s)
    run = FakeRun([(1.0, 2.0)], 1.0)
    for name in ("d2h_fetch_ms", "host_syncs", "flow_s", "unnamed_s"):
        with pytest.raises(LookupError):
            reader(name)(run)
    with pytest.raises(LookupError):
        reader("host_syncs")(FakeRun([], 1.0))


def test_late_phase_metrics(use):
    s = Spans()
    for t in (0.0, 10.0):                    # warm step, then the window
        k = str(t)
        s.span("buildOverlapGraphFromHashTable", t + 1, t + 3, key="b" + k)
        # construction's own passes are not simplification
        s.span("removeDeadEndNodes", t + 2.0, t + 2.5, "b" + k,
               key="d" + k)
        s.span("calculateFlow", t + 3.0, t + 3.5, key="cf" + k)
        s.span("removeAllSimpleEdgesWithoutFlow", t + 3.5, t + 3.6,
               key="ra" + k)
        s.span("reduceTrees", t + 4.0, t + 4.5, key="rt" + k)
        # a pass inside another counts once, in it
        s.span("contractCompositePaths", t + 4.1, t + 4.2, "rt" + k,
               key="cc" + k)
        s.span("removeSimilarEdges", t + 4.5, t + 4.7, key="rs" + k)
        s.span("calculateMeanAndSdOfInsertSize", t + 5, t + 5.25,
               key="cm" + k)
        s.span("findSupportByMatepairsAndMerge", t + 5.3, t + 6.0,
               key="fs" + k)
        s.span("scaffolder", t + 6, t + 6.5, key="sc" + k)
        s.span("resolveNodes", t + 7, t + 7.125, key="rn" + k)
    use(s)
    run = FakeRun([(10.0, 19.0)], 10.0)
    assert reader("flow_s")(run) == pytest.approx(0.6)
    assert reader("simplify_s")(run) == pytest.approx(0.7)
    assert reader("matepair_merge_s")(run) == pytest.approx(0.95)
    assert reader("scaffold_s")(run) == pytest.approx(0.625)


def test_unnamed_is_the_outer_spans_self_time(use):
    s = Spans()
    s.span("readDataset", 1.1, 1.2, "main", key="rd")
    s.span("assembler.dataset", 1.1, 1.3, "run", key="ds")
    s.span("overlap.stream", 1.5, 1.6, "b", key="os")
    s.span("buildOverlapGraphFromHashTable", 1.4, 2.0, "run", key="b")
    s.span("calculateFlow", 2.0, 2.5, "run", key="cf")
    s.span("assembler.run", 1.05, 2.9, "main", key="run")
    s.span("main", 1.0, 3.0, key="main")
    use(s)
    run = FakeRun([(1.0, 3.0)], 1.0)
    main_self = 2.0 - 1.85 - 0.1
    run_self = 1.85 - 0.2 - 0.6 - 0.5
    build_self = 0.6 - 0.1
    assert reader("unnamed_s")(run) == pytest.approx(
        main_self + run_self + build_self)


def test_dropped_records_inside_the_window_give_no_reading(use):
    s = Spans(capacity=4)
    for t in (0.1, 0.2, 0.3):                # dropped before the window
        s.span("overlap.fetch", t, t + 0.01, key=str(t))
    for t in (1.1, 1.2, 1.3, 1.4):
        s.span("overlap.fetch", t, t + 0.01, key=str(t))
    use(s)
    run = FakeRun([(1.0, 2.0)], 1.0)
    assert s.rec.dropped == 3
    assert reader("d2h_fetch_ms")(run) == pytest.approx(40.0)
    s.span("overlap.fetch", 1.5, 1.51, key="one more")
    s.count("device.syncs", 1.6, 1)          # drops a window record
    for name in NEW:
        with pytest.raises(LookupError, match="dropped"):
            reader(name)(run)


def test_a_program_without_the_recorder_gives_no_reading(monkeypatch):
    monkeypatch.delattr(timing, "recorder")
    run = FakeRun([(1.0, 2.0)], 1.0)
    for name in NEW:
        with pytest.raises(LookupError):
            reader(name)(run)
