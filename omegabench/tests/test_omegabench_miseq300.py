"""The trimmed 2x300 bp cell (cami-low-miseq300.construct-trimmed): its
configuration against cami-low's, a tiny run of its shape on the CPU under
the hybrid and device engines, its controls, and the readers of its two
counters (contained_pct, cont_hits) on a synthetic program trace."""

import json
import os

import pytest

from omegabench import control, layout
from omegabench_helpers import BENCH_DIR, benchmark, tiny_copy
from test_omegabench_program_trace import FakeRun, Spans, reader, use  # noqa: F401
from test_omegabench_run import run_tiny

CELL = "cami-low-miseq300.construct-trimmed"
BINS = [[300, 300, 40], [250, 299, 25], [200, 249, 15], [150, 199, 10],
        [100, 149, 6], [41, 99, 4]]
COMMUNITY = ["genomes", "circular_elements", "genome_length_bp",
             "circular_length_bp", "length_scale", "min_length_bp",
             "abundance_law", "abundance_mu", "abundance_sigma",
             "community_seed", "repeats", "min_overlap", "dead_end_length",
             "read_error_rate", "guarantees"]
CHECKS = ["rows_differing", "links_unsound", "links_differing",
          "supers_differing"]


def config(name):
    with open(os.path.join(BENCH_DIR, "configs", name + ".json")) as f:
        return json.load(f)


def test_configuration_is_cami_low_with_trimmed_miseq_reads():
    c, low = config("cami-low-miseq300"), config("cami-low")
    assert {k: c[k] for k in COMMUNITY} == {k: low[k] for k in COMMUNITY}
    assert c["read_length"] == 300
    assert c["libraries"] == [{"insert_mean_bp": 550, "insert_sd_frac": 0.1,
                               "orientation": "FR"}]
    assert c["trim"]["length_bins"] == BINS and c["trim"]["source"]
    assert c["reduced"] == ["length_scale", "sample_gbp", "mean_coverage_x"]
    assert c["published"]["mean_coverage_x"] == 94.08
    assert c["published"]["sample_gbp"] == 15
    assert {"trim", "trim_ends", "insert_sd_frac"} <= set(c["assumed"])
    bench = benchmark()
    entry, = [x for x in bench["configs"] if x["name"] == c["name"]]
    assert entry["source"] == c["source"] and len(c["source"]) <= 200
    assert entry["reduced"] == c["reduced"]
    cell, = [w for w in bench["workloads"] if w["name"] == CELL]
    assert cell["chips"] == 1 and cell["traffic"] == "construct-trimmed"
    traffic = layout.Cell(CELL, bench).traffic
    assert traffic["read_pairs"] == c["cut"]["read_pairs"]


def test_mean_kept_length_is_the_stated_anchor():
    """The bins' mean kept length lies between the spec's Q30 share of
    300 bp (70%) and 85%."""
    mean = (sum((lo + hi) / 2 * w for lo, hi, w in BINS)
            / sum(w for _, _, w in BINS))
    assert mean == pytest.approx(250.02)
    assert 0.70 * 300 < mean < 0.85 * 300


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    return tiny_copy(tmp_path_factory.mktemp("miseq300"))


@pytest.mark.parametrize("engine", ["hybrid", "device"])
@pytest.mark.parametrize("trace", [0, 1])
def test_tiny_run_is_correct(monkeypatch, tiny, engine, trace):
    """The cell's shape at a tiny size, on the CPU: every number 0, super
    reads among them, with contained reads in the sample; traced, the
    hybrid reports both new metrics, the device engine (whose stream
    resolves containment on the device) no containment hits."""
    monkeypatch.setenv("MGTPU_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("MGTPU_OVERLAP_ENGINE", engine)
    result, checks, logs = run_tiny(tiny, CELL, trace)
    assert result["correct"] is True and result["failed"] == 0
    assert list(result["checks"]) == CHECKS
    assert all(c.value == 0 and c.limit == 0 for c in checks)
    assert result["checks"]["supers_differing"]["of"] > 1024
    supers = [m for m in logs if m.startswith("supers:")]
    assert supers and int(supers[0].split()[1]) > 0
    assert any(m.startswith("warm step") and m.endswith(engine)
               for m in logs)
    metrics = result["metrics"]
    if not trace:
        assert set(metrics) == {"setup_s"}
        return
    assert 0 < metrics["contained_pct"]["value"] < 100
    if engine == "hybrid":
        assert metrics["cont_hits"]["value"] > 0
    else:
        assert "cont_hits" not in metrics


def test_controls_are_not_correct(tiny):
    c = layout.Cell(CELL, benchmark(), root=tiny)
    number = {"overlap": "rows_differing",
              "first-container": "supers_differing"}
    for seed in (1, 2 ** 31 + 3):
        controls = control.run_control(c, seed, lambda m: None)
        assert list(controls) == list(number)
        for kind, (checks, correct) in controls.items():
            assert not correct
            assert {x.name: x.value for x in checks}[number[kind]] > 0


def test_readers_of_the_containment_counters(use):  # noqa: F811
    s = Spans()
    for k, t in enumerate((0.0, 1.0, 2.0)):      # the warm step, then two
        s.count("assembler.unique_reads", t + 0.9, 1000)
        s.count("assembler.contained_reads", t + 0.9, 600 + 10 * k)
        s.count("overlap.cont_hits", t + 0.5, 5000 * (k + 1))
    use(s)
    run = FakeRun([(1.0, 2.0), (2.0, 3.0)], 1.0)
    assert reader("contained_pct")(run) == pytest.approx(
        100 * (610 + 620) / 2000)
    assert reader("cont_hits")(run) == pytest.approx((10000 + 15000) / 2)


@pytest.mark.parametrize("name,counts", [
    ("contained_pct", ["overlap.cont_hits"]),
    ("contained_pct", ["assembler.contained_reads"]),
    ("cont_hits", ["assembler.unique_reads", "assembler.contained_reads"])])
def test_readers_raise_where_their_counter_is_missing(use, name,  # noqa: F811
                                                      counts):
    s = Spans()
    for c in counts:
        s.count(c, 1.5, 10)
    use(s)
    with pytest.raises(LookupError):
        reader(name)(FakeRun([(1.0, 2.0)], 1.0))


def test_contained_pct_without_unique_reads_gives_no_reading(use):  # noqa: F811
    s = Spans()
    s.count("assembler.unique_reads", 1.5, 0)
    s.count("assembler.contained_reads", 1.5, 0)
    use(s)
    with pytest.raises(LookupError):
        reader("contained_pct")(FakeRun([(1.0, 2.0)], 1.0))
