"""BENCHMARK.json against the contract's shape, and every part of every
cell found by name; a part added as a file is taken up with no edit."""

import json
import os
import re
import shutil

import pytest

from omegabench import layout
from omegabench_helpers import BENCH_DIR, benchmark

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")


def test_top_level_keys():
    bench = benchmark()
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["omegabench"]
    assert 1 <= bench["run_seconds"] <= 51
    assert isinstance(bench["run_seconds"], int)
    for word in bench["command"]:
        assert TEXT.match(word) and not word.startswith("/")
        assert ".." not in word.split("/")
    assert len(json.dumps(bench)) < 64 * 1024


def test_entries_have_only_the_contract_keys():
    bench = benchmark()
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("omegabench/")
        assert all(NAME.match(k) for k in c["reduced"])
        assert len(c["reduced"]) <= 16
        assert TEXT.match(c["source"]) and TEXT.match(c["why"])
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4)
        assert TEXT.match(w["why"])
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert TEXT.match(m["layer"])
        assert m["moves"] in {e["name"] for e in bench["end_to_end"]}
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert m["better"] in ("lower", "higher")
        assert UNIT.match(m["unit"])
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    names = [x["name"] for part in ("configs", "workloads", "end_to_end",
                                    "per_layer") for x in bench[part]]
    assert all(NAME.match(n) for n in names)
    assert len(set(names)) == len(names)


def test_every_cell_reports_what_the_contract_asks():
    bench = benchmark()
    for w in bench["workloads"]:
        e2e = [m["name"] for m in bench["end_to_end"]
               if layout.covers(m, w["name"])]
        assert "setup_s" in e2e and len(e2e) >= 2
        layer = [m for m in bench["per_layer"]
                 if layout.covers(m, w["name"])]
        assert layer and all(m["moves"] in e2e for m in layer)
        roof = [m for m in layer if m["name"].endswith("_roofline")]
        assert all(m["unit"] == "%" for m in roof)


@pytest.mark.parametrize("cell", [w["name"] for w in benchmark()[
    "workloads"]])
def test_cell_parts_resolve_by_name(cell):
    bench = benchmark()
    c = layout.Cell(cell, bench)
    assert c.config["name"] == next(w["config"] for w in bench["workloads"]
                                    if w["name"] == cell)
    assert hasattr(c.entry, "make")
    for m in c.end_to_end + c.per_layer:
        if m["name"] != "setup_s":
            assert callable(c.reader(m["name"]))
    conf = next(x for x in bench["configs"] if x["name"] == c.config["name"])
    assert c.config["source"] == conf["source"]
    assert c.config["reduced"] == conf["reduced"]


def test_every_metric_file_is_named_in_the_benchmark():
    bench = benchmark()
    named = {m["name"] for m in bench["end_to_end"] + bench["per_layer"]}
    files = {f[:-3] for f in os.listdir(os.path.join(BENCH_DIR, "metrics"))
             if f.endswith(".py")}
    assert files == named - {"setup_s"}


def test_unknown_cell_is_refused():
    with pytest.raises(KeyError):
        layout.Cell("no-such.cell", benchmark())


def test_added_files_are_taken_up_without_edits(tmp_path):
    """A new configuration, traffic mix and per-layer metric, added as
    files beside the others and named in a BENCHMARK.json, are found and
    read by the harness's code as it stands."""
    root = tmp_path / "omegabench"
    shutil.copytree(BENCH_DIR, root,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    before = {p: (root / p).read_bytes() for p in
              ("layout.py", "run.py", "readers.py", "configs/cami-low.json")}
    conf = json.loads((root / "configs" / "cami-low.json").read_text())
    conf["name"] = "cami-low-copy"
    (root / "configs" / "cami-low-copy.json").write_text(json.dumps(conf))
    (root / "traffic" / "construct-small.json").write_text(json.dumps(
        {"entry": "construct", "read_pairs": [1000], "check_rows": 10}))
    (root / "metrics" / "steps_done.py").write_text(
        "def read(run):\n    return len(run.steps)\n")
    bench = benchmark()
    bench["configs"].append({"name": "cami-low-copy", "source": "x",
                             "file": "omegabench/configs/cami-low-copy.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "cami-low-copy.construct-small",
                               "config": "cami-low-copy",
                               "traffic": "construct-small", "chips": 1,
                               "why": "x"})
    bench["per_layer"].append({"name": "steps_done", "unit": "steps",
                               "better": "higher", "source": "host_clock",
                               "layer": "x", "moves": "card_busy_ms",
                               "workloads": ["cami-low-copy.construct-small"]})
    cell = layout.Cell("cami-low-copy.construct-small", bench, root=str(root))
    assert cell.config["name"] == "cami-low-copy"
    assert cell.traffic["read_pairs"] == [1000]
    assert [m["name"] for m in cell.per_layer] == ["steps_done"]

    class FakeRun:
        steps = [(0, 1), (1, 2)]
    assert cell.reader("steps_done")(FakeRun()) == 2
    for p, data in before.items():
        assert (root / p).read_bytes() == data
