"""The port's phase clock: the same log lines as the JAX package's around
the recorder's spans, the MGTPU_PROFILE_DIR hook writes one torch.profiler
trace per outermost phase (torch.profiler sessions do not nest, and the
assembler's phases do) holding the phase's spans, and Assembler.timings
comes from the run's spans."""

import contextlib
import io
import json
import os
import re

import pytest
import torch

from metagenomics_tpu.utils import timing as ref_timing
from metagenomics_tpu_torch.utils import timing

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(mod, nested):
    lines = []
    with mod.phase_clock("outer", log=lines.append, src="f.py"):
        torch.arange(8).sum()
        if nested:
            with mod.phase_clock("inner", log=lines.append, src="f.py"):
                torch.arange(8).cumsum(0)
    # the elapsed time and memory readings differ run to run
    return [re.sub(r"-?[0-9][0-9.e+-]*", "#", x) for x in lines]


def test_phase_clock_log_equals_reference(monkeypatch):
    monkeypatch.delenv("MGTPU_PROFILE_DIR", raising=False)
    for nested in (False, True):
        assert _run(timing, nested) == _run(ref_timing, nested)


def test_profile_hook_traces_outermost_phase(monkeypatch, tmp_path):
    monkeypatch.delenv("MGTPU_PROFILE_DIR", raising=False)
    want = _run(ref_timing, True)
    monkeypatch.setenv("MGTPU_PROFILE_DIR", str(tmp_path))
    assert _run(timing, True) == want
    assert sorted(os.listdir(tmp_path)) == ["outer"]
    traces = os.listdir(tmp_path / "outer")
    assert len(traces) == 1 and traces[0].endswith(".pt.trace.json")
    # the hook is free again once the outer phase ends
    _run(timing, False)
    assert len(os.listdir(tmp_path / "outer")) == 2


def _manual(mod):
    lines = []
    clk = mod.clock_start("manual", log=lines.append, src="f.py")
    torch.arange(8).sum()
    mod.clock_stop("manual", clk, log=lines.append)
    return [re.sub(r"-?[0-9][0-9.e+-]*", "#", x) for x in lines]


def _raising(mod):
    lines = []
    try:
        with mod.phase_clock("failing", log=lines.append, src="f.py"):
            raise KeyError("x")
    except KeyError:
        pass
    return lines


def test_clock_lines_equal_reference_and_record_spans(monkeypatch):
    """clock_start/clock_stop and a phase that raises print what the
    reference prints (no CLOCKSTOP for the raise), and each is a span."""
    monkeypatch.delenv("MGTPU_PROFILE_DIR", raising=False)
    rec = timing.Recorder()
    monkeypatch.setattr(timing, "recorder", rec)
    assert _manual(timing) == _manual(ref_timing)
    assert _raising(timing) == _raising(ref_timing)
    assert [s.name for s in rec.snapshot()] == ["manual", "failing"]


def test_profile_trace_holds_the_phase_spans(monkeypatch, tmp_path):
    monkeypatch.setenv("MGTPU_PROFILE_DIR", str(tmp_path))
    _run(timing, True)
    trace, = os.listdir(tmp_path / "outer")
    with open(tmp_path / "outer" / trace) as f:
        events = json.load(f)["traceEvents"]
    names = {e["name"] for e in events if e.get("cat") == "user_annotation"}
    assert {"outer", "inner"} <= names


TIMINGS = {"Dataset", "insertDataset", "buildOverlapGraphFromHashTable",
           "printDataset", "saveGraphToFile", "calculateFlow", "total"}


def test_assembler_timings_are_the_runs_spans(monkeypatch, tmp_path):
    """Assembler.timings keeps its keys; each CLOCK phase among them is
    timed once: its value is the seconds its CLOCKSTOP line printed."""
    from metagenomics_tpu_torch import cli
    monkeypatch.delenv("MGTPU_PROFILE_DIR", raising=False)
    monkeypatch.setenv("MGTPU_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("MGTPU_OVERLAP_ENGINE", "device")
    monkeypatch.chdir(tmp_path)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        asm = cli.main(["cli", "-pe", "1", os.path.join(
            REPO, "golden", "data", "pe_small.fasta"), "-f", "t_", "-l",
            "40"])
    t = asm.timings
    assert set(t) == TIMINGS and list(t)[-1] == "total"
    printed = dict(re.findall(r"Function (\w+)\(\) finished in ([\d.e+-]+) "
                              r"Seconds", out.getvalue()))
    for name in ("insertDataset", "buildOverlapGraphFromHashTable",
                 "saveGraphToFile", "calculateFlow"):
        assert t[name] == pytest.approx(float(printed[name]), rel=1e-5)
    assert sum(v for k, v in t.items() if k != "total") < t["total"]
    assert t["total"] < float(printed["main"])
