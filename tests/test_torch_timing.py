"""The port's phase clock: the same log lines as the JAX package's, and the
MGTPU_PROFILE_DIR hook writes one torch.profiler trace per outermost phase
(torch.profiler sessions do not nest, and the assembler's phases do)."""

import os
import re

import torch

from metagenomics_tpu.utils import timing as ref_timing
from metagenomics_tpu_torch.utils import timing


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
