"""The port's real-size tool (metagenomics_tpu_torch/measure/scale.py) on
the CPU at a small size.

* gen_data(n) writes tools/measure_scale.gen_data(n)'s bytes, across the
  2^18-read flip block, and keeps a file whose first line names n;
  write_first_reads(path, n_total, n) writes its first n reads alone;
* card_label is the first card's line of nvidia-smi's name and power
  limit;
* the tool runs each engine's CLI in a child process and prints one JSON
  object: rc 0, a peak RSS, the engine that ran and the artifacts equal
  to native's;
* an engine that fails is recorded with its last stderr line, and the
  tool exits non-zero;
* asked for the card with none present, it raises.
"""

import importlib.util
import io
import json
import os
import subprocess

import pytest
import torch

from metagenomics_tpu_torch.measure import scale

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load(rel, name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, rel))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


measure_scale = _load(os.path.join("tools", "measure_scale.py"),
                      "measure_scale")


def test_artifacts_are_the_jax_tools():
    with open(os.path.join(REPO, "tools", "measure_scale.py")) as f:
        src = f.read()
    for art in scale.ARTS:
        assert '"t_%s"' % art in src, art
    assert len(scale.ARTS) == 7


@pytest.mark.parametrize("n", [1000, 300_000])
def test_gen_data_matches_tools_measure_scale(tmp_path, monkeypatch, n):
    monkeypatch.setattr(measure_scale, "DATA", str(tmp_path / "jax.fasta"))
    monkeypatch.setattr(scale, "DATA", str(tmp_path / "d" / "port.fasta"))
    measure_scale.gen_data(n)
    scale.gen_data(n)
    want = (tmp_path / "jax.fasta").read_bytes()
    assert want.count(b"\n") == 2 * n
    assert (tmp_path / "d" / "port.fasta").read_bytes() == want


def test_gen_data_keeps_a_file_of_its_size(tmp_path, monkeypatch):
    path = tmp_path / "scale_se.fasta"
    monkeypatch.setattr(scale, "DATA", str(path))
    scale.gen_data(1000)
    path.write_bytes(path.read_bytes() + b">extra\nACGT\n")
    scale.gen_data(1000)
    assert path.read_bytes().endswith(b">extra\nACGT\n")
    scale.gen_data(100)                  # >r0_1000 does not name 100 reads
    assert path.read_bytes().count(b"\n") == 200
    assert path.read_bytes().startswith(b">r0_100\n")


@pytest.fixture(scope="module")
def scale_lines(tmp_path_factory):
    """tools/measure_scale.gen_data at 300,000 reads: two flip blocks and
    part of a third."""
    path = tmp_path_factory.mktemp("scale") / "scale_se.fasta"
    old = measure_scale.DATA
    measure_scale.DATA = str(path)
    try:
        measure_scale.gen_data(300_000)
    finally:
        measure_scale.DATA = old
    return path.read_bytes().splitlines(keepends=True)


@pytest.mark.parametrize("n", [1000, 262_144, 270_000])
def test_first_reads_match_gen_data(tmp_path, scale_lines, n):
    path = tmp_path / "first.fasta"
    scale.write_first_reads(str(path), n_total=300_000, n=n)
    assert path.read_bytes() == b"".join(scale_lines[:2 * n])


def test_card_label_is_the_first_cards_line(tmp_path, monkeypatch):
    """A stand-in nvidia-smi that answers only the query card_label
    makes: its first line, stripped; a failing nvidia-smi raises."""
    smi = tmp_path / "nvidia-smi"
    smi.write_text(
        '#!/bin/sh\n'
        '[ "$*" = "--query-gpu=name,power.limit --format=csv,noheader" ] '
        '|| exit 3\n'
        'printf "  NVIDIA H100 80GB HBM3, 700.00 W \\n'
        'NVIDIA H100 80GB HBM3, 650.00 W\\n"\n')
    smi.chmod(0o755)
    monkeypatch.setenv("PATH", str(tmp_path) + os.pathsep
                       + os.environ.get("PATH", ""))
    assert scale.card_label() == "NVIDIA H100 80GB HBM3, 700.00 W"
    smi.write_text("#!/bin/sh\nexit 9\n")
    with pytest.raises(subprocess.CalledProcessError):
        scale.card_label()


# /proc/<pid>/status as a usual Linux host and as the card's host give it
STATUS_HWM = "Name:\tpython\nVmHWM:\t30000 kB\nVmRSS:\t20316 kB\n"
STATUS_NO_HWM = "VmSize:\t28344 kB\nVmRSS:\t20316 kB\nVmData:\t9560 kB\n"


@pytest.mark.parametrize("status,want", [(STATUS_HWM, 30000),
                                         (STATUS_NO_HWM, 20316), (None, 0)])
def test_rss_poll_reads_vmhwm_else_vmrss(monkeypatch, status, want):
    def fake_open(path):
        assert path == "/proc/4242/status"
        if status is None:
            raise FileNotFoundError(path)          # the child has exited
        return io.StringIO(status)
    monkeypatch.setattr(scale, "open", fake_open, raising=False)
    assert scale._rss_kb(4242) == want


def test_rss_poll_of_this_process():
    assert scale._rss_kb(os.getpid()) > 0


def _run(tmp_path, monkeypatch, capsys, argv):
    """scale.main(argv) on the CPU with its data in tmp_path; (the JSON it
    printed, the message it exited with or None)."""
    monkeypatch.setattr(scale, "DATA", str(tmp_path / "scale_se.fasta"))
    monkeypatch.setenv("MGTPU_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    exited = None
    try:
        scale.main(argv)
    except SystemExit as exc:
        exited = str(exc)
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1]), \
        exited


def test_scale_on_the_cpu(tmp_path, monkeypatch, capsys):
    out, exited = _run(tmp_path, monkeypatch, capsys,
                       ["--n-reads", "3000", "--skip-reference",
                        "--engines", "native,device"])
    assert exited is None and out["ok"] and out["n_reads"] == 3000
    assert (out["device"], out["card"], out["cards"]) == ("cpu", None, 0)
    assert list(out["engines"]) == ["native", "device"]
    for engine, rec in out["engines"].items():
        assert rec["rc"] == 0 and rec["engine"] == engine
        assert rec["peak_rss_bytes"] > 0 and rec["wall_s"] > 0
        assert 0 < rec["n_unique_reads"] <= 3000
        assert rec["max_memory_allocated"] is None      # not measured
        assert rec["timings"]["buildOverlapGraphFromHashTable"] > 0
        assert rec["timings"]["total"] < rec["wall_s"]
    assert out["engines"]["device"]["artifacts_differing"] == []
    assert out["reference_O0"] is None
    assert [p for p in os.listdir(tmp_path)] == ["scale_se.fasta"]


def test_a_failing_engine_is_recorded(tmp_path, monkeypatch, capsys):
    """An engine the CLI refuses: its child exits non-zero, the record
    holds its last stderr line, native still runs first, and the tool
    exits non-zero."""
    out, exited = _run(tmp_path, monkeypatch, capsys,
                       ["--n-reads", "1500", "--skip-reference",
                        "--engines", "nosuch"])
    assert "failed or differs" in exited and not out["ok"]
    assert list(out["engines"]) == ["native", "nosuch"]
    assert out["engines"]["native"]["rc"] == 0
    bad = out["engines"]["nosuch"]
    assert bad["rc"] != 0 and "engine" not in bad
    assert bad["error"] == "ValueError: unknown overlap engine 'nosuch'"


def test_asked_for_the_card_without_one_raises(monkeypatch):
    monkeypatch.delenv("MGTPU_TORCH_DEVICE", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        scale.main(["--n-reads", "1000", "--skip-reference"])
