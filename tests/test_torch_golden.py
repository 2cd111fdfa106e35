"""The port's CLI (python -m metagenomics_tpu_torch.cli, device and hybrid
engines on the CPU) against the reference assembler's golden artifacts: all
12 staged artifacts byte-equal and the normalized log equal, for the nine
golden configs and the -s resume; two runs (device and hybrid) prove the
port imports neither jax nor the JAX package.  The host engine's runs are in tests/test_torch_golden_host.py, the sharded engine's in
tests/test_torch_sharded_golden.py."""

import os
import shutil
import subprocess
import sys

import pytest

from logutil import assert_log_equal

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "golden")
CLI = os.path.join(REPO, "metagenomics_tpu_torch", "cli.py")


def _data(*names):
    return [os.path.join(GOLDEN, "data", n) for n in names]


CONFIGS = {
    "se_small": ["-se", "1", *_data("se_small.fasta")],
    "se_mixlen": ["-se", "1", *_data("se_mixlen.fasta")],
    "pe_small": ["-pe", "1", *_data("pe_small.fasta")],
    "pe_meta": ["-pe", "1", *_data("pe_meta.fastq")],
    "pe_real": ["-pe", "1", *_data("pe_real.fastq")],
    "mix_ps": ["-pe", "1", *_data("pe_small.fasta"),
               "-se", "1", *_data("se_mixlen.fasta")],
    "se_heap": ["-se", "1", *_data("se_heap.fasta")],
    "se_hard": ["-se", "1", *_data("se_hard.fasta")],
    "pe_hard": ["-pe", "2", *_data("pe_hard_a.fasta", "pe_hard_b.fasta")],
}

ARTIFACTS = [
    "_sortedReads.fasta", ".unitig", "_flow.input", "_flow.output",
    "graph1.gdl", "contigs1.fasta", "graph2.gdl", "contigs2.fasta",
    "graph3.gdl", "contigs3.fasta", "graph4.gdl", "contigs4.fasta",
]

# the CLI with jax and the JAX package made unimportable: any
# `import jax` or `import metagenomics_tpu[.x]` raises ImportError
_NO_JAX = ("import sys; sys.modules['jax'] = None; "
           "sys.modules['metagenomics_tpu'] = None; "
           "from metagenomics_tpu_torch.cli import main; main(sys.argv[1:])")


def _run(tmp_path, args, no_jax=False, extra=(), engine="device"):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["MGTPU_TORCH_DEVICE"] = "cpu"
    env["MGTPU_OVERLAP_ENGINE"] = engine
    # one torch thread: the suite runs several workers side by side
    env["OMP_NUM_THREADS"] = "1"
    argv = [*args, "-f", "t_", "-l", "40", *extra]
    cmd = ([sys.executable, "-c", _NO_JAX, CLI, *argv] if no_jax
           else [sys.executable, "-m", "metagenomics_tpu_torch.cli", *argv])
    proc = subprocess.run(cmd, cwd=tmp_path, env=env, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    return proc


def _check_artifacts(tmp_path, name, arts=ARTIFACTS):
    for art in arts:
        got = (tmp_path / ("t_" + art)).read_bytes()
        want = open(os.path.join(GOLDEN, "out", name, "g_" + art),
                    "rb").read()
        assert got == want, "artifact mismatch: %s %s" % (name, art)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_golden_config(name, tmp_path):
    proc = _run(tmp_path, CONFIGS[name])
    _check_artifacts(tmp_path, name)
    assert_log_equal(proc.stdout,
                     os.path.join(GOLDEN, "out", name, "log.txt"),
                     "%s/torch-device" % name)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_golden_config_hybrid(name, tmp_path):
    """Every golden set has >= 1024 unique reads, so each run takes the
    hybrid path (tests/test_torch_engines.py proves the path itself)."""
    proc = _run(tmp_path, CONFIGS[name], engine="hybrid")
    _check_artifacts(tmp_path, name)
    assert_log_equal(proc.stdout,
                     os.path.join(GOLDEN, "out", name, "log.txt"),
                     "%s/torch-hybrid" % name)


def test_resume_from_unitig(tmp_path):
    """The -s resume path reproduces the post-unitig artifacts."""
    shutil.copy(os.path.join(GOLDEN, "out", "pe_small", "g_.unitig"),
                tmp_path / "t_.unitig")
    proc = _run(tmp_path, CONFIGS["pe_small"], extra=["-s"])
    _check_artifacts(tmp_path, "pe_small",
                     ["contigs%d.fasta" % i for i in (1, 2, 3, 4)])
    assert_log_equal(proc.stdout,
                     os.path.join(GOLDEN, "out", "pe_small",
                                  "log_resume.txt"), "pe_small/-s")


def _no_jax_run(tmp_path, engine):
    proc = _run(tmp_path, CONFIGS["se_mixlen"], no_jax=True, engine=engine)
    _check_artifacts(tmp_path, "se_mixlen")
    assert_log_equal(proc.stdout,
                     os.path.join(GOLDEN, "out", "se_mixlen", "log.txt"),
                     "se_mixlen/no-jax/%s" % engine)


def test_cli_never_imports_jax(tmp_path):
    """A full run on the mixed-length set (on-device containment,
    _cont_canon) with jax and metagenomics_tpu unimportable."""
    _no_jax_run(tmp_path, "device")


def test_cli_never_imports_jax_hybrid(tmp_path):
    """The same under the hybrid engine: the port's own native library
    scans the CPU shard and replays the device shard."""
    _no_jax_run(tmp_path, "hybrid")


@pytest.mark.parametrize("engine", ["sharded"])
def test_unported_engines_raise(engine, monkeypatch):
    """Every engine of the reference is ported: `sharded` builds the graph
    (its default mesh on the CPU is one shard), and a name the port does
    not know raises and names it."""
    from metagenomics_tpu_torch.assembler import Assembler
    from metagenomics_tpu_torch.config import AssemblerConfig
    from metagenomics_tpu_torch.dataset import Dataset
    from metagenomics_tpu_torch.graph import OverlapGraph
    monkeypatch.setenv("MGTPU_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("MGTPU_OVERLAP_ENGINE", engine)
    se = _data("se_small.fasta")
    cfg = AssemblerConfig(min_overlap=40, single_end_files=se)
    asm = Assembler(cfg, log=lambda *a, **k: None)
    asm.dataset = Dataset([], se, 40, log=asm.log)
    graph = OverlapGraph(asm.dataset, cfg, log=asm.log)
    asm._build_engine(graph)
    assert asm.engine == engine and graph.number_of_edges > 0
    monkeypatch.setenv("MGTPU_OVERLAP_ENGINE", engine + "x")
    with pytest.raises(ValueError, match=engine + "x"):
        asm._build_engine(graph)


def test_cuda_device_needs_a_card(monkeypatch):
    """MGTPU_TORCH_DEVICE=cuda (the default) raises where no card is
    visible; there is no silent CPU fallback."""
    import torch
    from metagenomics_tpu_torch.ops.device_overlap import torch_device
    monkeypatch.delenv("MGTPU_TORCH_DEVICE", raising=False)
    if torch.cuda.is_available():
        assert torch_device().type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            torch_device()
    monkeypatch.setenv("MGTPU_TORCH_DEVICE", "cpu")
    assert torch_device() == torch.device("cpu")


def test_profile_dir_writes_a_trace_per_phase(tmp_path, monkeypatch):
    """MGTPU_PROFILE_DIR captures each phase as a torch.profiler trace
    directory; the CLOCK log lines stay the reference's."""
    import torch
    from metagenomics_tpu_torch.utils.timing import phase_clock
    monkeypatch.setenv("MGTPU_PROFILE_DIR", str(tmp_path))
    lines = []
    with phase_clock("sortReads", log=lines.append, src="x.py"):
        torch.arange(1000).sort()
    assert lines[0] == "Currently in file: x.py Function: sortReads()"
    assert lines[1].startswith("Function sortReads() finished in ")
    assert os.listdir(tmp_path / "sortReads")
