"""The port's measurement layer on the CPU.

* DeviceOverlapPipeline.stream(download=False) returns None and runs the
  same _emit2 chunks as stream(), with no window-hash dispatch of its own;
* metagenomics_tpu_torch.bench writes bench.py's data sets byte for byte,
  and measure/engines_1m's slicer writes tools/measure_scale.gen_data's
  first reads byte for byte;
* the bench's stage table (the pipeline's construction stage by stage)
  gives the words and counts of stream_canon(False), with bench.py's
  stage names; its pipeline is the constructor's, step for step; its
  least bytes stay below one pass over the port's own tensors;
* run_hybrid records the split that build_hybrid ran;
* the late phase (the CLI under auto, artifacts against an oracle's
  hashes, the log's parts) on golden pe_hard;
* the reference cache is keyed by host, and the bench's helpers leave
  bench_baseline.json and bench_late_baseline.json as they are.
"""

import ast
import hashlib
import importlib.util
import json
import os

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from metagenomics_tpu_torch import bench as tbench
from metagenomics_tpu_torch.config import AssemblerConfig
from metagenomics_tpu_torch.dataset import Dataset
from metagenomics_tpu_torch.measure import engines_1m
from metagenomics_tpu_torch.ops import device_overlap as tdo
from metagenomics_tpu_torch.ops import window_hash

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "golden", "data")
CPU = torch.device("cpu")
# stand-in link and copy rates: the stage table's shares need some, and
# this test reads only its stages, bytes and stream
RATES = {"d2d_copy_GBps": 1.0, "h2d_pageable_GBps": 1.0,
         "d2h_pageable_GBps": 1.0}


def _load(rel, name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, rel))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


jbench = _load("bench.py", "jax_bench")
measure_scale = _load(os.path.join("tools", "measure_scale.py"),
                      "measure_scale")


def _dataset(name):
    return Dataset([], [os.path.join(GOLDEN, name + ".fasta")], 40,
                   log=lambda *a, **k: None)


def _sha(path):
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


@pytest.mark.parametrize("name,max_cap", [
    ("se_small", 1 << 23), ("se_small", 1 << 12), ("se_mixlen", 1 << 12)])
def test_stream_without_download(monkeypatch, name, max_cap):
    ds = _dataset(name)
    dispatched = {"window_hashes": 0, "window_hashes_at": 0}
    for fn_name in dispatched:
        real = getattr(tdo, fn_name)

        def counted(*a, _real=real, _name=fn_name, **k):
            dispatched[_name] += 1
            return _real(*a, **k)
        monkeypatch.setattr(tdo, fn_name, counted)
    emits = []
    real_emit = tdo._emit2

    def emit(*a, **k):
        emits.append((int(a[6]), int(a[7])))        # (h0, nh) of a chunk
        return real_emit(*a, **k)
    monkeypatch.setattr(tdo, "_emit2", emit)
    monkeypatch.setattr(tdo.DeviceOverlapPipeline, "MAX_CAP", max_cap)
    launched = (window_hash.launches, window_hash.at_launches)

    check_cont = ds.longest_read_length != ds.shortest_read_length
    p = tdo.DeviceOverlapPipeline(ds, 40, device=CPU)
    assert dispatched == {"window_hashes": 1, "window_hashes_at": 1}
    assert p.stream(check_cont=check_cont, download=False) is None
    without = list(emits)
    emits.clear()
    counts, r2, meta = p.stream(check_cont=check_cont)
    assert emits == without
    assert len(without) == len(p._plan_chunks()[2])
    assert (len(without) > 1) == (max_cap < 1 << 23)
    assert dispatched == {"window_hashes": 1, "window_hashes_at": 1}
    assert (window_hash.launches, window_hash.at_launches) == launched
    assert counts.sum() == len(r2) == len(meta) > 0


def _gen_in(mod, d, monkeypatch, reduce):
    monkeypatch.setattr(mod, "DATA_DIR", str(d))
    monkeypatch.setattr(mod, "DATA_FILE", str(d / "bench_se.fasta"))
    monkeypatch.setattr(mod, "PE_DATA_A", str(d / "bench_pe_a.fasta"))
    monkeypatch.setattr(mod, "PE_DATA_B", str(d / "bench_pe_b.fasta"))
    if reduce:
        monkeypatch.setattr(mod, "N_READS", 3000)
        monkeypatch.setattr(mod, "GENOMES", [6000, 4000])


@pytest.mark.parametrize("gen,files", [
    ("gen_bench_data", ["bench_se.fasta"]),
    ("gen_pe_bench_data", ["bench_pe_a.fasta", "bench_pe_b.fasta"])])
def test_generators_match_bench_py(tmp_path, monkeypatch, gen, files):
    """The single-end set at 3,000 reads; the paired-end set, which has no
    size constant, at its own size."""
    for mod, d in ((jbench, tmp_path / "jax"), (tbench, tmp_path / "port")):
        _gen_in(mod, d, monkeypatch, reduce=True)
        getattr(mod, gen)()
    for f in files:
        want = (tmp_path / "jax" / f).read_bytes()
        assert len(want) > 10_000
        assert (tmp_path / "port" / f).read_bytes() == want, f


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
    engines_1m.write_first_reads(str(path), n_total=300_000, n=n)
    assert path.read_bytes() == b"".join(scale_lines[:2 * n])


def _bench_py_stage_names():
    """The keys bench.py gives its stage table (phases["..."] = ...)."""
    with open(os.path.join(REPO, "bench.py")) as f:
        tree = ast.parse(f.read())
    return {t.slice.value for node in ast.walk(tree)
            if isinstance(node, ast.Assign) for t in node.targets
            if isinstance(t, ast.Subscript) and isinstance(t.value, ast.Name)
            and t.value.id == "phases"}


@pytest.mark.parametrize("name,max_cap", [
    ("se_small", 1 << 23), ("se_small", 1 << 12), ("se_hard", 1 << 23)])
def test_stage_table_equals_stream_canon(monkeypatch, name, max_cap):
    monkeypatch.setattr(tdo.DeviceOverlapPipeline, "MAX_CAP", max_cap)
    ds = _dataset(name)
    table, counts, words = tbench.stage_table(
        ds, AssemblerConfig(min_overlap=40), CPU, RATES, k=1)
    p = tdo.DeviceOverlapPipeline(ds, 40, device=CPU)
    want_counts, want_words, _, _ = p.stream_canon(check_cont=False)
    assert counts.dtype == want_counts.dtype
    assert words.dtype == want_words.dtype
    np.testing.assert_array_equal(counts, want_counts)
    np.testing.assert_array_equal(words, want_words)
    phases = table["phases"]
    assert set(phases) == _bench_py_stage_names()
    emit = phases["emit_verify"]
    assert emit["chunks"] == len(p._plan_chunks()[2])
    assert (emit["candidates"], emit["survivors"]) == (p.grand, len(words))
    for stage in ("setup_kernel", "probe_join", "emit_verify", "d2h_fetch",
                  "h2d_upload"):
        assert phases[stage]["min_bytes"] > 0
        assert phases[stage]["pct_copy_bw"] > 0


@pytest.mark.parametrize("name", ["se_small", "se_mixlen"])
def test_staged_pipeline_is_the_constructor(name):
    """The stage table times the constructor's own steps: the staged
    pipeline's state equals DeviceOverlapPipeline(...)'s."""
    ds = _dataset(name)
    staged, stages, _ = tbench.staged_pipeline(ds, CPU, k=2)
    built = tdo.DeviceOverlapPipeline(ds, 40, device=CPU)
    assert set(stages) == {"host_pack", "h2d_upload", "setup_kernel",
                           "probe_join"}
    assert all(len(runs) == 2 for _, runs in stages.values())
    assert set(vars(staged)) == set(vars(built))
    for key, want in vars(built).items():
        got = getattr(staged, key)
        if isinstance(want, torch.Tensor):
            assert torch.equal(got, want), key
        elif key != "ds":
            assert got == want, key


@pytest.mark.parametrize("name", ["se_small", "se_hard"])
def test_stage_bytes_stay_below_one_pass_of_the_port(name):
    """The least bytes count each stage's real inputs and outputs at 4
    bytes a value, so they never exceed one read of the port's own input
    tensors and one write of its outputs (int64-held and padded)."""
    ds = _dataset(name)
    table, _, words = tbench.stage_table(
        ds, AssemblerConfig(min_overlap=40), CPU, RATES, k=1)
    p = tdo.DeviceOverlapPipeline(ds, 40, device=CPU)
    outs, kc = p._emit_chunks(False, dedup=True, download=False)

    def nbytes(*ts):
        return sum(t.numel() * t.element_size() for t in ts)
    pf = tdo._upload_words(tdo.pack_codes_host(ds.codes_fwd), CPU)
    port = {
        "setup_kernel": nbytes(pf, p.lengths, p.packed2, p.hf, p.sk, p.sid),
        "probe_join": nbytes(p.hf, p.lengths, p.sk, p.rk, p.rleft, p.rcnt),
        "emit_verify": nbytes(p.rk, p.rleft, p.rcnt, p.sid, p.packed2,
                              p.lengths, kc, *[o for o, _ in outs]),
        "d2h_fetch": 8 * len(words) + nbytes(kc),
    }
    for stage, most in port.items():
        least = table["phases"][stage]["min_bytes"]
        assert 0 < least < most, stage
    assert table["phases"]["d2h_fetch"]["min_bytes"] == \
        4 * len(words) + 4 * p.hf.shape[0]


@pytest.mark.parametrize("frac", ["0.5", None])
def test_run_hybrid_records_the_split_that_ran(monkeypatch, frac):
    from metagenomics_tpu_torch import native
    assert native.get_lib() is not None, "the native library does not build"
    if frac is None:
        monkeypatch.delenv("MGTPU_HYBRID_CPU_FRAC", raising=False)
    else:
        monkeypatch.setenv("MGTPU_HYBRID_CPU_FRAC", frac)
    ds = _dataset("se_small")
    n = ds.number_of_unique_reads
    dt, split = tbench.run_hybrid(ds, AssemblerConfig(min_overlap=40), CPU)
    assert dt > 0 and native.scan_canon.__name__ == "scan_canon"
    assert split["MGTPU_HYBRID_CPU_FRAC"] == frac
    assert split["cpu_rows"] + split["device_rows"] == n
    assert split["cpu_share"] == split["cpu_rows"] / n
    assert split["cpu_threads"] >= 1
    if frac is not None:
        assert split["cpu_rows"] == int(n * float(frac))


def test_reference_cache_is_keyed_by_host(tmp_path, monkeypatch):
    monkeypatch.setattr(tbench, "REF_CACHE", str(tmp_path / "cache.json"))
    model = ["CPU model A"]
    monkeypatch.setattr(tbench, "cpu_model", lambda: model[0])
    timed = []

    def measure():
        timed.append(model[0])
        return {"seconds": len(timed)}
    params = {"seed": 7}
    assert tbench.cached_reference("se", params, measure) == (
        {"seconds": 1}, False)
    assert tbench.cached_reference("se", params, measure) == (
        {"seconds": 1}, True)
    model[0] = "CPU model B"                 # another host: timed anew
    assert tbench.cached_reference("se", params, measure) == (
        {"seconds": 2}, False)
    model[0] = "CPU model A"
    assert tbench.cached_reference("se", params, measure) == (
        {"seconds": 1}, True)
    assert tbench.cached_reference("se", {"seed": 8}, measure) == (
        {"seconds": 3}, False)
    assert timed == ["CPU model A", "CPU model B", "CPU model A"]


def test_late_phase_on_pe_hard(tmp_path, monkeypatch):
    """measure_late with golden pe_hard as its data set and golden's
    hashes as its oracle: the port's CLI under auto (native on the CPU)
    writes every artifact equal, and the log parse finds every part."""
    out = os.path.join(REPO, "golden", "out", "pe_hard")
    oracle = {a: _sha(os.path.join(out, "g_" + a))
              for a in tbench.LATE_ARTIFACTS}
    late_file = tmp_path / "late.json"
    late_file.write_text(json.dumps({"baseline": {"artifact_sha256":
                                                  oracle}}))
    ref = {"artifact_sha256": oracle, "construction_s": 1.0, "late_s": 1.0,
           "counters": {"loops_removed": 7}}
    monkeypatch.setattr(tbench, "LATE_BASELINE_FILE", str(late_file))
    monkeypatch.setattr(tbench, "PE_DATA_A",
                        os.path.join(GOLDEN, "pe_hard_a.fasta"))
    monkeypatch.setattr(tbench, "PE_DATA_B",
                        os.path.join(GOLDEN, "pe_hard_b.fasta"))
    monkeypatch.setattr(tbench, "cached_reference",
                        lambda kind, params, measure: (ref, True))
    rec = tbench.measure_late(CPU)
    assert rec["engine"] == "native"
    assert rec["artifacts_equal_reference"] and not rec["artifacts_differing"]
    assert rec["reference_artifacts_equal_oracle"]
    with open(os.path.join(out, "log.txt")) as f:
        golden = tbench.log_phases(f.read())
    assert golden["unique_reads"] == 6027
    for key in ("construction_s", "late_phases_s", "ingest_s", "total_s"):
        assert rec[key] > 0, key
    assert golden["late"] > 0 and golden["construction"] > 0


def test_bench_helpers_leave_baselines_alone(tmp_path, monkeypatch):
    """The data and reference helpers, the reference binary timed for real
    on a 3,000-read set, touch neither pre-port baseline file."""
    files = [os.path.join(REPO, f) for f in ("bench_baseline.json",
                                             "bench_late_baseline.json")]
    before = [_sha(f) for f in files]
    _gen_in(tbench, tmp_path, monkeypatch, reduce=True)
    monkeypatch.setattr(tbench, "REF_CACHE", str(tmp_path / "cache.json"))
    tbench.gen_bench_data()
    ref, cached = tbench.cached_reference("se", tbench.bench_params(),
                                          tbench.measure_reference)
    assert not cached
    assert ref["binary"] == "metagenomics_ref_O0"
    ds, _ = tbench.load_dataset()
    assert ref["unique_reads"] == ds.number_of_unique_reads
    assert ref["seconds"] > 0
    assert tbench.cached_reference("se", tbench.bench_params(),
                                   tbench.measure_reference) == (ref, True)
    assert [_sha(f) for f in files] == before
