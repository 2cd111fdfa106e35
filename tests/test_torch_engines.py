"""The port's hybrid and host engines (torch on the CPU) against the JAX
package's and the native engine, and the port's `auto` rule.

Hybrid: across split fractions and dataset shapes, the .unitig bytes and
the contained-read marks (super_read_id) equal the native engine's and the
JAX hybrid engine's, and every case proves that the hybrid path ran (the
CPU scan returned a shard and the device pipeline probed from row a > 1),
and the split it ran (rows on each side, threads) is the one
MGTPU_HYBRID_CPU_FRAC asks for, 0.9 by default.
Trimmed 2x300 bp reads (omegabench's cami-low-miseq300 bins over a tiny
community): 9-bit packed words and containment at 41-300 bp, the hybrid
against the native engines of both packages and the JAX hybrid, its super
reads against the benchmark's plain reference, mate pairs remapped alike.
Host: the .unitig and sorted-reads bytes equal the JAX host engine's over
the min_overlap sweep of tests/test_engine_lsweep.py.  The sharded engine's
tests are tests/test_torch_sharded*.py and tests/test_torch_distributed.py."""

import json
import os
import random
import tempfile
import time

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "golden", "data")


def _quiet(*a, **k):
    pass


@pytest.fixture
def native_lib():
    """The port's native library, loaded in the test (not at collection);
    its loader builds under a lock, so concurrent first builds all load."""
    from metagenomics_tpu_torch import native
    assert native.get_lib() is not None, "the native library does not build"
    return native


@pytest.fixture
def jax_native_lib():
    """The JAX package's native library.  The reference loader caches a
    failed first build for the life of the process, and concurrent first
    builds can fail (ROADMAP section 3); once another process's build has
    landed a second try loads it."""
    from metagenomics_tpu import native
    for _ in range(3):
        if native.get_lib() is not None:
            return native
        native._tried = False
        time.sleep(2)
    lib = native.get_lib()
    assert lib is not None, "the reference native library does not build"
    return native


@pytest.fixture
def torch_cpu(monkeypatch):
    monkeypatch.setenv("MGTPU_TORCH_DEVICE", "cpu")


def _mkreads(tmp_path, n=6000, glen=60_000, L=100, seed=9):
    """tests/test_hybrid.py's uniform single-end set."""
    rng = np.random.default_rng(seed)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    comp = np.zeros(256, np.uint8)
    for k, v in zip(b"ACGT", b"TGCA"):
        comp[k] = v
    g = bases[rng.integers(0, 4, glen)]
    starts = rng.integers(0, glen - L + 1, n)
    reads = g[starts[:, None] + np.arange(L)[None, :]]
    flip = rng.random(n) < 0.5
    reads = np.where(flip[:, None], comp[reads[:, ::-1]], reads)
    path = tmp_path / "uniform.fasta"
    with open(path, "wb") as f:
        for i in range(n):
            f.write(b">r%d\n%s\n" % (i, reads[i].tobytes()))
    return str(path)


def _graph(pkg, pe, se, min_overlap):
    if pkg == "jax":
        from metagenomics_tpu.config import AssemblerConfig
        from metagenomics_tpu.dataset import Dataset
        from metagenomics_tpu.graph import OverlapGraph
    else:
        from metagenomics_tpu_torch.config import AssemblerConfig
        from metagenomics_tpu_torch.dataset import Dataset
        from metagenomics_tpu_torch.graph import OverlapGraph
    ds = Dataset(list(pe), list(se), min_overlap, log=_quiet)
    cfg = AssemblerConfig(min_overlap=min_overlap, paired_end_files=list(pe),
                          single_end_files=list(se))
    return ds, OverlapGraph(ds, cfg, log=_quiet)


def _saved(ds, graph):
    """(.unitig bytes, sorted-reads bytes, super_read_id)."""
    graph.sort_edges()
    with tempfile.TemporaryDirectory() as td:
        up, sp = os.path.join(td, "u"), os.path.join(td, "s")
        graph.save_graph_to_file(up)
        ds.save_reads(sp)
        return (open(up, "rb").read(), open(sp, "rb").read(),
                tuple(ds.super_read_id.tolist()))


def _mate_pairs(ds):
    return tuple(tuple(getattr(ds, k).tolist())
                 for k in ("mp_rid", "mp_mate", "mp_orient", "mp_dataset"))


def _hybrid(pkg, se, frac, native, monkeypatch, paired=False):
    """Build with build_hybrid; record the CPU shard and, for the port, the
    device pipeline's first probed row to prove the hybrid path ran.  With
    paired, se is read as one paired-end file, and the mate pairs come
    back after the saved artifacts."""
    from metagenomics_tpu_torch.ops import device_overlap as tdo
    seen = {"rows": [], "shards": []}
    scan = native.scan_canon

    def scan_canon(*a, **k):
        out = scan(*a, **k)
        seen["shards"].append(out)
        return out

    class Pipeline(tdo.DeviceOverlapPipeline):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            seen["rows"].append(self.row0)

    with monkeypatch.context() as mp:
        mp.setenv("MGTPU_HYBRID_CPU_FRAC", str(frac))
        mp.setattr(native, "scan_canon", scan_canon)
        mp.setattr(tdo, "DeviceOverlapPipeline", Pipeline)
        files = ([se], []) if paired else ([], [se])
        ds, graph = _graph(pkg, *files, 40)
        assert graph.build_hybrid(), "hybrid refused the data set"
    assert len(seen["shards"]) == 1 and seen["shards"][0] is not None
    if pkg == "torch":
        a = 1 + int(ds.number_of_unique_reads * frac)
        assert seen["rows"] == [a] and a > 1
    return _saved(ds, graph) + ((_mate_pairs(ds),) if paired else ())


def _hybrid_case(se, frac, native, jax_native, monkeypatch, paired=False,
                 jax_full_native=False):
    """The port's hybrid against its native engine and the JAX hybrid
    (with jax_full_native, the JAX native engine too)."""
    monkeypatch.setenv("MGTPU_TORCH_DEVICE", "cpu")
    got = _hybrid("torch", se, frac, native, monkeypatch, paired)
    files = ([se], []) if paired else ([], [se])
    ds, graph = _graph("torch", *files, 40)
    assert graph.build_full_native()
    want = _saved(ds, graph)
    assert got[2] == want[2], "supers differ from the native engine"
    assert got[0] == want[0] and len(got[0]) > 0
    if jax_full_native:
        ds, graph = _graph("jax", *files, 40)
        assert graph.build_full_native()
        assert got[:3] == _saved(ds, graph), "differs from the JAX native"
    assert got == _hybrid("jax", se, frac, jax_native, monkeypatch, paired)
    return got


@pytest.mark.parametrize("frac", [0.25, 0.5, 0.85])
def test_hybrid_unitig_equal(tmp_path, frac, native_lib, jax_native_lib,
                             monkeypatch):
    _hybrid_case(_mkreads(tmp_path), frac, native_lib, jax_native_lib,
                 monkeypatch)


@pytest.mark.parametrize("name,frac", [
    ("se_mixlen.fasta", 0.5), ("se_mixlen.fasta", 0.9),
    ("se_heap.fasta", 0.7)])
def test_hybrid_mixed_lengths(name, frac, native_lib, jax_native_lib,
                              monkeypatch):
    """Containment resolved globally across the shards."""
    _hybrid_case(os.path.join(GOLDEN, name), frac, native_lib,
                 jax_native_lib, monkeypatch)


MISEQ300 = os.path.join(REPO, "omegabench", "configs",
                        "cami-low-miseq300.json")


def _trimmed_sample(tmp_path, seed, pairs=1500):
    """One interleaved paired-end file of the trimmed 2x300 configuration
    (its read length, 550 bp inserts and length bins) over a community cut
    to 4 genomes and 2 circular elements: ~3,000 reads of 41-300 bp, about
    half of them contained."""
    from omegabench import generator
    with open(MISEQ300) as f:
        config = json.load(f)
    config.update(genomes=4, circular_elements=2, length_scale=0.003)
    paths, _ = generator.write_sample(config, {"read_pairs": [pairs]}, seed,
                                      str(tmp_path))
    return paths[0]


TRIMMED = [(7, 0.5, False), (2 ** 31 + 11, 0.9, True), (3, 0.25, True)]


@pytest.mark.parametrize("seed,frac,paired", TRIMMED)
def test_hybrid_trimmed_300bp(tmp_path, seed, frac, paired, native_lib,
                              jax_native_lib, monkeypatch):
    """Reads of 41-300 bp (9 offset bits): the hybrid's .unitig,
    _sortedReads.fasta, super reads and (paired) mate pairs equal the JAX
    hybrid's, and the graph and super reads both native engines'."""
    from metagenomics_tpu_torch.ops.device_overlap import canon_off_bits
    se = _trimmed_sample(tmp_path, seed)
    unitig, sorted_reads, supers = _hybrid_case(
        se, frac, native_lib, jax_native_lib, monkeypatch, paired,
        jax_full_native=True)[:3]
    n = len(supers) - 1
    assert n >= 1024 and canon_off_bits(n, 300, 40) == 9
    assert 0 < sum(s > 0 for s in supers) < n
    assert b"Contained in" in sorted_reads


@pytest.mark.parametrize("seed", [7, 2 ** 31 + 11])
def test_hybrid_trimmed_supers_equal_reference(tmp_path, seed, native_lib,
                                              torch_cpu):
    """The port's hybrid marks the contained reads of a trimmed 2x300
    sample with the super reads omegabench's plain reference finds from
    the sequences alone (the lowest-numbered of the longest containers)."""
    from omegabench.reference import contained, ingest
    se = _trimmed_sample(tmp_path, seed)
    ds, graph = _graph("torch", [se], [], 40)
    assert graph.build_hybrid()
    reads = ingest.load([se], 40)
    assert reads.count == ds.number_of_unique_reads
    want = contained.supers(reads)
    assert (want > 0).sum() > 0
    np.testing.assert_array_equal(ds.super_read_id, want)


@pytest.fixture(scope="module")
def sweep_reads():
    """tests/test_engine_lsweep.py's tiling reads: mixed lengths,
    containments and a near-miss pair that differs at one seed base."""
    rng = random.Random(20240817)
    g = "".join(rng.choice("ACGT") for _ in range(3000))
    reads = []
    for pos in range(0, 2800, 23):
        ln = rng.choice([110, 120, 135, 150])
        frag = g[pos:pos + ln]
        if len(frag) > 105:
            reads.append(frag)
    for pos in range(40, 2000, 310):
        reads.append(g[pos:pos + 90])
    base = g[500:615]
    mut = "A" if base[10] != "A" else "C"
    reads.append(base[:10] + mut + base[11:])
    rng.shuffle(reads)
    return reads


@pytest.mark.parametrize("min_overlap", [40, 64, 65, 66, 100])
def test_host_engine_matches_jax(tmp_path, sweep_reads, min_overlap,
                                 torch_cpu):
    from metagenomics_tpu.index import OverlapIndex as JIndex
    from metagenomics_tpu_torch.index import OverlapIndex as TIndex
    path = tmp_path / "sweep.fasta"
    path.write_text("".join(">r%d\n%s\n" % (i, s)
                            for i, s in enumerate(sweep_reads)))
    out = {}
    for pkg, index in (("jax", JIndex), ("torch", TIndex)):
        ds, graph = _graph(pkg, [], [str(path)], min_overlap)
        graph.build_from_index(index(ds, min_overlap))
        out[pkg] = _saved(ds, graph)
    # at -l 100 no overlap qualifies and the .unitig is empty
    assert out["torch"] == out["jax"] and len(out["torch"][1]) > 0
    assert (len(out["torch"][0]) > 0) == (min_overlap < 100)


@pytest.mark.parametrize("device,n_cards,world,engine", [
    ("cuda", 1, 1, "hybrid"), ("cuda", 2, 1, "sharded"),
    ("cuda", 1, 2, "sharded"), ("cpu", 0, 1, "native"),
    ("cpu", 0, 2, "native")])
def test_auto_rule(device, n_cards, world, engine):
    """metagenomics_tpu/assembler.py:63-71 with the card as the TPU: more
    than one card, visible in one process or as a torch.distributed world
    of several ranks, takes the sharded engine; one card hybrid; the CPU
    native."""
    from metagenomics_tpu_torch.assembler import auto_engine
    assert auto_engine(device, n_cards, world) == engine


def _engine_run(monkeypatch, engine, se, no_native=False):
    """Assembler._build_engine on a data set; returns the engine that
    built the graph and the .unitig bytes."""
    from metagenomics_tpu_torch.config import AssemblerConfig
    from metagenomics_tpu_torch.assembler import Assembler
    monkeypatch.setenv("MGTPU_OVERLAP_ENGINE", engine)
    if no_native:
        monkeypatch.setenv("MGTPU_NO_NATIVE", "1")
    ds, graph = _graph("torch", [], [se], 40)
    asm = Assembler(AssemblerConfig(min_overlap=40, single_end_files=[se]),
                    log=_quiet)
    asm.dataset = ds
    asm._build_engine(graph)
    monkeypatch.delenv("MGTPU_NO_NATIVE", raising=False)
    return asm.engine, _saved(ds, graph)[0]


def test_auto_on_cpu_is_native_then_device(native_lib, torch_cpu,
                                           monkeypatch):
    se = os.path.join(GOLDEN, "se_hard.fasta")
    engine, unitig = _engine_run(monkeypatch, "auto", se)
    assert engine == "native"
    engine, fallback = _engine_run(monkeypatch, "auto", se, no_native=True)
    assert engine == "device" and fallback == unitig


def test_hybrid_falls_back_below_1024_reads(tmp_path, native_lib, torch_cpu,
                                            monkeypatch):
    """build_hybrid refuses fewer than 1024 reads, and the device pipeline
    builds the same graph instead."""
    se = _mkreads(tmp_path, n=900, glen=9_000)
    engine, unitig = _engine_run(monkeypatch, "hybrid", se)
    assert engine == "device"
    assert unitig == _engine_run(monkeypatch, "native", se)[1]
    engine, _ = _engine_run(monkeypatch, "hybrid", _mkreads(tmp_path))
    assert engine == "hybrid"


@pytest.mark.parametrize("frac", [None, "0.5", "0.25"])
def test_hybrid_split_that_ran(frac, native_lib, torch_cpu, monkeypatch):
    """build_hybrid on se_small scans int(n * frac) reads on the CPU (frac
    0.9 unless MGTPU_HYBRID_CPU_FRAC is set) on one thread or more, and
    the device pipeline probes the rest: the two shards hold every unique
    read once."""
    from metagenomics_tpu_torch.ops import device_overlap as tdo
    scan = native_lib.scan_canon
    seen = {"scans": [], "rows": []}

    def spy(lengths, codes_fwd, codes_rev, hash_len, r_lo, r_hi, off_bits,
            n_threads=1, mixed=False):
        seen["scans"].append((r_lo, r_hi, n_threads))
        return scan(lengths, codes_fwd, codes_rev, hash_len, r_lo, r_hi,
                    off_bits, n_threads=n_threads, mixed=mixed)

    class Pipeline(tdo.DeviceOverlapPipeline):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            seen["rows"].append(self.row0)

    with monkeypatch.context() as mp:
        if frac is None:
            mp.delenv("MGTPU_HYBRID_CPU_FRAC", raising=False)
        else:
            mp.setenv("MGTPU_HYBRID_CPU_FRAC", frac)
        mp.setattr(native_lib, "scan_canon", spy)
        mp.setattr(tdo, "DeviceOverlapPipeline", Pipeline)
        ds, graph = _graph("torch", [],
                           [os.path.join(GOLDEN, "se_small.fasta")], 40)
        assert graph.build_hybrid(), "hybrid refused se_small"
    assert native_lib.scan_canon is scan
    assert tdo.DeviceOverlapPipeline is not Pipeline
    (r_lo, r_hi, threads), = seen["scans"]
    row0, = seen["rows"]
    n = ds.number_of_unique_reads
    cpu_rows, device_rows = r_hi - r_lo, n + 1 - row0
    assert r_lo == 1 and row0 == r_hi
    assert cpu_rows + device_rows == n
    assert cpu_rows == int(n * float(frac or 0.9)) and device_rows > 0
    assert threads >= 1
