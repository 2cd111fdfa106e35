"""Whole runs of the harness on the CPU at a tiny size (the look for a
card skipped), the result line's shape, the import check, the control
and the faults the check has to catch."""

import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import pytest

from omegabench import control, layout, run
from omegabench_helpers import BENCH_DIR, ROOT, TRIM, benchmark, tiny_copy

CELLS = [w["name"] for w in benchmark()["workloads"]]
KEYS = ["correct", "attempted", "failed", "metrics", "device"]
# the numbers a sample of one length is checked by, in the result's order
ONE_LENGTH = {"cami-low.construct": ["rows_differing", "links_unsound",
                                     "links_differing"],
              "cami-medium.assemble": ["rows_differing", "links_unsound",
                                       "links_differing",
                                       "sorted_reads_differing",
                                       "contigs1_differing",
                                       "contig_kmers_absent"]}


@pytest.fixture
def on_cpu(monkeypatch):
    """The program on the CPU, under the engine `auto` picks on one card
    (on the CPU auto would pick the native engine)."""
    monkeypatch.setenv("MGTPU_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("MGTPU_OVERLAP_ENGINE", "hybrid")


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    return tiny_copy(tmp_path_factory.mktemp("tiny"))


def run_tiny(tiny, cell, trace=0, seed=2 ** 31 + 5, seconds=0.5):
    import torch
    c = layout.Cell(cell, benchmark(), root=tiny)
    quiet = []
    result, checks = run.run_cell(c, seed, seconds, trace,
                                  torch.device("cpu"), time.perf_counter(),
                                  log=quiet.append)
    return result, checks, quiet


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", [0, 1])
def test_tiny_run_is_correct(on_cpu, tiny, cell, trace):
    result, checks, _ = run_tiny(tiny, cell, trace)
    want = KEYS + (["breakdown"] if trace else []) + ["checks"]
    assert list(result) == want
    assert result["correct"] is True
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert all(c.value == 0 and c.limit == 0 for c in checks)
    assert list(result["checks"]) == ONE_LENGTH[cell]
    bench = benchmark()
    names = {m["name"] for m in (bench["per_layer"] if trace
                                 else bench["end_to_end"])
             if layout.covers(m, cell)}
    assert set(result["metrics"]) <= names
    if not trace:
        # the CPU has no device trace: only the card's busy time is missing
        cpu_less = {m["name"] for m in bench["end_to_end"]
                    if m["source"] == "device_trace"}
        assert set(result["metrics"]) == names - cpu_less
    for m in result["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    assert set(result["device"]) >= {"platform", "kind", "count",
                                     "memory_peak_bytes"}
    if trace:
        assert {"busy_s", "window_s"} <= set(result["device"])
        assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    json.dumps(result)


def test_tiny_construct_reports_host_layers(on_cpu, tiny):
    result, _, _ = run_tiny(tiny, "cami-low.construct", trace=1)
    # the CPU has no device trace: the device's readers find nothing
    assert {"cpu_scan_s", "replay_s", "probe_join_ms",
            "emit_verify_ms"} <= set(result["metrics"])


def test_no_forbidden_module_after_a_run(on_cpu, tiny):
    code = ("import sys, time, torch; sys.path.insert(0, %r);"
            "from omegabench import layout, run;"
            "c = layout.Cell('cami-low.construct', layout.benchmark(), "
            "root=%r);"
            "run.run_cell(c, 3, 0.2, 0, torch.device('cpu'), "
            "time.perf_counter(), log=lambda m: None);"
            "print(run.forbidden_modules())" % (ROOT, tiny))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_forbidden_names_compare_whole():
    assert run.forbidden_modules(["metagenomics_tpu_torch.cli", "numpy",
                                  "jaxtyping", "flaxen"]) == []
    assert run.forbidden_modules(["metagenomics_tpu.ops.x", "jax.numpy",
                                  "jaxlib", "flax.linen"]) == [
        "flax", "jax", "jaxlib", "metagenomics_tpu"]


def test_reference_loads_neither_package():
    code = ("import sys; sys.path.insert(0, %r);"
            "import omegabench.reference.ingest, "
            "omegabench.reference.overlaps, omegabench.reference.links, "
            "omegabench.reference.contained, omegabench.reference.reduced;"
            "print(sorted({m.split('.')[0] for m in sys.modules}))" % ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    loaded = set(json.loads(out.stdout.replace("'", '"')))
    assert not loaded & {"jax", "jaxlib", "flax", "metagenomics_tpu",
                         "metagenomics_tpu_torch", "torch"}


def test_main_without_card_prints_no_result():
    out = subprocess.run(
        [sys.executable, "omegabench/run.py", "--workload",
         "cami-low.construct", "--seed", "1", "--seconds", "1", "--trace",
         "0"], capture_output=True, text=True, cwd=ROOT, timeout=300)
    assert out.returncode != 0
    assert out.stdout == ""


def test_benchmark_alone_prints_no_result(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(BENCH_DIR, tmp_path / "omegabench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(
        [sys.executable, "omegabench/run.py", "--workload",
         "cami-low.construct", "--seed", "1", "--seconds", "1", "--trace",
         "0"], capture_output=True, text=True, cwd=tmp_path, timeout=300)
    assert out.returncode != 0
    assert out.stdout == ""


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(tiny, cell):
    """The reference with overlaps one base shorter than the guarantee
    allows, in the program's place, fails the rows check."""
    c = layout.Cell(cell, benchmark(), root=tiny)
    for seed in (1, 2, 3):
        controls = control.run_control(c, seed, lambda m: None)
        assert list(controls) == ["overlap"]
        checks, correct = controls["overlap"]
        assert not correct
        assert checks[0].value > 0


# ------------------------------------------------------------ faults

def fault_unchanged(monkeypatch):
    """A step that returns its state unchanged: construction does
    nothing."""
    from metagenomics_tpu_torch import assembler
    monkeypatch.setattr(assembler.Assembler, "_build",
                        lambda self, graph: None)


def fault_half_left_out(monkeypatch):
    """Half of the batch left out: the CPU shard (90% of the reads, the
    engine's split) scans only its even reads."""
    from metagenomics_tpu_torch import native
    scan = native.scan_canon

    def half(*a, **k):
        counts, words = scan(*a, **k)[:2]
        even = np.arange(len(counts)) % 2 == 0
        keep = np.repeat(even, counts)
        return np.where(even, counts, 0), np.asarray(words)[keep]
    monkeypatch.setattr(native, "scan_canon", half)


def fault_answer_altered(monkeypatch):
    """An answer altered where it is produced: every overlap the device
    shard emits gets its offset's low bit flipped."""
    from metagenomics_tpu_torch.ops import device_overlap as dov
    emit = dov._emit2

    def altered(*a, **k):
        out, kc, n_keep = emit(*a, **k)
        return out ^ 1, kc, n_keep
    monkeypatch.setattr(dov, "_emit2", altered)


def fault_artifact_altered(monkeypatch):
    """An answer altered where it is produced: the sorted-reads artifact
    writes one base wrong."""
    from metagenomics_tpu_torch import dataset
    save = dataset.Dataset.save_reads

    def altered(self, path):
        save(self, path)
        with open(path, "r+b") as f:
            f.seek(40)
            c = f.read(1)
            f.seek(40)
            f.write(b"A" if c != b"A" else b"C")
    monkeypatch.setattr(dataset.Dataset, "save_reads", altered)


def fault_replay_drops_edges(monkeypatch):
    """The replay leaves out edges: every seventh edge of the graph it
    hands back (with its twin) is dropped.  The stream into the replay is
    right, and every link left is sound."""
    from metagenomics_tpu_torch.graph import build
    load = build.BuildMixin._load_native_result

    def dropped(self, res):
        load(self, res)
        edges = [e for row in self.adj for e in row
                 if e.source < e.destination]
        for e in edges[::7]:
            self.remove_edge(e)
    monkeypatch.setattr(build.BuildMixin, "_load_native_result", dropped)


def fault_replay_returns_nothing(monkeypatch):
    """The replay hands back an empty graph: no link is unsound, and no
    read in the graph has a link too many or too few."""
    from metagenomics_tpu_torch.graph import build
    monkeypatch.setattr(build.BuildMixin, "_load_native_result",
                        lambda self, res: None)


def fault_contig_altered(monkeypatch):
    """An answer altered where it is produced: the last stage's contig
    file writes one base wrong."""
    from metagenomics_tpu_torch.graph import core
    print_graph = core.GraphCore.print_graph

    def altered(self, graph_path, contig_path):
        print_graph(self, graph_path, contig_path)
        if not contig_path.endswith("contigs4.fasta"):
            return
        with open(contig_path, "r+b") as f:
            data = f.read()
            at = data.index(b"\n") + 50
            f.seek(at)
            f.write(b"A" if data[at:at + 1] != b"A" else b"C")
    monkeypatch.setattr(core.GraphCore, "print_graph", altered)


FAULTS = [(cell, f) for cell in CELLS for f in
          (fault_unchanged, fault_half_left_out, fault_answer_altered,
           fault_replay_drops_edges, fault_replay_returns_nothing)]
FAULTS += [("cami-medium.assemble", fault_artifact_altered),
           ("cami-medium.assemble", fault_contig_altered)]
# the number each fault has to fail, where one number alone can see it
CAUGHT_BY = {fault_replay_drops_edges: "links_differing",
             fault_replay_returns_nothing: "links_differing",
             fault_contig_altered: "contig_kmers_absent"}


@pytest.mark.parametrize("cell,fault", FAULTS,
                         ids=["%s-%s" % (c, f.__name__) for c, f in FAULTS])
def test_fault_is_not_correct(on_cpu, tiny, monkeypatch, cell, fault):
    fault(monkeypatch)
    result, checks, _ = run_tiny(tiny, cell)
    assert result["correct"] is False
    assert any(c.value > c.limit for c in checks)
    if fault in CAUGHT_BY:
        by = {c.name: c for c in checks}
        assert by[CAUGHT_BY[fault]].value > 0
        assert by["links_unsound"].value == 0


# ------------------------------------------------------------ trimmed reads

@pytest.fixture(scope="module")
def tiny_trimmed(tmp_path_factory):
    return tiny_copy(tmp_path_factory.mktemp("trimmed"), trim=TRIM)


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("engine", ["hybrid", "device"])
def test_tiny_trimmed_run_is_correct(on_cpu, monkeypatch, tiny_trimmed, cell,
                                     engine):
    """Reads of several lengths: the port under the engines the CPU runs
    reads 0 on every number, super reads among them, with contained reads
    in the sample."""
    monkeypatch.setenv("MGTPU_OVERLAP_ENGINE", engine)
    result, checks, logs = run_tiny(tiny_trimmed, cell)
    assert result["correct"] is True and result["failed"] == 0
    names = ONE_LENGTH[cell][:3] + ["supers_differing"] + ONE_LENGTH[cell][3:]
    assert list(result["checks"]) == names
    assert all(c.value == 0 for c in checks)
    supers = [m for m in logs if m.startswith("supers:")]
    assert supers and int(supers[0].split()[1]) > 0


def fault_contained_records_kept(monkeypatch):
    """Contained reads' records left in the stream: every second
    contained read is let through the hybrid's mask as if it were not
    contained."""
    from metagenomics_tpu_torch.graph import build
    resolve = build._resolve_supers

    def leaky(*a, **k):
        sup, first = resolve(*a, **k)
        sup = sup.copy()
        sup[np.flatnonzero(sup)[::2]] = 0
        return sup, first
    monkeypatch.setattr(build, "_resolve_supers", leaky)


def fault_contained_read_in_graph(monkeypatch):
    """A contained read left in the graph: the replay is handed the two
    shards' streams as they were before contained reads were masked out,
    while the stream the check reads and the super reads stay right."""
    from metagenomics_tpu_torch import native
    from metagenomics_tpu_torch.ops import device_overlap as dov
    raw = {}
    scan = native.scan_canon
    stream = dov.DeviceOverlapPipeline.stream_canon_raw_mixed
    replay = native.build_graph_stream_canon_words

    def scan_kept(*a, **k):
        raw["cpu"] = scan(*a, **k)
        return raw["cpu"]

    def stream_kept(self):
        raw["dev"] = stream(self)
        return raw["dev"]

    def unmasked(lengths, counts, words, off_bits, *a, **k):
        counts_c, words_c = raw["cpu"][:2]
        counts_d, words_d = raw["dev"]
        ob = np.uint32(off_bits)
        r1_d = np.repeat(np.arange(len(counts_d)), counts_d)
        r2_d = (words_d >> (ob + np.uint32(4))).astype(np.int64)
        edge = (((words_d >> ob) & np.uint32(4)) != 0) & (r1_d <= r2_d)
        r1 = np.concatenate([np.repeat(np.arange(len(counts_c)), counts_c),
                             r1_d[edge]])
        w = np.concatenate([words_c, words_d[edge]])
        order = np.argsort(r1, kind="stable")
        return replay(lengths, np.bincount(r1, minlength=len(counts)),
                      w[order], off_bits, *a, **k)
    monkeypatch.setattr(native, "scan_canon", scan_kept)
    monkeypatch.setattr(dov.DeviceOverlapPipeline, "stream_canon_raw_mixed",
                        stream_kept)
    monkeypatch.setattr(native, "build_graph_stream_canon_words", unmasked)


def fault_wrong_super(monkeypatch):
    """A wrong super read: each contained read names the read after its
    super read (the mask, which needs only whether, stays right)."""
    from metagenomics_tpu_torch.graph import build
    resolve = build._resolve_supers

    def shifted(*a, **k):
        sup, first = resolve(*a, **k)
        n = len(sup) - 1
        return np.where(sup > 0, sup % n + 1, 0), first
    monkeypatch.setattr(build, "_resolve_supers", shifted)


def fault_noncontained_line(monkeypatch):
    """The sorted-reads artifact writes every contained read as
    Noncontained."""
    from metagenomics_tpu_torch import dataset
    save = dataset.Dataset.save_reads

    def noncontained(self, path):
        sup = self.super_read_id.copy()
        self.super_read_id[:] = 0
        try:
            save(self, path)
        finally:
            self.super_read_id[:] = sup
    monkeypatch.setattr(dataset.Dataset, "save_reads", noncontained)


TRIMMED_FAULTS = [
    (cell, f, number) for cell in CELLS for f, number in (
        (fault_contained_records_kept, "rows_differing"),
        (fault_contained_read_in_graph, "links_differing"),
        (fault_wrong_super, "supers_differing"))]
TRIMMED_FAULTS.append(("cami-medium.assemble", fault_noncontained_line,
                       "sorted_reads_differing"))


@pytest.mark.parametrize("cell,fault,number", TRIMMED_FAULTS, ids=[
    "%s-%s" % (c, f.__name__) for c, f, _ in TRIMMED_FAULTS])
def test_trimmed_fault_moves_its_number(on_cpu, tiny_trimmed, monkeypatch,
                                        cell, fault, number):
    fault(monkeypatch)
    result, checks, _ = run_tiny(tiny_trimmed, cell)
    by = {c.name: c for c in checks}
    assert result["correct"] is False
    assert by[number].value > 0
    assert by["links_unsound"].value == 0


@pytest.mark.parametrize("cell", CELLS)
def test_trimmed_control_is_not_correct(tiny_trimmed, cell):
    """On a sample of several lengths both controls run, and each fails
    the number its broken guarantee moves."""
    c = layout.Cell(cell, benchmark(), root=tiny_trimmed)
    number = {"overlap": "rows_differing",
              "first-container": "supers_differing"}
    for seed in (1, 2, 3):
        controls = control.run_control(c, seed, lambda m: None)
        assert list(controls) == list(number)
        for kind, (checks, correct) in controls.items():
            assert not correct
            assert {x.name: x.value for x in checks}[number[kind]] > 0


# ------------------------------------------------------------ on a card

@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_card_run_prints_a_correct_line(card, cell):
    out = subprocess.run(
        [sys.executable, "omegabench/run.py", "--workload", cell, "--seed",
         "17", "--seconds", "1", "--trace", "0"], capture_output=True,
        text=True, cwd=ROOT, timeout=1200)
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] is True
    assert result["device"]["platform"] == "gpu"
