"""The port's span-and-counter recorder (metagenomics_tpu_torch/utils/
timing.py): nesting and parents across threads, clocks that are never
stopped, the bounded buffer, counters summed inside an interval, the
device pipeline's spans and exact counts on the CPU, the kernel build's
span, and a torch.profiler trace that holds the spans as annotations."""

import json
import os
import sys
import threading
import time

import numpy as np
import pytest
import torch

from metagenomics_tpu_torch.utils import timing

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "golden", "data")


@pytest.fixture
def rec(monkeypatch):
    """A fresh recorder in the process's recorder's place."""
    r = timing.Recorder()
    monkeypatch.setattr(timing, "recorder", r)
    return r


def _spans(r, name=None):
    return [x for x in r.snapshot() if isinstance(x, timing.Span)
            and (name is None or x.name == name)]


def _counts(r, name):
    return sum(x.n for x in r.snapshot()
               if isinstance(x, timing.Count) and x.name == name)


def _quiet(*args, **kwargs):
    pass


def test_nesting_and_parents_across_threads(rec):
    both_open = threading.Barrier(2, timeout=30)

    def work(tag):
        with timing.span("outer." + tag):
            with timing.span("inner." + tag, tag=tag):
                both_open.wait()       # the two threads' spans interleave
            with timing.span("second." + tag):
                pass

    threads = [threading.Thread(target=work, args=(t,)) for t in "ab"]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    spans = {s.name: s for s in _spans(rec)}
    assert len(spans) == 6
    for tag in "ab":
        outer = spans["outer." + tag]
        assert outer.parent == 0
        for child in ("inner.", "second."):
            s = spans[child + tag]
            assert s.parent == outer.id and s.tid == outer.tid
            assert outer.start <= s.start <= s.end <= outer.end
        assert spans["inner." + tag].attrs == {"tag": tag}
    assert spans["outer.a"].tid != spans["outer.b"].tid
    assert len({s.id for s in spans.values()}) == 6


def test_threads_lose_no_record():
    """More threads than cores record into one small buffer with a short
    switch interval: every record is held or counted as dropped, each
    span's parent is its own thread's outer span, and snapshot(since)
    finds every held record of `since` or later though threads append a
    little out of time order."""
    r = timing.Recorder(capacity=512)
    n_threads, n_spans = min(64, 2 * (os.cpu_count() or 4)), 100
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            with r.span("outer") as outer:
                for _ in range(n_spans):
                    with r.span("inner") as s:
                        r.count("c")
                    assert s.parent == outer.id

        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(old)
    assert len(r.records) + r.dropped == n_threads * (2 * n_spans + 1)
    held = r.snapshot()
    times = sorted(x.end if isinstance(x, timing.Span) else x.t
                   for x in held)
    for since in (times[0], times[len(times) // 2], times[-1]):
        assert r.snapshot(since=since) == [
            x for x in held
            if (x.end if isinstance(x, timing.Span) else x.t) >= since]


def test_span_closes_when_its_block_raises(rec):
    with pytest.raises(KeyError):
        with timing.span("outer"):
            with timing.span("inner"):
                raise KeyError("x")
    assert [s.name for s in _spans(rec)] == ["inner", "outer"]
    with timing.span("after") as s:
        pass
    assert s.parent == 0


def _returns_early(log):
    clk = timing.clock_start("early", log=log)   # noqa: F841
    return                                       # before clock_stop


def _raises(log):
    clk = timing.clock_start("raising", log=log)  # noqa: F841
    raise ValueError("in the middle")


def test_unstopped_clock_start(rec):
    """A clock never stopped: at its function's return its span goes
    unrecorded and is counted; spans after it keep their true parent.
    One left open by an exception whose traceback holds its frame goes
    when its enclosing span ends."""
    lines = []
    with timing.phase_clock("outer", log=lines.append):
        _returns_early(lines.append)
        with timing.span("sibling"):
            pass
        try:
            _raises(lines.append)
        except ValueError as exc:
            kept = exc                           # holds the frame
        with timing.span("nested"):
            pass
    spans = {s.name: s for s in _spans(rec)}
    assert set(spans) == {"outer", "sibling", "nested"}
    outer = spans["outer"]
    assert spans["sibling"].parent == outer.id
    assert spans["nested"].parent != outer.id    # under the open clock
    assert _counts(rec, "trace.unclosed") == 2
    del kept
    assert _counts(rec, "trace.unclosed") == 2   # discarded once
    with timing.span("later") as s:
        pass
    assert s.parent == 0
    assert lines[0].endswith("Function: outer()")
    assert [x for x in lines if "finished in" in x] == [
        x for x in lines if x.startswith("Function outer()")]


def test_clock_start_stop_is_one_span(rec):
    lines = []
    clk = timing.clock_start("main", log=lines.append, src="m.py")
    with timing.span("work"):
        time.sleep(0.01)
    timing.clock_stop("main", clk, log=lines.append)
    main, = _spans(rec, "main")
    work, = _spans(rec, "work")
    assert work.parent == main.id
    secs = float(lines[1].split()[4])
    assert secs == pytest.approx((main.end - main.start) / 1e9, rel=1e-5)
    assert secs >= 0.01


def test_bound_and_dropped():
    r = timing.Recorder(capacity=4)
    for t in range(1, 7):
        r.add(timing.Count("c", 1, t * 10, t))
    assert r.dropped == 2 and r.dropped_until == 20
    assert [c.n for c in r.snapshot()] == [3, 4, 5, 6]
    r.add(timing.Span("s", 9, 0, 1, 5, 70, None))
    assert r.dropped == 3 and r.dropped_until == 30
    r.add(timing.Count("c", 1, 80, 7))
    assert r.dropped_until == 40
    assert len(r.snapshot()) == 4


def test_counters_summed_inside_an_interval(rec):
    timing.count("x", 5)
    a = time.perf_counter_ns()
    timing.count("x", 2)
    timing.count("y", 100)
    timing.count("x")
    b = time.perf_counter_ns()
    timing.count("x", 7)
    inside = [c for c in rec.snapshot() if a <= c.t < b]
    assert sum(c.n for c in inside if c.name == "x") == 3
    assert _counts(rec, "x") == 15
    assert {c.tid for c in rec.snapshot()} == {threading.get_ident()}


@pytest.fixture(scope="module")
def datasets():
    from metagenomics_tpu_torch.dataset import Dataset
    return {name: Dataset([], [os.path.join(DATA, name + ".fasta")], 40,
                          log=_quiet)
            for name in ("se_small", "se_mixlen")}


# (data, stream call, blocking read-backs: the probe's two, one a chunk's
# survivor count, then each fetch)
STREAMS = [
    ("se_small", "stream", 5),
    ("se_small", "stream_canon_false", 5),
    ("se_mixlen", "stream_canon_true", 7),
    ("se_mixlen", "stream_canon_raw_mixed", 5),
]


def _stream(pipeline, call):
    if call == "stream":
        counts, r2, meta = pipeline.stream()
        return len(r2)
    if call == "stream_canon_false":
        counts, words, _, _ = pipeline.stream_canon(check_cont=False)
        return len(words)
    if call == "stream_canon_true":
        counts, words, supers, firsthit = pipeline.stream_canon()
        return len(words)
    counts, words = pipeline.stream_canon_raw_mixed()
    return len(words)


@pytest.mark.parametrize("data,call,syncs", STREAMS)
def test_device_pipeline_spans_and_counts(rec, monkeypatch, datasets, data,
                                          call, syncs):
    from metagenomics_tpu_torch.ops.device_overlap import (
        DeviceOverlapPipeline, pack_codes_host)
    monkeypatch.setenv("MGTPU_TORCH_DEVICE", "cpu")
    ds = datasets[data]
    pipeline = DeviceOverlapPipeline(ds, 40)
    records = _stream(pipeline, call)
    spans = {}
    for s in _spans(rec):
        spans.setdefault(s.name, []).append(s)
    assert set(spans) == {"overlap.pipeline", "overlap.upload",
                          "overlap.stream", "overlap.emit", "overlap.fetch"}
    top, = spans["overlap.pipeline"]
    stream, = spans["overlap.stream"]
    upload, = spans["overlap.upload"]
    emit, = spans["overlap.emit"]
    assert top.parent == stream.parent == 0
    assert upload.parent == top.id
    assert emit.parent == stream.id
    assert emit.attrs["chunk"] == 0 and emit.attrs["cap"] >= pipeline.grand
    assert all(f.parent == stream.id for f in spans["overlap.fetch"])
    assert _counts(rec, "device.h2d_bytes") == (
        pack_codes_host(ds.codes_fwd).nbytes
        + ds.lengths.astype(np.int32).nbytes)
    assert _counts(rec, "overlap.candidates") == pipeline.grand > 0
    assert _counts(rec, "overlap.survivors") == records > 0
    assert _counts(rec, "device.syncs") == syncs


@pytest.mark.parametrize("data,call", [(d, c) for d, c, _ in STREAMS])
def test_multichunk_emit_spans_and_syncs(rec, monkeypatch, datasets, data,
                                         call):
    """A plan of several chunks: one overlap.emit span a chunk, numbered in
    order, under the stream's span; read-backs: the probe's two, the row
    statistics' two, one a chunk's survivor count, the counts, and one a
    chunk's survivor words.  The containment stream refuses such a plan
    after planning it, before any emission."""
    from metagenomics_tpu_torch.ops.device_overlap import (
        DeviceOverlapPipeline)
    monkeypatch.setenv("MGTPU_TORCH_DEVICE", "cpu")
    monkeypatch.setattr(DeviceOverlapPipeline, "MAX_CAP", 1 << 12)
    pipeline = DeviceOverlapPipeline(datasets[data], 40)
    if call == "stream_canon_true":
        assert pipeline.stream_canon() is None
        assert not _spans(rec, "overlap.emit")
        assert not _spans(rec, "overlap.fetch")
        assert _counts(rec, "device.syncs") == 4
        return
    records = _stream(pipeline, call)
    stream, = _spans(rec, "overlap.stream")
    emits = _spans(rec, "overlap.emit")
    assert [e.attrs["chunk"] for e in emits] == list(range(len(emits)))
    assert len(emits) > 1 and len({e.attrs["cap"] for e in emits}) == 1
    assert all(e.parent == stream.id for e in emits)
    assert _counts(rec, "overlap.survivors") == records > 0
    assert _counts(rec, "device.syncs") == 2 + 2 + len(emits) + 1 + len(emits)


def test_kernel_build_span(rec, monkeypatch, tmp_path):
    """window_hash.build_library records kernel.build when it compiles,
    and not when it finds the library built (a stand-in nvcc here)."""
    from metagenomics_tpu_torch.ops import window_hash
    nvcc = tmp_path / "nvcc"
    nvcc.write_text('#!/bin/sh\nwhile [ $# -gt 0 ]; do [ "$1" = -o ] && '
                    'touch "$2"; shift; done\n')
    nvcc.chmod(0o755)
    monkeypatch.setattr(window_hash, "_find_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(window_hash, "BUILD_ROOT", str(tmp_path / "build"))
    so = window_hash.build_library()
    assert os.path.exists(so)
    build, = _spans(rec, "kernel.build")
    assert build.attrs == {"library": so}
    assert window_hash.build_library() == so
    assert len(_spans(rec, "kernel.build")) == 1


def test_no_annotation_without_a_profiler(rec):
    with timing.span("quiet") as s:
        assert s.annotation is None


def test_profiler_trace_holds_the_spans(rec, tmp_path):
    """Under a CPU torch.profiler every span is an annotation of the
    trace, nested as recorded, around the ops it ran."""
    from torch.profiler import ProfilerActivity, profile
    lines = []
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with timing.phase_clock("outerPhase", log=lines.append):
            with timing.span("inner.span", k=1):
                torch.arange(64).cumsum(0)
            timing.count("c")
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    ann = {e["name"]: e for e in events if e.get("ph") == "X"
           and e.get("cat") == "user_annotation"}
    assert {"outerPhase", "inner.span"} <= set(ann)
    outer, inner = ann["outerPhase"], ann["inner.span"]
    assert outer["ts"] <= inner["ts"]
    assert inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"]
    ops = [e for e in events if e.get("ph") == "X"
           and e.get("name") == "aten::cumsum"]
    assert ops and all(inner["ts"] <= e["ts"] and e["ts"] + e["dur"]
                       <= inner["ts"] + inner["dur"] for e in ops)
    recorded = {s.name: s for s in _spans(rec)}
    assert recorded["inner.span"].parent == recorded["outerPhase"].id


# ------------------------------------------------ containment counters

def _rc(s):
    return s[::-1].translate(str.maketrans("ACGT", "TGCA"))


@pytest.fixture
def mixed_fasta(tmp_path):
    """Five unique reads: a 150 bp read holding an 80 bp read at 30 on its
    strand and another at 60 on the other strand (each a placement
    strictly inside it, found through its first and its last l-mer: 4
    containment hits), an unrelated 150 bp and an unrelated 80 bp read.
    So 5 unique reads, 2 contained."""
    rng = np.random.default_rng(11)
    bases = lambda n: "".join("ACGT"[i]  # noqa: E731
                              for i in rng.integers(0, 4, n))
    g = bases(200)
    reads = [g[:150], g[30:110], _rc(g[60:140]), bases(150), bases(80)]
    path = tmp_path / "mixed.fasta"
    path.write_text("".join(">r%d\n%s\n" % (i, s)
                            for i, s in enumerate(reads)))
    return str(path)


def _build_with(engine, se, monkeypatch, device="cpu"):
    from metagenomics_tpu_torch.assembler import Assembler
    from metagenomics_tpu_torch.config import AssemblerConfig
    from metagenomics_tpu_torch.dataset import Dataset
    from metagenomics_tpu_torch.graph import OverlapGraph
    monkeypatch.setenv("MGTPU_TORCH_DEVICE", device)
    monkeypatch.setenv("MGTPU_OVERLAP_ENGINE", engine)
    cfg = AssemblerConfig(min_overlap=40, single_end_files=[se])
    ds = Dataset([], [se], 40, log=_quiet)
    asm = Assembler(cfg, log=_quiet)
    asm.dataset = ds
    asm._build(OverlapGraph(ds, cfg, log=_quiet))
    return asm, ds


def _cont_hits_counted(rec):
    return [x for x in rec.snapshot() if isinstance(x, timing.Count)
            and x.name == "overlap.cont_hits"]


@pytest.mark.parametrize("engine", ["native", "device", "host", "hybrid"])
def test_cont_hits_only_from_the_mixed_stream(rec, monkeypatch, mixed_fasta,
                                              engine):
    """Every engine marks the 2 contained reads of the hand-made set; none
    streams the hybrid's mixed words (hybrid falls back to the device
    engine below 1024 reads, which resolves containment on the device), so
    none counts a containment hit."""
    asm, ds = _build_with(engine, mixed_fasta, monkeypatch)
    assert ds.number_of_unique_reads == 5
    assert int((ds.super_read_id[1:] != 0).sum()) == 2
    assert _cont_hits_counted(rec) == []


@pytest.mark.parametrize("engine", ["native", "device", "host", "hybrid"])
def test_construction_counts_unique_and_contained(rec, monkeypatch,
                                                 mixed_fasta, engine):
    """Assembler._build counts the unique and the contained reads once a
    construction, whichever engine built it."""
    _build_with(engine, mixed_fasta, monkeypatch)
    for name, value in (("assembler.unique_reads", 5),
                        ("assembler.contained_reads", 2)):
        counted = [x for x in rec.snapshot()
                   if isinstance(x, timing.Count) and x.name == name]
        assert len(counted) == 1 and _counts(rec, name) == value


def test_cont_hits_are_the_fetched_containment_words(rec, monkeypatch,
                                                     mixed_fasta):
    """stream_canon_raw_mixed counts the containment hits among the words
    it fetched, on the host: no read-back more than before."""
    from metagenomics_tpu_torch.dataset import Dataset
    from metagenomics_tpu_torch.ops.device_overlap import (
        DeviceOverlapPipeline)
    monkeypatch.setenv("MGTPU_TORCH_DEVICE", "cpu")
    ds = Dataset([], [mixed_fasta], 40, log=_quiet)
    pipeline = DeviceOverlapPipeline(ds, 40)
    counts, words = pipeline.stream_canon_raw_mixed()
    fe = (words >> np.uint32(pipeline.off_bits)) & np.uint32(15)
    assert int(((fe & 8) != 0).sum()) == 4
    assert _counts(rec, "overlap.cont_hits") == 4
    assert _counts(rec, "device.syncs") == 5


def test_uniform_construction_counts_no_cont_hits(rec, monkeypatch):
    """Reads of one length under the hybrid engine: none contained, every
    unique read counted, and no containment hit counted."""
    asm, ds = _build_with("hybrid", os.path.join(DATA, "se_small.fasta"),
                          monkeypatch)
    assert asm.engine == "hybrid" and ds.number_of_unique_reads >= 1024
    assert int((ds.super_read_id[1:] != 0).sum()) == 0
    assert _counts(rec, "assembler.unique_reads") == \
        ds.number_of_unique_reads
    assert _counts(rec, "assembler.contained_reads") == 0
    assert not any(isinstance(x, timing.Count) and x.name in (
        "overlap.cont_hits", "trace.unclosed") for x in rec.snapshot())


def test_hybrid_counts_its_device_shards_containment_hits(
        rec, monkeypatch, tmp_path):
    """On a trimmed 2x300 bp sample the hybrid engine counts, once a
    construction, the containment hits of its device shard's stream and
    the contained reads of the whole data set."""
    from metagenomics_tpu_torch.ops.device_overlap import (
        DeviceOverlapPipeline)
    from test_torch_engines import _trimmed_sample
    seen = []
    stream = DeviceOverlapPipeline.stream_canon_raw_mixed

    def kept(self):
        out = stream(self)
        seen.append(int(((out[1] >> np.uint32(self.off_bits + 3)) & 1).sum()))
        return out
    monkeypatch.setattr(DeviceOverlapPipeline, "stream_canon_raw_mixed", kept)
    asm, ds = _build_with("hybrid", _trimmed_sample(tmp_path, 5),
                          monkeypatch)
    assert asm.engine == "hybrid" and len(seen) == 1 and seen[0] > 0
    assert len(_cont_hits_counted(rec)) == 1
    assert _counts(rec, "overlap.cont_hits") == seen[0]
    assert _counts(rec, "assembler.unique_reads") == \
        ds.number_of_unique_reads
    assert _counts(rec, "assembler.contained_reads") == \
        int((ds.super_read_id[1:] != 0).sum()) > 0


@pytest.mark.parametrize("engine", ["native", "device", "host", "hybrid"])
def test_no_setup_pack_count_on_the_cpu(rec, monkeypatch, engine):
    """A construction on the CPU takes the plain row packing: no
    kernel.setup_pack, whichever engine built it."""
    from metagenomics_tpu_torch.ops import setup_pack
    monkeypatch.setattr(setup_pack, "launches", 0)
    asm, _ = _build_with(engine, os.path.join(DATA, "se_small.fasta"),
                         monkeypatch)
    assert asm.engine == engine
    assert _counts(rec, "kernel.setup_pack") == 0
    assert setup_pack.launches == 0


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.card
@pytest.mark.parametrize("engine", ["device", "hybrid"])
def test_setup_pack_counted_once_a_cuda_construction(rec, monkeypatch, card,
                                                     engine):
    """On the card every device and hybrid construction packs its rows
    with one setup_pack launch, counted once as kernel.setup_pack."""
    for built in (1, 2):
        asm, _ = _build_with(engine, os.path.join(DATA, "se_small.fasta"),
                             monkeypatch, device="cuda")
        assert asm.engine == engine
        assert _counts(rec, "kernel.setup_pack") == built
