"""Benchmark of the port on one CUDA card: overlap-detection throughput.

    python -m metagenomics_tpu_torch.bench      (repo root; needs a card)

The counterpart of the repo's bench.py, with its data sets, constants and
JSON schema.  Metric: unique reads per second through the overlap-
detection phase (index + probe + verify + graph construction), the span
the reference times as insertDataset + buildOverlapGraphFromHashTable
(HashTable.cpp:50, OverlapGraph.cpp:107).  Engines:

* native_cpu: the port's threaded C++ engine on the host (a warm-up, then
  the best of 9), run before any device work;
* device_cuda: the device pipeline end to end (pipeline, canonical stream,
  native replay) and device-compute-only (stream(download=False));
* hybrid_cpu_cuda: the hybrid engine, the port's `auto` on one card.

The reference binary (golden/metagenomics_ref_O0) is timed on this host
whenever bench_data/reference_cache.json holds no entry for the data
parameters, the binary's sha256 and this host's CPU model.  The late phase
(a repeat-dense paired-end assembly) runs the port's CLI under `auto` and
compares its artifacts with the hashes in bench_late_baseline.json, which
it only reads.  utilization() times every device stage with CUDA events
beside its minimum bytes and the card's measured copy bandwidth.

Progress goes to stderr; stdout gets ONE JSON line.  Nothing is caught: a
failure on the card exits non-zero.  The device functions take an explicit
torch.device, so the tests run them on the CPU; main() runs on cuda only.
"""

import contextlib
import hashlib
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from .ops import device_overlap as dov
from .parallel.dryrun import _env

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA_DIR = os.path.join(REPO, "bench_data")
DATA_FILE = os.path.join(DATA_DIR, "bench_se.fasta")
REF_CACHE = os.path.join(DATA_DIR, "reference_cache.json")
REF_BINARY = os.path.join(REPO, "golden", "metagenomics_ref_O0")
REF_TIMEOUT_S = 3000

# dataset parameters (deterministic), as in bench.py
SEED = 7
GENOMES = [600_000, 400_000]
N_READS = 200_000
READ_LEN = 100
MIN_OVERLAP = 40

PE_DATA_A = os.path.join(DATA_DIR, "bench_pe_a.fasta")
PE_DATA_B = os.path.join(DATA_DIR, "bench_pe_b.fasta")
LATE_BASELINE_FILE = os.path.join(REPO, "bench_late_baseline.json")
LATE_SEED = 1717
LATE_ARTIFACTS = [
    "_sortedReads.fasta", ".unitig", "_flow.input",
    "graph1.gdl", "contigs1.fasta", "graph2.gdl", "contigs2.fasta",
    "graph3.gdl", "contigs3.fasta", "graph4.gdl", "contigs4.fasta",
]

# H100 SXM data sheet: HBM3 bandwidth, bytes/s
HBM_DATASHEET_BYTES_PER_S = 3.35e12
CPU = torch.device("cpu")


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def card_label():
    """`nvidia-smi --query-gpu=name,power.limit` of the first card."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()
    return out[0].strip()


# ---------------------------------------------------------------- data sets

def gen_bench_data():
    """bench.py's single-end set: the same bytes into DATA_FILE."""
    os.makedirs(DATA_DIR, exist_ok=True)
    if os.path.exists(DATA_FILE):
        return
    rng = np.random.default_rng(SEED)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    comp_lut = np.zeros(256, dtype=np.uint8)
    for k, v in zip(b"ACGT", b"TGCA"):
        comp_lut[k] = v
    rid = 0
    tmp = DATA_FILE + ".%d.tmp" % os.getpid()
    with open(tmp, "wb") as f:
        for g_len in GENOMES:
            genome = bases[rng.integers(0, 4, g_len)]
            n = int(N_READS * g_len / sum(GENOMES))
            starts = rng.integers(0, g_len - READ_LEN + 1, n)
            reads = genome[starts[:, None] + np.arange(READ_LEN)[None, :]]
            flip = rng.random(n) < 0.5
            reads = np.where(flip[:, None], comp_lut[reads[:, ::-1]], reads)
            f.write(b"".join(b">r%d\n%s\n" % (rid + i, row.tobytes())
                             for i, row in enumerate(reads)))
            rid += n
    os.replace(tmp, DATA_FILE)


_RC_TABLE = str.maketrans("ACGT", "TGCA")


def _rc(s):
    return s.translate(_RC_TABLE)[::-1]


def gen_pe_bench_data():
    """bench.py's repeat-dense paired-end metagenome (~113k reads), the
    same bytes: six 2-copy 300bp repeats, a 2-copy repeat cycle, three
    SNP-spaced strain bubbles, a mate-spannable 150bp repeat, a
    coverage-separable 600bp repeat at 40x/8x, a 60bp gap only mate pairs
    bridge, and ~300kb of unique filler.  File A: insert 450+-30; file B
    (the gap genome): insert 300+-25."""
    import random
    if os.path.exists(PE_DATA_A) and os.path.exists(PE_DATA_B):
        return
    os.makedirs(DATA_DIR, exist_ok=True)
    rng = random.Random(LATE_SEED)

    def genome(n):
        return "".join(rng.choice("ACGT") for _ in range(n))

    def snp_arm(s, spacing=30):
        out = list(s)
        for p in range(spacing // 2, len(out), spacing):
            out[p] = rng.choice([c for c in "ACGT" if c != out[p]])
        return "".join(out)

    def span_pairs(g, n, ins_mean, ins_sd, out, forbid=None):
        for _ in range(n):
            ins = max(210, int(rng.gauss(ins_mean, ins_sd)))
            if ins >= len(g):
                continue
            pos = rng.randrange(0, len(g) - ins)
            if forbid is not None:
                lo, hi = forbid
                r1_ok = pos + 100 <= lo or pos >= hi
                r2_ok = pos + ins <= lo or pos + ins - 100 >= hi
                if not (r1_ok and r2_ok):
                    continue
            frag = g[pos:pos + ins]
            out.append(frag[:100])
            out.append(_rc(frag[-100:]))

    def tiled_pairs(g, step, ins_mean, out, jitter=20):
        i = 0
        for pos in range(0, len(g) - ins_mean - jitter, step):
            ins = ins_mean - jitter + (i * 17) % (2 * jitter + 1)
            i += 1
            frag = g[pos:pos + ins]
            r1, r2 = frag[:100], _rc(frag[-100:])
            if rng.random() < 0.5:
                out.append(r1)
                out.append(r2)
            else:
                out.append(r2)
                out.append(r1)

    reads_a = []
    for k in range(6):
        R = genome(300)
        seg = (genome(2300 + 131 * k) + R + genome(2100 + 173 * k) + R
               + genome(2200))
        tiled_pairs(seg, 7, 450, reads_a)
    R3 = genome(300)
    seg = genome(2500) + R3 + genome(2000) + R3 + genome(2500)
    tiled_pairs(seg, 7, 450, reads_a)
    for k in range(3):
        W, S, Z = genome(1500), genome(800), genome(1500)
        S2 = snp_arm(S)
        for arm in (S, S2):
            tiled_pairs(W + arm + Z, 14, 450, reads_a)
    M = genome(150)
    for lens in ((2200, 2400), (2300, 2100)):
        tiled_pairs(genome(lens[0]) + M + genome(lens[1]), 8, 450, reads_a)
    R2 = genome(600)
    tiled_pairs(genome(2000) + R2 + genome(2000), 5, 450, reads_a)   # 40x
    tiled_pairs(genome(2100) + R2 + genome(1900), 25, 450, reads_a)  # 8x
    for _ in range(3):
        tiled_pairs(genome(100_000), 7, 450, reads_a)

    reads_b = []
    X, gap, Y = genome(2500), genome(60), genome(2500)
    span_pairs(X + gap + Y, 2200, 300, 25, reads_b,
               forbid=(len(X), len(X) + len(gap)))

    for path, reads in ((PE_DATA_A, reads_a), (PE_DATA_B, reads_b)):
        with open(path, "w") as f:
            for i, r in enumerate(reads):
                f.write(">p%d\n%s\n" % (i, r))


def bench_params():
    return {"seed": SEED, "genomes": GENOMES, "n_reads": N_READS,
            "read_len": READ_LEN, "min_overlap": MIN_OVERLAP}


def late_params():
    return {"seed": LATE_SEED, "v": 2, "min_overlap": MIN_OVERLAP}


# ---------------------------------------------------------------- reference

def _sha256_file(path):
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def cpu_model():
    """This host's CPU model from the first processor in /proc/cpuinfo:
    its model name (a sandboxed host may say "unknown") with its vendor,
    family, model and stepping, and the CPUs this process sees."""
    info = {}
    with open("/proc/cpuinfo") as f:
        for line in f:
            if not line.strip():
                break
            key, _, value = line.partition(":")
            info[key.strip()] = value.strip()
    return "%s (%s family %s model %s stepping %s, %d CPUs)" % (
        info["model name"], info["vendor_id"], info["cpu family"],
        info["model"], info["stepping"], os.cpu_count())


def _run_reference(args, workdir):
    t0 = time.perf_counter()
    proc = subprocess.run([REF_BINARY, *args], cwd=workdir,
                          capture_output=True, text=True,
                          timeout=REF_TIMEOUT_S)
    wall_s = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError("%s exited %d:\n%s" % (
            REF_BINARY, proc.returncode, proc.stderr[-2000:]))
    return proc.stdout, wall_s


def log_phases(stdout):
    """Seconds of an assembly's parts from its log (the port and the
    reference print the same CLOCKSTOP lines): construction (insertDataset
    + buildOverlapGraphFromHashTable), ingest, the I/O between, main, and
    the late phases (the rest of main); and the unique reads.  A function
    that runs more than once counts with the sum of its runs."""
    t = {}
    for name, secs in re.findall(
            r"Function (\w+)\(\) finished in ([\d.e+-]+) Seconds", stdout):
        t[name] = t.get(name, 0.0) + float(secs)
    p = {"construction": t["insertDataset"]
         + t["buildOverlapGraphFromHashTable"],
         "ingest": t["readDataset"] + t["sortReads"]
         + t["removeDupicateReads"],
         "mid_io": t.get("printDataset", 0.0) + t.get("saveGraphToFile", 0.0),
         "main": t["main"],
         "unique_reads": int(re.search(r"Number of unique reads: (\d+)",
                                       stdout).group(1))}
    p["late"] = p["main"] - p["ingest"] - p["construction"] - p["mid_io"]
    return p


def measure_reference():
    """The reference binary on the single-end set: its construction span
    and rate."""
    with tempfile.TemporaryDirectory() as td:
        out, wall_s = _run_reference(
            ["-se", "1", DATA_FILE, "-f", "b_", "-l", str(MIN_OVERLAP)], td)
    p = log_phases(out)
    return {"binary": os.path.basename(REF_BINARY),
            "seconds": p["construction"], "unique_reads": p["unique_reads"],
            "reads_per_s": p["unique_reads"] / p["construction"],
            "wall_s": wall_s}


def measure_reference_late():
    """The reference binary on the late-phase set: phase walls, late-pass
    counters and artifact hashes."""
    with tempfile.TemporaryDirectory() as td:
        out, wall_s = _run_reference(
            ["-pe", "2", PE_DATA_A, PE_DATA_B, "-f", "g_", "-l",
             str(MIN_OVERLAP)], td)
        hashes = {a: _sha256_file(os.path.join(td, "g_" + a))
                  for a in LATE_ARTIFACTS}
    p = log_phases(out)
    counters = {
        "similar_edges": sum(int(m) for m in re.findall(
            r"(\d+) edges to remove", out)),
        "loops_removed": sum(int(m) for m in re.findall(
            r"Loops removed: (\d+)", out)),
        "trees_removed": sum(int(m) for m in re.findall(
            r"(\d+) trees removed", out)),
        "mp_merged": sum(int(m) for m in re.findall(
            r"(\d+) Pairs of Edges merged out", out)),
        "scaffold_joins": len(re.findall(
            r"supported\s+\d+ times\. Average distance", out)),
        "resolve_merged": sum(int(m) for m in re.findall(
            r"(\d+) edges merged", out)),
    }
    return {"binary": os.path.basename(REF_BINARY),
            "unique_reads": p["unique_reads"],
            "construction_s": p["construction"], "late_s": p["late"],
            "wall_s": wall_s, "counters": counters, "artifact_sha256": hashes}


def reference_key(kind, params):
    return {"kind": kind, "params": params,
            "binary": os.path.basename(REF_BINARY),
            "binary_sha256": _sha256_file(REF_BINARY),
            "cpu_model": cpu_model()}


def cached_reference(kind, params, measure):
    """(result, cached): the reference's record for this data, binary and
    host from REF_CACHE, or measure() now and add it there."""
    key = reference_key(kind, params)
    entries = []
    if os.path.exists(REF_CACHE):
        with open(REF_CACHE) as f:
            entries = json.load(f)
    for e in entries:
        if e["key"] == key:
            return e["result"], True
    result = measure()
    entries.append({"key": key, "result": result})
    os.makedirs(os.path.dirname(REF_CACHE), exist_ok=True)
    with open(REF_CACHE, "w") as f:
        json.dump(entries, f, indent=1)
    return result, False


# ---------------------------------------------------------------- timing

def timed(fn, device):
    """(ms, fn()) of one call, ended by a synchronize: CUDA events around
    it on a card, the host clock on the CPU."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        stop.record()
        torch.cuda.synchronize(device)
        return start.elapsed_time(stop), out
    t0 = time.perf_counter()
    out = fn()
    return 1e3 * (time.perf_counter() - t0), out


def best_of(fn, device, k=3):
    """(least ms, last output, every ms) of k timed calls."""
    runs = []
    out = None
    for _ in range(k):
        ms, out = timed(fn, device)
        runs.append(ms)
    return min(runs), out, runs


def wall(fn, device):
    """(seconds, fn()) on the host clock; on a card the clock starts and
    stops after a synchronize."""
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    out = fn()
    if cuda:
        torch.cuda.synchronize(device)
    return time.perf_counter() - t0, out


# ---------------------------------------------------------------- engines

def _fresh_graph(ds, cfg):
    from .graph import OverlapGraph
    u = ds.number_of_unique_reads
    ds.edges_forward = [[] for _ in range(u + 1)]
    ds.loc_forward = [[] for _ in range(u + 1)]
    ds.edges_reverse = [[] for _ in range(u + 1)]
    ds.loc_reverse = [[] for _ in range(u + 1)]
    ds.super_read_id[:] = 0
    return OverlapGraph(ds, cfg, log=lambda *a, **k: None)


def load_dataset(path=None):
    from .config import AssemblerConfig
    from .dataset import Dataset
    ds = Dataset([], [path or DATA_FILE], MIN_OVERLAP,
                 log=lambda *a, **k: None)
    return ds, AssemblerConfig(min_overlap=MIN_OVERLAP)


def measure_native(ds, cfg, runs=9):
    """The port's native engine: one warm-up, then `runs` timed builds;
    returns every time in seconds."""
    def once():
        graph = _fresh_graph(ds, cfg)
        dt, ok = wall(graph.build_full_native, CPU)
        if not ok:
            raise RuntimeError("the native engine is unavailable")
        return dt
    once()
    return [once() for _ in range(runs)]


def run_once(ds, cfg, device):
    """Device engine end to end: pipeline, canonical stream, native
    replay.  Seconds by part."""
    from . import native
    graph = _fresh_graph(ds, cfg)
    t_index, pipeline = wall(
        lambda: dov.DeviceOverlapPipeline(ds, MIN_OVERLAP, device=device),
        device)
    t_stream, canon = wall(lambda: pipeline.stream_canon(check_cont=False),
                           device)
    counts, words, _, _ = canon

    def replay():
        res = native.build_graph_stream_canon_words(
            ds.lengths, counts, words, pipeline.off_bits, MIN_OVERLAP - 1,
            cfg.dead_end_length)
        if res is None:
            raise RuntimeError("the native replay library is unavailable")
        graph._load_native_result(res)
    t_build, _ = wall(replay, CPU)
    return {"total": t_index + t_stream + t_build, "index": t_index,
            "stream": t_stream, "build": t_build,
            "canon_records": len(words)}


def run_device_only(ds, device):
    """Pipeline + stream(download=False): device compute, no download."""
    def go():
        p = dov.DeviceOverlapPipeline(ds, MIN_OVERLAP, device=device)
        if p.stream(check_cont=False, download=False) is not None:
            raise RuntimeError("stream(download=False) returned data")
    return wall(go, device)[0]


@contextlib.contextmanager
def _observed_split(n):
    """Record the split that build_hybrid runs, from its call of
    native.scan_canon: the CPU shard's rows and threads, and the
    MGTPU_HYBRID_CPU_FRAC set (None: the engine's default)."""
    from . import native
    seen = {"MGTPU_HYBRID_CPU_FRAC": os.environ.get("MGTPU_HYBRID_CPU_FRAC")}
    scan = native.scan_canon

    def spy(lengths, codes_fwd, codes_rev, hash_len, r_lo, r_hi, off_bits,
            n_threads=1, mixed=False):
        seen.update(cpu_rows=r_hi - r_lo, device_rows=n + 1 - r_hi,
                    cpu_share=(r_hi - r_lo) / n, cpu_threads=n_threads)
        return scan(lengths, codes_fwd, codes_rev, hash_len, r_lo, r_hi,
                    off_bits, n_threads=n_threads, mixed=mixed)
    native.scan_canon = spy
    try:
        yield seen
    finally:
        native.scan_canon = scan


def run_hybrid(ds, cfg, device):
    """The hybrid engine's construction: (seconds, the split that ran).
    Raises where it falls back (fewer than 1024 reads, reads too long for
    one word)."""
    graph = _fresh_graph(ds, cfg)
    with _env(MGTPU_TORCH_DEVICE=str(device)), \
            _observed_split(ds.number_of_unique_reads) as split:
        dt, ok = wall(graph.build_hybrid, device)
    if not ok:
        raise RuntimeError("the hybrid engine did not apply")
    return dt, split


# ---------------------------------------------------------------- stages

def staged_pipeline(ds, device, k=1):
    """DeviceOverlapPipeline.__init__ step by step, each step the best of
    k calls ended by a synchronize.  Returns (pipeline, stages, pf_host):
    stages maps host_pack, h2d_upload, setup_kernel and probe_join to
    (least ms, every ms)."""
    p = dov.DeviceOverlapPipeline.__new__(dov.DeviceOverlapPipeline)
    p._configure(ds, MIN_OVERLAP, 0, device)
    stages = {}

    def stage(name, fn, dev):
        ms, out, runs = best_of(fn, dev, k)
        stages[name] = (ms, runs)
        return out

    pf_host = stage("host_pack", lambda: dov.pack_codes_host(ds.codes_fwd),
                    CPU)
    pf = stage("h2d_upload", lambda: dov._upload_words(pf_host, device),
               device)
    stage("setup_kernel", lambda: p._build_index(pf), device)
    stage("probe_join", p._probe, device)
    return p, stages, pf_host


def stage_bytes(p, survivors):
    """Least bytes each device stage moves: its inputs read once and its
    outputs written once, at their natural widths, 4 bytes a value
    (2-bit codes packed 16 to a word, uint32 hashes and keys, int32 ids,
    lengths and counts).  Not the port's passes: the port holds words,
    hashes and ids in int64 and its sorts and scans make several passes,
    all of which the time includes and the bytes do not."""
    n1 = p.hf.shape[0]
    n = n1 - 1
    return {
        # _setup_kernel hashes the forward strand and two reverse windows
        # a read (window_hash, window_hash_at).  In: the forward packed
        # words (n1 w) and lengths (n1).  Out: the reverse strand's packed
        # words (n1 w; packed2's forward half is the input), the forward
        # hashes (n1 npos), the 4n index keys and their 4n entry words:
        # 4 (2 n1 w + n1 + n1 npos + 8n)
        "setup_kernel": 4 * (2 * n1 * p.w + n1 + n1 * p.npos + 8 * n),
        # In: the forward hashes, lengths, the 4n index keys.  Out: each
        # hit query's id, bucket start and count, and the candidate total
        # (8): 4 (n1 npos + n1 + 4n) + 12 h_total + 8
        "probe_join": (4 * (n1 * p.npos + n1 + 4 * n) + 12 * p.h_total
                       + 8),
        # In: the hits' (id, start, count), the 4n entry words, both
        # strands' packed words, lengths.  Out: the survivors' words and
        # the per-read counts:
        # 12 h_total + 4 (4n + 2 n1 w + n1) + 4 survivors + 4 n1
        "emit_verify": (12 * p.h_total + 4 * (4 * n + 2 * n1 * p.w + n1)
                        + 4 * survivors + 4 * n1),
        # the survivors' words and the per-read counts across the link
        "d2h_fetch": 4 * survivors + 4 * n1,
    }


def stage_table(ds, cfg, device, rates, k=3):
    """Every stage of the device engine's construction, best of k, with
    its least bytes and its share of the measured copy bandwidth and of
    the data sheet's HBM rate (transfers: also of the link's rate).
    Returns (table, counts, words): the canonical stream the stages made,
    as stream_canon(check_cont=False) returns it."""
    from . import native
    p, stages, pf_host = staged_pipeline(ds, device, k)
    cap, _, chunks = p._plan_chunks()
    ms, (outs, kc), runs = best_of(
        lambda: p._emit_chunks(False, dedup=True, download=False), device, k)
    stages["emit_verify"] = (ms, runs)
    ms, (words, counts), runs = best_of(
        lambda: (dov._fetch_words(outs), kc.cpu().numpy().astype(np.int64)),
        device, k)
    stages["d2h_fetch"] = (ms, runs)

    def replay():
        res = native.build_graph_stream_canon_words(
            ds.lengths, counts, words, p.off_bits, MIN_OVERLAP - 1,
            cfg.dead_end_length)
        if res is None:
            raise RuntimeError("the native replay library is unavailable")
        return res
    ms, _, runs = best_of(replay, CPU, min(k, 2))
    stages["host_replay"] = (ms, runs)

    survivors = len(words)
    nbytes = stage_bytes(p, survivors)
    nbytes["h2d_upload"] = pf_host.nbytes
    copy = rates["d2d_copy_GBps"]
    sheet = HBM_DATASHEET_BYTES_PER_S / 1e9
    link = {"h2d_upload": rates["h2d_pageable_GBps"],
            "d2h_fetch": rates["d2h_pageable_GBps"]}
    phases = {}
    for name, (ms, runs) in stages.items():
        rec = {"ms": ms, "runs_ms": runs}
        if name in nbytes:
            gbps = nbytes[name] / ms / 1e6
            rec.update(min_bytes=nbytes[name], GBps=gbps,
                       pct_copy_bw=100 * gbps / copy,
                       pct_hbm_datasheet=100 * gbps / sheet)
            if name in link:
                rec["pct_link"] = 100 * gbps / link[name]
        else:
            rec["on"] = "host"
        phases[name] = rec
    phases["host_pack"]["bytes"] = pf_host.nbytes
    phases["probe_join"]["queries"] = int(p.hf.numel())
    phases["emit_verify"].update(chunks=len(chunks), cap=cap,
                                 candidates=p.grand, survivors=survivors)
    phases["host_replay"]["records"] = survivors
    device_ms = sum(phases[s]["ms"] for s in (
        "setup_kernel", "probe_join", "emit_verify"))
    table = {"phases": phases, "device_stages_ms": device_ms,
             "probe_join_share_of_device_stages":
                 phases["probe_join"]["ms"] / device_ms,
             "note": "min_bytes: the least a stage moves (each input read "
                     "once, each output written once, 4 bytes a value); "
                     "GBps = min_bytes / ms, the rate of a design that "
                     "moved only those bytes in this time"}
    return table, counts, words


def link_rates(device, reps=3):
    """Host<->card copy rates from pageable and pinned memory at 8 MB and
    256 MB, and the card's device-to-device copy rate (bytes read plus
    bytes written), GB/s, best of reps by CUDA events."""
    rates = {}
    for mb in (8, 256):
        n = (mb << 20) // 4
        dev = torch.ones(n, device=device)
        for kind, host in (("pageable", torch.ones(n)),
                           ("pinned", torch.ones(n).pin_memory())):
            for way, fn in (("h2d", lambda: dev.copy_(host)),
                            ("d2h", lambda: host.copy_(dev))):
                fn()
                ms = best_of(fn, device, reps)[0]
                rates["%s_%s_%dMB_GBps" % (way, kind, mb)] = \
                    (mb << 20) / ms / 1e6
    for way in ("h2d", "d2h"):
        rates["%s_pageable_GBps" % way] = max(
            rates["%s_pageable_%dMB_GBps" % (way, mb)] for mb in (8, 256))
    x = torch.ones(1 << 28, device=device)           # 1 GiB
    y = torch.empty_like(x)
    y.copy_(x)
    ms, _, runs = best_of(lambda: y.copy_(x), device, 5)
    rates["d2d_copy_GBps"] = 2 * x.nbytes / ms / 1e6
    rates["d2d_copy_runs_ms"] = runs
    rates["hbm_datasheet_GBps"] = HBM_DATASHEET_BYTES_PER_S / 1e9
    small = torch.ones(8, device=device)
    (small + 1).cpu()
    rates["dispatch_roundtrip_ms"] = min(
        timed(lambda: (small + 1).cpu(), CPU)[0] for _ in range(6))
    return rates


def utilization(ds, cfg, device, k=3):
    rates = link_rates(device)
    table, _, _ = stage_table(ds, cfg, device, rates, k)
    return {"rates": rates, **table}


def kernel_check(ds, device):
    """Both CUDA kernels bit-equal to their plain versions on the data
    set's first 4096 rows (codes masked to 2 bits, the TPU check's input)
    and on its full code matrix; window_hash_at at _setup_kernel's
    reverse-strand starts.  Raises on a mismatch."""
    from .ops import window_hash as wh
    l = MIN_OVERLAP - 1
    lmax = ds.codes_fwd.shape[1]
    result = {}
    for label, codes, lengths in (
            ("rows_4096", ds.codes_fwd[:4096] & 3, ds.lengths[:4096]),
            ("full", ds.codes_fwd, ds.lengths)):
        c = torch.from_numpy(np.ascontiguousarray(codes)).to(device)
        flipped = (3 - c.flip(1)).contiguous()[1:]
        ln = torch.from_numpy(lengths[1:].astype(np.int64)).to(device)
        starts = torch.stack([lmax - ln, torch.full_like(ln, lmax - l)], 1)
        same = {
            "window_hash": torch.equal(wh.window_hashes_cuda(c, l),
                                       wh.window_hashes_torch(c, l)),
            "window_hash_at": torch.equal(
                wh.window_hashes_at_cuda(flipped, l, starts),
                wh.window_hashes_at_torch(flipped, l, starts))}
        result[label] = {"rows": int(c.shape[0]), **same}
        if not all(same.values()):
            raise RuntimeError("kernel check failed on %s: %s"
                               % (label, same))
    result["bit_identical"] = True
    return result


# ---------------------------------------------------------------- late phase

def measure_late(device):
    """The port's CLI under `auto` on the late-phase set: construction vs
    late-phase time, and its artifacts against the oracle's hashes."""
    from . import cli
    gen_pe_bench_data()
    ref, cached = cached_reference("late", late_params(),
                                   measure_reference_late)
    with open(LATE_BASELINE_FILE) as f:
        oracle = json.load(f)["baseline"]["artifact_sha256"]
    with tempfile.TemporaryDirectory() as td:
        log_path = os.path.join(td, "log.txt")
        argv = ["cli", "-pe", "2", PE_DATA_A, PE_DATA_B, "-f",
                os.path.join(td, "t_"), "-l", str(MIN_OVERLAP)]
        with _env(MGTPU_OVERLAP_ENGINE="auto",
                  MGTPU_TORCH_DEVICE=str(device)), \
                open(log_path, "w") as f, contextlib.redirect_stdout(f):
            t_wall, asm = wall(lambda: cli.main(argv), device)
        with open(log_path) as f:
            p = log_phases(f.read())
        equal = {a: _sha256_file(os.path.join(td, "t_" + a)) == h
                 for a, h in oracle.items()}
    return {
        "engine": asm.engine, "construction_s": p["construction"],
        "late_phases_s": p["late"], "ingest_s": p["ingest"],
        "total_s": p["main"], "wall_s": t_wall,
        "artifacts_equal_reference": all(equal.values()),
        "artifacts_differing": sorted(a for a, ok in equal.items() if not ok),
        "reference_artifacts_equal_oracle":
            ref["artifact_sha256"] == oracle,
        "ref_construction_s": ref["construction_s"],
        "ref_late_s": ref["late_s"], "ref_cached": cached,
        "late_speedup_vs_ref": ref["late_s"] / p["late"],
        "counters": ref["counters"]}


# ---------------------------------------------------------------- main

def measure_device(ds, cfg, device):
    """device_cuda and hybrid_cpu_cuda on the card, then the stage table
    and the kernel check.  Warm-ups come before every timed run."""
    n = ds.number_of_unique_reads
    run_once(ds, cfg, device)
    run_device_only(ds, device)
    runs = [run_once(ds, cfg, device) for _ in range(3)]
    log("  device runs (s): %s" % [r["total"] for r in runs])
    best = min(runs, key=lambda r: r["total"])
    dev = [run_device_only(ds, device) for _ in range(6)]
    log("  device-only runs (s): %s" % dev)
    run_hybrid(ds, cfg, device)
    hy_runs = [run_hybrid(ds, cfg, device) for _ in range(3)]
    hy = [dt for dt, _ in hy_runs]
    log("  hybrid runs (s): %s" % hy)
    util = utilization(ds, cfg, device)
    log("  stages (ms): %s" % {k: round(v["ms"], 3)
                               for k, v in util["phases"].items()})
    return {
        "device_cuda": {
            "reads_per_s": n / best["total"],
            "device_compute_reads_per_s": n / min(dev),
            "phases_s": best, "runs": runs, "device_only_runs_s": dev,
            "utilization": util},
        "hybrid_cpu_cuda": {
            "reads_per_s": n / min(hy), "runs_s": hy,
            "split": hy_runs[-1][1],
            "what": "device shard + concurrent CPU shard, exact canonical "
                    "merge; the port's auto engine on one card"},
    }


def main():
    if not torch.cuda.is_available():
        raise SystemExit("the bench runs on a CUDA card; none is available")
    device = torch.device("cuda", 0)
    card = card_label()
    log("card: %s" % card)
    gen_bench_data()
    gen_pe_bench_data()
    base, base_cached = cached_reference("se", bench_params(),
                                         measure_reference)
    log("reference (%s, %s): %s" % (
        base["binary"], "cached for this host" if base_cached else
        "timed now", base))
    ds, cfg = load_dataset()
    n = ds.number_of_unique_reads

    # native first: no device work shares the host with it
    nat = measure_native(ds, cfg)
    log("native runs (s): %s" % nat)
    engines = {"native_cpu": {"reads_per_s": n / min(nat), "runs_s": nat}}

    from .ops import window_hash
    window_hash._load()
    torch.ones(1, device=device).sum().item()      # first CUDA use
    late = measure_late(device)
    log("late phase: %s" % late)
    engines.update(measure_device(ds, cfg, device))
    check = kernel_check(ds, device)

    base_rps = base["reads_per_s"]
    for rec in engines.values():
        rec["vs_baseline"] = rec["reads_per_s"] / base_rps
    dev = engines["device_cuda"]
    dev["device_compute_vs_baseline"] = (dev["device_compute_reads_per_s"]
                                         / base_rps)
    headline = max(engines, key=lambda e: engines[e]["reads_per_s"])
    print(json.dumps({
        "metric": "overlap_detection_throughput",
        "value": engines[headline]["reads_per_s"], "unit": "reads/s",
        "vs_baseline": engines[headline]["vs_baseline"],
        "headline_engine": headline, "card": card,
        "device": {"kind": torch.cuda.get_device_name(0),
                   "count": torch.cuda.device_count(),
                   "torch": torch.__version__, "cuda": torch.version.cuda},
        "unique_reads": n,
        "reference": {**base, "cached": base_cached,
                      "cpu_model": cpu_model()},
        "device_compute_reads_per_s": dev["device_compute_reads_per_s"],
        "device_compute_vs_baseline": dev["device_compute_vs_baseline"],
        "engines": engines, "kernel_check": check, "late_phases": late,
    }), flush=True)


if __name__ == "__main__":
    main()
