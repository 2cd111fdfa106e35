#!/usr/bin/env python3
"""On-card check of the PyTorch/CUDA port (metagenomics_tpu_torch).

Run from the root of a checkout on a machine with one NVIDIA Hopper card:

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught):
  1. setup: card name and power limit, torch/CUDA/nvcc versions, and the
     build of the window-hash kernels (csrc/window_hash.cu: window_hash
     and window_hash_at) and of the port's native library from the
     sources;
  2. kernel check: each CUDA kernel is bit-equal to its plain PyTorch
     version (window_hashes_torch, window_hashes_at_torch) on the card at
     the reference's test shapes, a long-read shape and both l extremes
     (phase 4 repeats the checks on its full code matrix);
  3. golden configs: the port's CLI on cuda with the device, hybrid and
     host engines writes all 12 artifacts byte-equal to golden/out/<cfg>/
     (and the normalized log equal to the reference log) for the nine
     golden configs; prints which configs took the hybrid path and which
     fell back to the device pipeline;
  4. real size: 1,000,000 single-end 100 bp reads made from a seed (20x
     coverage of two genomes, 3 Mb and 2 Mb) go through the CLI on cuda
     with the `auto` engine (which must resolve to hybrid on one card),
     the device engine and the host engine, and with the native C++
     engine; all 12 artifacts of each must be byte-equal to the native
     engine's.  Checks both kernels on that data set (window_hash at
     l = 15, 39 and 63), then prints each run's phase times and peak
     device memory, and each kernel's and plain version's time at the
     main path's shapes (window_hash also at l = 15 and 63) beside its
     bound and its share of the bound, with the card's name and power
     limit;
  5. sharded: the sharded engine (parallel/) on cuda:0, its shards held in
     one process (in-process meshes of cuda:0 repeated), and over a
     one-rank NCCL process group: the dry run over every (dp, ix) split of
     8 shards (all 12 artifacts equal the device engine's); the nine
     golden configs at (4, 2) (artifacts + normalized log); se_1m at
     (2, 2), byte-equal to phase 4's native run, with its phase times,
     peak device memory and collective ledger per phase; and the CLI on
     pe_hard in a subprocess that joins an NCCL group of one rank
     (MGTPU_COORDINATOR / MGTPU_NUM_PROCESSES / MGTPU_PROCESS_ID), equal
     to golden.  Shards that share one card say nothing about scaling;
  6. measurement: entry() (metagenomics_tpu_torch/entry.py) on cuda equals
     the same call on the CPU, element for element; on the bench's 200k-read
     set (metagenomics_tpu_torch/bench.py), stream(download=False) returns
     None and launches each kernel once; the bench's staged device path
     (its stage table) gives survivor words and counts equal to
     stream_canon(False); one run_once, one run_device_only and one hybrid
     run complete and print their times with the card label; the bench's
     kernel check passes; then the stage table (each device stage's time
     beside its least bytes and the card's measured copy bandwidth) on
     phase 4's 1M reads, best of 3;
  7. fuzz and scale: the port's fuzzer (measure/pipefuzz.py) in this
     process on seeds 7, 9 and 20 (random repeat-heavy sets of mixed read
     lengths) in each mode (se, pe, mix: a -pe and a -se file) under the
     device and hybrid engines on cuda:0, and one seed a mode under the
     sharded engine at (2, 2); every run's 11 artifacts and rc must equal
     the native engine's (native vs the reference binary is counted and
     printed); then measure/scale.py at 200,000 reads (native, auto,
     device, each a child process) must print equal artifacts, auto
     resolved to hybrid, a peak RSS and the device runs' peak device
     memory.

Each kernel's launch counter is set to 0 just before each run of the CLI
and read just after it; a device or hybrid run (one that did not fall
back) that did not launch each kernel fails the smoke, and a se_1m device
or hybrid run must launch each exactly once, a sharded run exactly once a
shard (dp * ix; the dry run's sweep is checked in total), and phase 6's
bench path (stage table, run_once, device-only and hybrid runs) exactly
four times, and phase 7's fuzz runs once each a device or hybrid run and
once a shard a sharded run.  The main path is phase 4's
`auto` (hybrid) run.  The smoke fails if jax or any module of the JAX
package (metagenomics_tpu) was imported.  The last two lines are the
kernels record and {"ok": true, "device": ...}.  Exits non-zero without
a result when no CUDA device is available.
"""

import contextlib
import json
import os
import subprocess
import sys
import tempfile
import threading
import time

REPO = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(REPO, "golden")
ARTIFACTS = [
    "_sortedReads.fasta", ".unitig", "_flow.input", "_flow.output",
    "graph1.gdl", "contigs1.fasta", "graph2.gdl", "contigs2.fasta",
    "graph3.gdl", "contigs3.fasta", "graph4.gdl", "contigs4.fasta",
]


def _data(*names):
    return [os.path.join(GOLDEN, "data", n) for n in names]


GOLDEN_CONFIGS = {
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

# (rows, lmax, l): tests/test_ops.py's Pallas shapes, a long-read shape
# at the 4096 length cap, and the l = lmax / l = 1 extremes
KERNEL_SHAPES = [(3, 50, 11), (300, 100, 39), (64, 130, 64),
                 (256, 4095, 63), (5, 40, 40), (7, 33, 1)]

# the kernels of the port's main path, each with its own launch counter
KERNELS = ("window_hash", "window_hash_at")

# the card's peak rates for bound_ms (NVIDIA's data sheet, H100 SXM):
# device memory, and 32-bit operations outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
OPS_PER_S = 67e12

# phase 4 data set: bench.py's generator (seed 7, random strand) at 1M
# reads over 3 Mb + 2 Mb genomes
REAL_SEED = 7
REAL_GENOMES = [3_000_000, 2_000_000]
REAL_READS = 1_000_000
REAL_LEN = 100
MIN_OVERLAP = 40

# phase 7: the smallest fuzz seeds of 1-40, one of them a mode under the
# sharded engine, and the scale tool's size
FUZZ_SEEDS = (7, 9, 20)
FUZZ_SHARDED_SEED = {"se": 20, "pe": 7, "mix": 9}
SCALE_READS = 200_000


def log(msg=""):
    print(msg, flush=True)


def card_label():
    """`nvidia-smi --query-gpu=name,power.limit` for the card in use."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()
    return out[0].strip()


# ------------------------------------------------------------------ phases

def setup(torch, window_hash):
    log("== phase 1: setup")
    log("card: %s" % card_label())
    log("python %s, torch %s, CUDA %s, device count %d"
        % (sys.version.split()[0], torch.__version__, torch.version.cuda,
           torch.cuda.device_count()))
    nvcc = window_hash._find_nvcc()
    ver = subprocess.run([nvcc, "--version"], capture_output=True,
                         text=True, check=True).stdout.strip()
    log("nvcc (%s): %s" % (nvcc, ver.splitlines()[-1]))
    # the native replay library (g++) builds beside the kernels (nvcc), so
    # no timed phase pays for either
    from metagenomics_tpu_torch import native
    built = {}
    t0 = time.time()
    g = threading.Thread(target=lambda: built.update(
        lib=native.get_lib(), s=time.time() - t0))
    g.start()
    so = window_hash.build_library()
    window_hash._load()
    log("window_hash kernels built in %.3f s: %s"
        % (time.time() - t0, os.path.relpath(so, REPO)))
    g.join()
    if built["lib"] is None:
        raise SystemExit("the native replay library failed to build")
    log("native replay library ready in %.3f s" % built["s"])
    build_log = os.path.join(os.path.dirname(so), "build.log")
    if os.path.exists(build_log):
        for line in open(build_log).read().splitlines():
            if any(w in line for w in ("entry function", "registers",
                                       "spill", "smem")):
                log("  ptxas: %s" % line.strip())


def check_equal(torch, got_fn, want_fn, label):
    """A kernel vs its plain version on the same CUDA inputs; returns the
    max |err| (0: they must be bit-equal)."""
    got = got_fn()
    torch.cuda.synchronize()
    want = want_fn()
    torch.cuda.synchronize()
    err = int((got - want).abs().max()) if got.numel() else 0
    same = torch.equal(got, want)
    log("  %-52s %s" % (label, "bit-equal" if same else "MISMATCH"))
    if not same:
        raise SystemExit("kernel disagrees with its plain version at %s "
                         "(max abs err %d)" % (label, err))
    return err


def check_hashes(torch, window_hash, codes, l, label):
    """window_hash vs window_hashes_torch on one CUDA tensor."""
    return check_equal(
        torch, lambda: window_hash.window_hashes_cuda(codes, l),
        lambda: window_hash.window_hashes_torch(codes, l),
        "window_hash %s l=%d" % (label, l))


def reverse_starts(torch, lengths, lmax, l):
    """_setup_kernel's reverse-strand starts (lmax - len, lmax - l) for
    rows [1:] of a code matrix, int64 [n, 2] on the card."""
    lengths = torch.as_tensor(lengths[1:], dtype=torch.int64).cuda()
    return torch.stack([lmax - lengths, torch.full_like(lengths, lmax - l)],
                       dim=1)


def check_at(torch, window_hash, codes, l, starts, label):
    """window_hash_at vs window_hashes_at_torch on one CUDA tensor."""
    return check_equal(
        torch, lambda: window_hash.window_hashes_at_cuda(codes, l, starts),
        lambda: window_hash.window_hashes_at_torch(codes, l, starts),
        "window_hash_at %s l=%d" % (label, l))


def kernel_check(torch, window_hash, rng):
    log("== phase 2: kernel check (CUDA vs plain, exact equality)")
    err = dict.fromkeys(KERNELS, 0)
    for n, lmax, l in KERNEL_SHAPES:
        codes = torch.from_numpy(
            rng.integers(0, 5, (n, lmax)).astype("uint8")).cuda()
        label = "random codes [%d, %d]" % (n, lmax)
        err["window_hash"] = max(err["window_hash"], check_hashes(
            torch, window_hash, codes, l, label))
        # rows [1:] as _setup_kernel passes them (a view 1 row in), at the
        # reverse-strand starts of random lengths and at random starts
        lengths = rng.integers(l, lmax + 1, n)
        starts = torch.cat([
            reverse_starts(torch, lengths, lmax, l),
            torch.from_numpy(rng.integers(0, lmax - l + 1, (n - 1, 1))).cuda(),
        ], dim=1)
        err["window_hash_at"] = max(err["window_hash_at"], check_at(
            torch, window_hash, codes[1:], l, starts,
            "rows [1:] of %s" % label))
    return err


def hash_bound(n, lmax, l):
    """(bound_ms, bound_by, bytes) of window_hash at [n, lmax], l: codes
    read once, hashes written once; operations: a multiply and an add per
    code byte and base for the prefixes, and 7 per output (a multiply and
    a subtract per base, then 2 multiplies and a xor to mix)."""
    npos = lmax - l + 1
    nbytes = n * lmax + n * npos * 8
    ops = n * (4 * lmax + 7 * npos)
    return bound(nbytes, ops) + (nbytes,)


def at_bound(torch, starts, l):
    """(bound_ms, bound_by, bytes) of window_hash_at: the code bytes the
    windows of each row cover (their union, from this run's starts), the
    starts read and the hashes written once; operations: 2 multiply-adds
    per base, 2 bases, per window byte, and the mix."""
    s = torch.sort(starts, dim=1).values
    covered = int((l + torch.clamp(s[:, 1:] - s[:, :-1], max=l).sum(1))
                  .sum())
    nbytes = covered + 2 * starts.numel() * 8
    ops = starts.numel() * (4 * l + 3)
    return bound(nbytes, ops) + (nbytes,)


def bound(nbytes, ops):
    """The larger of the bytes' and the operations' least times, in ms."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / OPS_PER_S * 1e3
    return ((t_bytes, "bytes") if t_bytes >= t_ops
            else (t_ops, "operations"))


@contextlib.contextmanager
def _in_dir(path, env):
    old_cwd = os.getcwd()
    old_env = {k: os.environ.get(k) for k in env}
    os.chdir(path)
    os.environ.update(env)
    try:
        yield
    finally:
        os.chdir(old_cwd)
        for k, v in old_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def run_cli(args, workdir, engine, mesh=None):
    """The port's CLI in this process (so its kernel launches are
    counted), stdout to workdir/log.txt, with the sharded engine's mesh
    if one is given.  Returns (Assembler, log)."""
    from metagenomics_tpu_torch import cli
    os.makedirs(workdir, exist_ok=True)
    argv = [cli.__file__, *args, "-f", "t_", "-l", str(MIN_OVERLAP)]
    env = {"MGTPU_OVERLAP_ENGINE": engine, "MGTPU_TORCH_DEVICE": "cuda"}
    with _in_dir(workdir, env), open("log.txt", "w") as f, \
            contextlib.redirect_stdout(f):
        asm = cli.main(argv, mesh)
    return asm, open(os.path.join(workdir, "log.txt")).read()


def diff_artifacts(dir_a, prefix_a, dir_b, prefix_b):
    bad = []
    for art in ARTIFACTS:
        a = open(os.path.join(dir_a, prefix_a + art), "rb").read()
        b = open(os.path.join(dir_b, prefix_b + art), "rb").read()
        if a != b:
            bad.append(art)
    return bad


def reset_counts(window_hash):
    window_hash.launches = 0
    window_hash.at_launches = 0


def read_counts(window_hash):
    return {"window_hash": window_hash.launches,
            "window_hash_at": window_hash.at_launches}


def golden_run(window_hash, name, wd, engine, label, mesh=None):
    """Golden config `name` through the CLI in wd, with the launch counters
    set to 0 just before it and read just after; prints one line and
    fails unless all 12 artifacts and the normalized log equal
    golden/out/<name>/.  Returns (Assembler, launches by kernel)."""
    from logutil import normalize_log
    t0 = time.time()
    reset_counts(window_hash)
    asm, text = run_cli(GOLDEN_CONFIGS[name], wd, engine, mesh)
    counts = read_counts(window_hash)
    dt = time.time() - t0
    bad = diff_artifacts(wd, "t_", os.path.join(GOLDEN, "out", name), "g_")
    ref = open(os.path.join(GOLDEN, "out", name, "log.txt")).read()
    log_ok = normalize_log(text) == normalize_log(ref)
    log("  %-14s %-10s %6.2f s  ran %-7s  launches %s  12 artifacts %s, "
        "log %s" % (label, name, dt, asm.engine, counts,
                    "byte-equal" if not bad else "DIFFER %s" % bad,
                    "equal" if log_ok else "DIFFERS"))
    if bad or not log_ok:
        raise SystemExit("golden config %s differs on the card (%s)"
                         % (name, label))
    return asm, counts


def golden_phase(window_hash, tmp):
    log("== phase 3: golden configs, device, hybrid and host engines on "
        "cuda")
    launched = {}
    took = {}
    for engine in ("device", "hybrid", "host"):
        launched[engine] = dict.fromkeys(KERNELS, 0)
        for name in GOLDEN_CONFIGS:
            asm, counts = golden_run(
                window_hash, name,
                os.path.join(tmp, "golden_%s_%s" % (engine, name)), engine,
                engine)
            if asm.engine in ("device", "hybrid") and \
                    min(counts.values()) <= 0:
                raise SystemExit("the %s run of %s did not launch every "
                                 "kernel: %s" % (asm.engine, name, counts))
            if engine == "hybrid":
                took.setdefault(asm.engine, []).append(name)
            for k, v in counts.items():
                launched[engine][k] += v
    log("  hybrid path taken by: %s" % ", ".join(took.get("hybrid", [])))
    log("  fell back to the device pipeline: %s"
        % (", ".join(took.get("device", [])) or "none"))
    log("  launches in phase 3: %s" % launched)


def write_reads(path):
    """bench.py's single-end generator at phase 4's size."""
    import numpy as np
    rng = np.random.default_rng(REAL_SEED)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    comp = np.zeros(256, dtype=np.uint8)
    for a, b in zip(b"ACGT", b"TGCA"):
        comp[a] = b
    rid = 0
    with open(path, "wb") as f:
        for g_len in REAL_GENOMES:
            genome = bases[rng.integers(0, 4, g_len)]
            n = int(REAL_READS * g_len / sum(REAL_GENOMES))
            starts = rng.integers(0, g_len - REAL_LEN + 1, n)
            reads = genome[starts[:, None] + np.arange(REAL_LEN)[None, :]]
            flip = rng.random(n) < 0.5
            reads = np.where(flip[:, None], comp[reads[:, ::-1]], reads)
            f.write(b"".join(b">r%d\n%s\n" % (rid + i, row.tobytes())
                             for i, row in enumerate(reads)))
            rid += n
    return rid


def time_turns(torch, fns, reps=10):
    """Mean ms per call of each no-argument fn, timed with CUDA events in
    turns f0, f1, ..., f1, f0 (plain, kernel, kernel, plain) after one
    warm-up call each."""
    for fn in fns.values():
        fn()
    torch.cuda.synchronize()
    names = list(fns)
    total = dict.fromkeys(names, 0.0)
    for name in names + names[::-1]:
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fns[name]()
        stop.record()
        torch.cuda.synchronize()
        total[name] += start.elapsed_time(stop)
    return {k: v / (2 * reps) for k, v in total.items()}


def engine_run(torch, window_hash, args, workdir, engine, card, mesh=None):
    """One CLI run on cuda with the launch counters and the peak device
    memory reset just before it and read just after; prints its phase
    times.  Returns (Assembler, launches by kernel)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(window_hash)
    asm, _ = run_cli(args, workdir, engine, mesh)
    torch.cuda.synchronize()
    counts = read_counts(window_hash)
    peak = torch.cuda.max_memory_allocated()
    log("  %s engine (ran %s) [%s]: %d unique reads, launches %s, peak "
        "device memory %d bytes"
        % (engine, asm.engine, card, asm.dataset.number_of_unique_reads,
           counts, peak))
    for k, v in asm.timings.items():
        log("    %-32s %.6f s" % (k, v))
    want = shards(mesh) if asm.engine == "sharded" else 1
    if asm.engine in ("device", "hybrid", "sharded") and \
            counts != dict.fromkeys(KERNELS, want):
        raise SystemExit("the %s run launched %s, not each kernel %d "
                         "time(s)" % (asm.engine, counts, want))
    return asm, counts


def shards(mesh):
    return mesh.shape["dp"] * mesh.shape["ix"]


def timed_record(torch, fns, reps, bound_ms, bound_by, nbytes, label, card):
    """Time the kernel's wrapper vs the plain version in turns; print both
    beside the bound and the kernel's share of it."""
    ms = time_turns(torch, fns, reps)
    log("  %s [%s]: plain %.6f ms, kernel %.6f ms, bound %.6f ms (%s: %d "
        "bytes), kernel at %.1f%% of the bound"
        % (label, card, ms["plain"], ms["kernel"], bound_ms, bound_by,
           nbytes, 100 * bound_ms / ms["kernel"]))
    return {"ms": ms["kernel"], "plain_ms": ms["plain"],
            "bound_ms": bound_ms, "bound_by": bound_by}


def real_size_phase(torch, window_hash, tmp, card):
    log("== phase 4: real size, %d reads of %d bp" % (REAL_READS, REAL_LEN))
    path = os.path.join(tmp, "reads_1m.fasta")
    t0 = time.time()
    n = write_reads(path)
    log("  generated %d reads in %.3f s (seed %d)"
        % (n, time.time() - t0, REAL_SEED))
    args = ["-se", "1", path]

    # the main path: `auto` on one card is the hybrid engine
    asm, launches = engine_run(torch, window_hash, args,
                               os.path.join(tmp, "real_auto"), "auto", card)
    if asm.engine != "hybrid":
        raise SystemExit("auto on one card ran %s, not hybrid" % asm.engine)
    by_path = {"hybrid": launches}
    ds = asm.dataset
    _, by_path["device"] = engine_run(torch, window_hash, args,
                                      os.path.join(tmp, "real_device"),
                                      "device", card)
    engine_run(torch, window_hash, args, os.path.join(tmp, "real_host"),
               "host", card)

    nat_dir = os.path.join(tmp, "real_native")
    nasm, _ = run_cli(args, nat_dir, "native")
    log("  native engine [host CPU of %s]:" % card)
    for k, v in nasm.timings.items():
        log("    %-32s %.6f s" % (k, v))
    for engine in ("auto", "device", "host"):
        bad = diff_artifacts(os.path.join(tmp, "real_" + engine), "t_",
                             nat_dir, "t_")
        log("  12 artifacts %s vs native: %s"
            % (engine, "byte-equal" if not bad else "DIFFER %s" % bad))
        if bad:
            raise SystemExit("1M-read artifacts differ between the %s and "
                             "the native engine: %s" % (engine, bad))

    l = MIN_OVERLAP - 1
    err = dict.fromkeys(KERNELS, 0)
    # the first 4096 rows with codes masked to 2 bits: the input the TPU
    # kernel's own on-chip check used (TPU_KERNEL_CHECK.json), kept so the
    # two records compare; the full matrix below is the main path's input
    err["window_hash"] = check_hashes(
        torch, window_hash, torch.from_numpy(ds.codes_fwd[:4096] & 3).cuda(),
        l, "dataset rows [4096, %d]" % ds.codes_fwd.shape[1])
    codes = torch.from_numpy(ds.codes_fwd).cuda()
    rows, lmax = codes.shape
    for hl in (15, l, 63):
        err["window_hash"] = max(err["window_hash"], check_hashes(
            torch, window_hash, codes, hl, "dataset [%d, %d]" % (rows, lmax)))
    # window_hash_at's main-path input: rows [1:] of the flipped reverse
    # strand (_setup_kernel), at starts (lmax - len, lmax - l)
    flipped = (3 - codes.flip(1)).contiguous()
    starts = reverse_starts(torch, ds.lengths, lmax, l)
    err["window_hash_at"] = check_at(
        torch, window_hash, flipped[1:], l, starts,
        "flipped rows [1:] [%d, %d], starts [%d, 2]"
        % (rows - 1, lmax, rows - 1))

    sweep = {}
    for hl in (15, l, 63):
        bound_ms, bound_by, nbytes = hash_bound(rows, lmax, hl)
        sweep[hl] = timed_record(
            torch, {"plain": lambda: window_hash.window_hashes_torch(codes, hl),
                    "kernel": lambda: window_hash.window_hashes_cuda(codes,
                                                                     hl)},
            20, bound_ms, bound_by, nbytes,
            "window_hash at [%d, %d], l=%d" % (rows, lmax, hl), card)
    bound_ms, bound_by, nbytes = at_bound(torch, starts, l)
    rev = flipped[1:]
    # the wrapper as the main path calls it: its range check reads the
    # starts' min and max back to the host before the launch
    at = timed_record(
        torch,
        {"plain": lambda: window_hash.window_hashes_at_torch(rev, l, starts),
         "kernel": lambda: window_hash.window_hashes_at_cuda(rev, l, starts)},
        20, bound_ms, bound_by, nbytes,
        "window_hash_at at [%d, %d] x [%d, 2], l=%d"
        % (rows - 1, lmax, rows - 1, l), card)
    return [
        {"name": "window_hash", **sweep[l], "max_abs_err": err["window_hash"],
         "launches": launches["window_hash"],
         "sweep_l": {str(k): v for k, v in sweep.items()}},
        {"name": "window_hash_at", **at,
         "max_abs_err": err["window_hash_at"],
         "launches": launches["window_hash_at"]},
    ], by_path


# phase 5's one-rank NCCL run: the port's CLI with jax and the JAX package
# unimportable; prints the process group's backend and the launches
NCCL_CLI = r"""
import json, sys
sys.modules["jax"] = None
sys.modules["metagenomics_tpu"] = None
sys.path.insert(0, sys.argv[1])
import torch.distributed as dist
from metagenomics_tpu_torch.cli import main
from metagenomics_tpu_torch.ops import window_hash
asm = main(sys.argv[2:])
print("SHARDED_RUN " + json.dumps({
    "backend": dist.get_backend(), "world": dist.get_world_size(),
    "engine": asm.engine, "launches": {
        "window_hash": window_hash.launches,
        "window_hash_at": window_hash.at_launches}}))
dist.destroy_process_group()
"""


def free_port():
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def sharded_phase(torch, window_hash, tmp, card):
    """Phase 5; returns the se_1m (2, 2) run's launches by kernel."""
    from metagenomics_tpu_torch.parallel import collectives, dryrun
    from metagenomics_tpu_torch.parallel.mesh import make_mesh
    log("== phase 5: sharded engine on cuda:0 (shards in one process, and "
        "a one-rank NCCL group)")
    log("  shards that share one card say nothing about scaling")
    dev = torch.device("cuda", 0)

    # 5.1: the dry run over every split of 8 shards; one device-engine run
    # (1 launch each) and one sharded run a split (8 each)
    reset_counts(window_hash)
    t0 = time.time()
    done = dryrun.dryrun_multichip(8, dev)
    counts = read_counts(window_hash)
    want = 1 + 8 * len(done)
    log("  dryrun_multichip(8) on cuda:0: splits %s, 12 artifacts equal "
        "the device engine's, %.2f s, launches %s" % (done, time.time() - t0,
                                                     counts))
    if done != [(8, 1), (4, 2), (2, 4), (1, 8)] or \
            counts != dict.fromkeys(KERNELS, want):
        raise SystemExit("the dry run swept %s with launches %s (want %d "
                         "each)" % (done, counts, want))

    # 5.2: the nine golden configs at (4, 2)
    for name in GOLDEN_CONFIGS:
        asm, counts = golden_run(
            window_hash, name, os.path.join(tmp, "golden_sharded_%s" % name),
            "sharded", "sharded (4, 2)",
            make_mesh(dp=4, ix=2, devices=[dev] * 8))
        if asm.engine != "sharded" or counts != dict.fromkeys(KERNELS, 8):
            raise SystemExit("golden config %s under sharded (4, 2) ran %s "
                             "with launches %s" % (name, asm.engine, counts))

    # 5.3: se_1m at (2, 2), byte-equal to phase 4's native run
    mesh = make_mesh(dp=2, ix=2, devices=[dev] * 4)
    collectives.LEDGER.reset()
    asm, launches = engine_run(
        torch, window_hash, ["-se", "1", os.path.join(tmp, "reads_1m.fasta")],
        os.path.join(tmp, "real_sharded"), "sharded", card, mesh)
    if asm.engine != "sharded":
        raise SystemExit("the se_1m sharded run ran %s" % asm.engine)
    bad = diff_artifacts(os.path.join(tmp, "real_sharded"), "t_",
                         os.path.join(tmp, "real_native"), "t_")
    log("  12 artifacts sharded (2, 2) vs native: %s"
        % ("byte-equal" if not bad else "DIFFER %s" % bad))
    if bad:
        raise SystemExit("1M-read artifacts differ between the sharded and "
                         "the native engine: %s" % bad)
    rep = collectives.LEDGER.report()
    log("  collective ledger, se_1m at (2, 2) [%s]: payload %d bytes, "
        "wire %d bytes, %.6f s at NVLink's %.3g B/s (a model: these shards "
        "share one card and move nothing over NVLink)"
        % (card, rep["total_payload_bytes"], rep["total_wire_bytes"],
           rep["model"]["projected_nvlink_seconds"],
           rep["model"]["nvlink_bytes_per_s"]))
    for phase, rec in rep["phases"].items():
        log("    %-10s x%d: %s" % (phase, rec["invocations"], ", ".join(
            "%s/%s/%d %d bytes" % (c["op"], c["axis"], c["axis_size"],
                                   c["payload_bytes"])
            for c in rec["collectives"])))

    # 5.4: the CLI over a one-rank NCCL process group
    wd = os.path.join(tmp, "nccl_pe_hard")
    os.makedirs(wd)
    env = dict(os.environ, MGTPU_COORDINATOR="127.0.0.1:%d" % free_port(),
               MGTPU_NUM_PROCESSES="1", MGTPU_PROCESS_ID="0",
               MGTPU_OVERLAP_ENGINE="sharded", MGTPU_TORCH_DEVICE="cuda")
    t0 = time.time()
    proc = subprocess.run(
        [sys.executable, "-c", NCCL_CLI, REPO, "cli",
         *GOLDEN_CONFIGS["pe_hard"], "-f", "t_", "-l", str(MIN_OVERLAP)],
        cwd=wd, env=env, capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise SystemExit("the one-rank NCCL run failed (rc %d):\n%s%s"
                         % (proc.returncode, proc.stdout[-3000:],
                            proc.stderr[-3000:]))
    run = json.loads(proc.stdout.split("SHARDED_RUN ")[1].splitlines()[0])
    bad = diff_artifacts(wd, "t_", os.path.join(GOLDEN, "out", "pe_hard"),
                         "g_")
    log("  one-rank process group (CLI in a subprocess, %.2f s): backend "
        "%s, world %d, engine %s, launches %s, 12 artifacts %s"
        % (time.time() - t0, run["backend"], run["world"], run["engine"],
           run["launches"], "byte-equal" if not bad else "DIFFER %s" % bad))
    if run["backend"] != "nccl" or run["engine"] != "sharded" or bad or \
            run["launches"] != dict.fromkeys(KERNELS, 1):
        raise SystemExit("the one-rank NCCL run: %s, artifacts %s"
                         % (run, bad or "equal"))
    return launches


def log_stage_table(table, label):
    log("  stage table, %s:" % label)
    for name, rec in table["phases"].items():
        where = ("host" if "on" in rec else
                 "%d bytes, %.2f%% of copy bandwidth, %.2f%% of the data "
                 "sheet" % (rec["min_bytes"], rec["pct_copy_bw"],
                            rec["pct_hbm_datasheet"]))
        log("    %-12s %12.6f ms  %s" % (name, rec["ms"], where))
    emit = table["phases"]["emit_verify"]
    log("    emit_verify: %d chunk(s) of %d slots, %d candidates, %d "
        "survivors" % (emit["chunks"], emit["cap"], emit["candidates"],
                       emit["survivors"]))
    log("    probe_join: %.1f%% of the device stages' %.6f ms"
        % (100 * table["probe_join_share_of_device_stages"],
           table["device_stages_ms"]))


def measurement_phase(torch, window_hash, tmp, card):
    """Phase 6; returns the bench path's launches by kernel."""
    import numpy as np
    from metagenomics_tpu_torch import bench
    from metagenomics_tpu_torch.entry import entry
    from metagenomics_tpu_torch.ops.device_overlap import (
        DeviceOverlapPipeline)
    log("== phase 6: measurement (entry() and the bench's device path)")
    t_phase = time.time()
    cuda = torch.device("cuda", 0)
    fn, args = entry(cuda)
    got = fn(*args).cpu()
    fn, args = entry("cpu")
    want = fn(*args)
    log("  entry() on cuda vs the CPU: %d of %d pairs verified on both, %s"
        % (int(got.sum()), got.numel(),
           "equal" if torch.equal(got, want) else "DIFFERENT"))
    if not torch.equal(got, want):
        raise SystemExit("entry() on cuda differs from the CPU call")

    t0 = time.time()
    bench.gen_bench_data()
    ds, cfg = bench.load_dataset()
    log("  bench set: %d unique reads, made and loaded in %.3f s"
        % (ds.number_of_unique_reads, time.time() - t0))

    reset_counts(window_hash)
    p = DeviceOverlapPipeline(ds, MIN_OVERLAP, device=cuda)
    res = p.stream(check_cont=False, download=False)
    torch.cuda.synchronize()
    counts = read_counts(window_hash)
    log("  pipeline + stream(download=False): returned %r, launches %s"
        % (res, counts))
    if res is not None or counts != dict.fromkeys(KERNELS, 1):
        raise SystemExit("stream(download=False) returned %r with launches "
                         "%s" % (res, counts))

    # the bench path: its stage table, one end-to-end device run, one
    # device-only run and one hybrid run, one launch of each kernel each
    rates = bench.link_rates(cuda)
    reset_counts(window_hash)
    table, kc, words = bench.stage_table(ds, cfg, cuda, rates, k=1)
    staged = read_counts(window_hash)
    once = bench.run_once(ds, cfg, cuda)
    dev_s = bench.run_device_only(ds, cuda)
    hy_s, split = bench.run_hybrid(ds, cfg, cuda)
    launches = read_counts(window_hash)
    kc2, words2, _, _ = p.stream_canon(check_cont=False)
    same = np.array_equal(kc, kc2) and np.array_equal(words, words2)
    log("  [%s] stage table's words (%d) and counts %s stream_canon(False)'s;"
        " copy bandwidth %.3f GB/s (data sheet %.0f GB/s)"
        % (card, len(words), "equal" if same else "DIFFERENT from",
           rates["d2d_copy_GBps"], rates["hbm_datasheet_GBps"]))
    log_stage_table(table, "bench set, one call each")
    log("  [%s] run_once %.6f s (index %.6f, stream %.6f, replay %.6f), "
        "device-only %.6f s, hybrid %.6f s (%s)"
        % (card, once["total"], once["index"], once["stream"], once["build"],
           dev_s, hy_s, split))
    log("  launches: stage table %s, bench path %s" % (staged, launches))
    if not same:
        raise SystemExit("the stage table's stream differs from "
                         "stream_canon(False)")
    if staged != dict.fromkeys(KERNELS, 1) or \
            launches != dict.fromkeys(KERNELS, 4):
        raise SystemExit("the bench path launched %s (stage table %s), not "
                         "each kernel 4 times" % (launches, staged))
    check = bench.kernel_check(ds, cuda)
    log("  kernel check on the bench set: %s" % check)

    # the stage table at se_1m (phase 4's reads), best of 3
    ds, cfg = bench.load_dataset(os.path.join(tmp, "reads_1m.fasta"))
    table, _, _ = bench.stage_table(ds, cfg, cuda, rates, k=3)
    log_stage_table(table, "se_1m (%d unique reads), best of 3 [%s]"
                    % (ds.number_of_unique_reads, card))
    log("  phase 6 took %.3f s" % (time.time() - t_phase))
    return launches


def fuzz_phase(torch, window_hash, card):
    """Phase 7; returns the fuzz runs' launches by kernel."""
    from metagenomics_tpu_torch.measure import pipefuzz, scale
    log("== phase 7: fuzz (seeds %s in se, pe and mix) and scale (%d reads)"
        % (list(FUZZ_SEEDS), SCALE_READS))
    t_phase = time.time()
    dev = torch.device("cuda", 0)
    with_binary = pipefuzz.binary_runs()
    # (2, 2) on cuda:0 on one card, one shard a card on several
    mesh = pipefuzz.make_fuzz_mesh(dev)
    label = "sharded (%d, %d)" % (mesh.shape["dp"], mesh.shape["ix"])
    want = 0
    reset_counts(window_hash)
    for mode in pipefuzz.MODES:
        t0 = time.time()
        runs = [pipefuzz.fuzz(FUZZ_SEEDS, mode, MIN_OVERLAP,
                              ("device", "hybrid"), dev, with_binary,
                              log=lambda m: log("    " + m)),
                pipefuzz.fuzz([FUZZ_SHARDED_SEED[mode]], mode, MIN_OVERLAP,
                              ("sharded",), dev, False,
                              log=lambda m: log("    %s %s" % (label, m)))]
        want += 2 * len(FUZZ_SEEDS) + shards(mesh)
        equal = {e: "%d/%d" % (r["equal_native"], len(out["seeds"]))
                 for out in runs for e, r in out["engines"].items()}
        nat = runs[0]["native"]
        log("  %s [%s]: equal to native %s; native equal to the binary %s; "
            "%.2f s" % (mode, card, equal, "%d/%d" % (
                nat["equal_binary"], len(FUZZ_SEEDS)) if with_binary
                else "not run", time.time() - t0))
        for out in runs:
            if out["failures"]:
                raise SystemExit("fuzz %s: engines differ from native: %s"
                                 % (mode, out["failures"]))
    launches = read_counts(window_hash)
    log("  fuzz launches %s (want %d each: one a device or hybrid run, one "
        "a shard a sharded run)" % (launches, want))
    if launches != dict.fromkeys(KERNELS, want):
        raise SystemExit("the fuzz runs launched %s, not each kernel %d "
                         "times" % (launches, want))

    t0 = time.time()
    res = scale.main(["--n-reads", str(SCALE_READS), "--skip-reference",
                      "--engines", "native,auto,device"])
    for name, rec in res["engines"].items():
        log("  scale %-6s [%s]: ran %s, %.3f s, peak RSS %d bytes, peak "
            "device memory %s bytes, artifacts %s"
            % (name, res["card"], rec["engine"], rec["wall_s"],
               rec["peak_rss_bytes"], rec["max_memory_allocated"],
               "native's" if name == "native" else
               "equal" if not rec["artifacts_differing"] else
               "DIFFER %s" % rec["artifacts_differing"]))
    eng = res["engines"]
    if eng["auto"]["engine"] != "hybrid" or \
            min(r["peak_rss_bytes"] for r in eng.values()) <= 0 or \
            min(eng[e]["max_memory_allocated"] for e in ("auto", "device")) \
            <= 0:
        raise SystemExit("the scale tool's runs: %s" % eng)
    log("  scale tool %.3f s; phase 7 took %.3f s"
        % (time.time() - t0, time.time() - t_phase))
    return launches


def main():
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        sys.stderr.write("chip_smoke: no CUDA device available\n")
        return 2
    sys.path[:0] = [REPO, os.path.join(REPO, "tests")]
    from metagenomics_tpu_torch.ops import window_hash

    card = card_label()
    rng = np.random.default_rng(5)
    setup(torch, window_hash)
    err = kernel_check(torch, window_hash, rng)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        golden_phase(window_hash, tmp)
        records, by_path = real_size_phase(torch, window_hash, tmp, card)
        by_path["sharded"] = sharded_phase(torch, window_hash, tmp, card)
        by_path["bench"] = measurement_phase(torch, window_hash, tmp, card)
        by_path["fuzz"] = fuzz_phase(torch, window_hash, card)
    leaked = sorted(m for m in sys.modules
                    if m == "jax" or m.startswith("jax.")
                    or m == "metagenomics_tpu"
                    or m.startswith("metagenomics_tpu."))
    if leaked:
        raise SystemExit("the port imported %s" % ", ".join(leaked))

    kernels = []
    for rec in records:
        name = rec["name"]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "metagenomics_tpu_torch/csrc/window_hash.cu",
            "replaces": "metagenomics_tpu/ops/pallas_hash.py:56",
            **rec, "max_abs_err": max(err[name], rec["max_abs_err"]),
            # no single PyTorch call computes a window hash
            "library_ms": None, "paths": sorted(by_path),
            "launches_by_path": {p: c[name] for p, c in by_path.items()}})
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
