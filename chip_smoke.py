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
     limit.

Each kernel's launch counter is set to 0 just before each run of the CLI
and read just after it; a device or hybrid run (one that did not fall
back) that did not launch each kernel fails the smoke, and a se_1m device
or hybrid run must launch each exactly once.  The main path is phase 4's
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


def run_cli(args, workdir, engine):
    """The port's CLI in this process (so its kernel launches are
    counted), stdout to workdir/log.txt.  Returns (Assembler, log)."""
    from metagenomics_tpu_torch import cli
    os.makedirs(workdir, exist_ok=True)
    argv = [cli.__file__, *args, "-f", "t_", "-l", str(MIN_OVERLAP)]
    env = {"MGTPU_OVERLAP_ENGINE": engine, "MGTPU_TORCH_DEVICE": "cuda"}
    with _in_dir(workdir, env), open("log.txt", "w") as f, \
            contextlib.redirect_stdout(f):
        asm = cli.main(argv)
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


def golden_phase(window_hash, tmp):
    log("== phase 3: golden configs, device, hybrid and host engines on "
        "cuda")
    sys.path.insert(0, os.path.join(REPO, "tests"))
    from logutil import normalize_log
    launched = {}
    took = {}
    for engine in ("device", "hybrid", "host"):
        launched[engine] = dict.fromkeys(KERNELS, 0)
        for name, args in GOLDEN_CONFIGS.items():
            wd = os.path.join(tmp, "golden_%s_%s" % (engine, name))
            t0 = time.time()
            reset_counts(window_hash)
            asm, text = run_cli(args, wd, engine)
            counts = read_counts(window_hash)
            dt = time.time() - t0
            bad = diff_artifacts(wd, "t_", os.path.join(GOLDEN, "out", name),
                                 "g_")
            ref = open(os.path.join(GOLDEN, "out", name, "log.txt")).read()
            log_ok = normalize_log(text) == normalize_log(ref)
            log("  %-6s %-10s %6.2f s  ran %-6s  launches %s  "
                "12 artifacts %s, log %s"
                % (engine, name, dt, asm.engine, counts,
                   "byte-equal" if not bad else "DIFFER %s" % bad,
                   "equal" if log_ok else "DIFFERS"))
            if bad or not log_ok:
                raise SystemExit("golden config %s differs on the card with "
                                 "the %s engine" % (name, engine))
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


def engine_run(torch, window_hash, args, workdir, engine, card):
    """One CLI run on cuda with the launch counters and the peak device
    memory reset just before it and read just after; prints its phase
    times.  Returns (Assembler, launches by kernel)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(window_hash)
    asm, _ = run_cli(args, workdir, engine)
    torch.cuda.synchronize()
    counts = read_counts(window_hash)
    peak = torch.cuda.max_memory_allocated()
    log("  %s engine (ran %s) [%s]: %d unique reads, launches %s, peak "
        "device memory %d bytes"
        % (engine, asm.engine, card, asm.dataset.number_of_unique_reads,
           counts, peak))
    for k, v in asm.timings.items():
        log("    %-32s %.6f s" % (k, v))
    if asm.engine in ("device", "hybrid") and \
            counts != dict.fromkeys(KERNELS, 1):
        raise SystemExit("the %s run launched %s, not each kernel once"
                         % (asm.engine, counts))
    return asm, counts


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


def main():
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        sys.stderr.write("chip_smoke: no CUDA device available\n")
        return 2
    sys.path.insert(0, REPO)
    from metagenomics_tpu_torch.ops import window_hash

    card = card_label()
    rng = np.random.default_rng(5)
    setup(torch, window_hash)
    err = kernel_check(torch, window_hash, rng)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        golden_phase(window_hash, tmp)
        records, by_path = real_size_phase(torch, window_hash, tmp, card)
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
