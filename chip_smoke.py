#!/usr/bin/env python3
"""On-card check of the PyTorch/CUDA port (metagenomics_tpu_torch).

Run from the root of a checkout on a machine with one NVIDIA Hopper card:

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught):
  1. setup: card name and power limit, torch/CUDA/nvcc versions, and the
     build of the window-hash kernel (csrc/window_hash.cu) from the sources;
  2. kernel check: the CUDA window hash is bit-equal to its plain PyTorch
     version (window_hashes_torch) on the card at the reference's test
     shapes, a long-read shape and both l extremes (phase 4 repeats the
     check on its first 4096 dataset rows and on its full code matrix);
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
     engine's.  Checks the kernel on that data set, then prints each run's
     phase times and peak device memory, the kernel's and the plain
     version's time at the main path's shape, each beside the card's name
     and power limit.

The kernel's launch counter is set to 0 just before each run of the CLI
and read just after it; a device or hybrid run (one that did not fall
back) that never launched the kernel fails the smoke.  The main path is
phase 4's `auto` (hybrid) run.  The last two lines are the kernels record
and {"ok": true, "device": ...}.  Exits non-zero without a result when no
CUDA device is available.
"""

import contextlib
import json
import os
import subprocess
import sys
import tempfile
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
    t0 = time.time()
    so = window_hash.build_library()
    window_hash._load()
    log("window_hash kernel built in %.3f s: %s"
        % (time.time() - t0, os.path.relpath(so, REPO)))
    # the native replay library, built here so no timed phase pays g++
    from metagenomics_tpu import native
    t0 = time.time()
    if native.get_lib() is None:
        raise SystemExit("the native replay library failed to build")
    log("native replay library ready in %.3f s" % (time.time() - t0))
    build_log = os.path.join(os.path.dirname(so), "build.log")
    if os.path.exists(build_log):
        for line in open(build_log).read().splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                log("  ptxas: %s" % line.strip())


def check_hashes(torch, window_hash, codes, l, label):
    """Kernel vs plain version on one CUDA tensor; returns max |err|."""
    got = window_hash.window_hashes_cuda(codes, l)
    torch.cuda.synchronize()
    want = window_hash.window_hashes_torch(codes, l)
    torch.cuda.synchronize()
    err = int((got - want).abs().max()) if got.numel() else 0
    same = torch.equal(got, want)
    log("  %-34s l=%-3d %s" % (label, l,
                                "bit-equal" if same else "MISMATCH"))
    if not same:
        raise SystemExit("window_hash kernel disagrees with its plain "
                         "version at %s (max abs err %d)" % (label, err))
    return err


def kernel_check(torch, window_hash, rng):
    log("== phase 2: kernel check (CUDA vs plain, exact equality)")
    err = 0
    for n, lmax, l in KERNEL_SHAPES:
        codes = torch.from_numpy(
            rng.integers(0, 5, (n, lmax)).astype("uint8")).cuda()
        err = max(err, check_hashes(torch, window_hash, codes, l,
                                    "random codes [%d, %d]" % (n, lmax)))
    return err


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


def golden_phase(window_hash, tmp):
    log("== phase 3: golden configs, device, hybrid and host engines on "
        "cuda")
    sys.path.insert(0, os.path.join(REPO, "tests"))
    from logutil import normalize_log
    launched = {}
    took = {}
    for engine in ("device", "hybrid", "host"):
        launched[engine] = 0
        for name, args in GOLDEN_CONFIGS.items():
            wd = os.path.join(tmp, "golden_%s_%s" % (engine, name))
            t0 = time.time()
            window_hash.launches = 0
            asm, text = run_cli(args, wd, engine)
            n = window_hash.launches
            dt = time.time() - t0
            bad = diff_artifacts(wd, "t_", os.path.join(GOLDEN, "out", name),
                                 "g_")
            ref = open(os.path.join(GOLDEN, "out", name, "log.txt")).read()
            log_ok = normalize_log(text) == normalize_log(ref)
            log("  %-6s %-10s %6.2f s  ran %-6s  window_hash launches %2d  "
                "12 artifacts %s, log %s"
                % (engine, name, dt, asm.engine, n,
                   "byte-equal" if not bad else "DIFFER %s" % bad,
                   "equal" if log_ok else "DIFFERS"))
            if bad or not log_ok:
                raise SystemExit("golden config %s differs on the card with "
                                 "the %s engine" % (name, engine))
            if asm.engine in ("device", "hybrid") and n <= 0:
                raise SystemExit("the %s run of %s never launched the "
                                 "kernel" % (asm.engine, name))
            if engine == "hybrid":
                took.setdefault(asm.engine, []).append(name)
            launched[engine] += n
    log("  hybrid path taken by: %s" % ", ".join(took.get("hybrid", [])))
    log("  fell back to the device pipeline: %s"
        % (", ".join(took.get("device", [])) or "none"))
    log("  window_hash launches in phase 3: %s" % launched)


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


def time_kernel(torch, window_hash, codes, l, reps=10):
    """Mean ms per call of the kernel and of the plain version on the same
    CUDA tensor, timed with CUDA events in turns plain, kernel, kernel,
    plain (after one warm-up call each)."""
    fns = {"cuda": window_hash.window_hashes_cuda,
           "plain": window_hash.window_hashes_torch}
    for fn in fns.values():
        fn(codes, l)
    torch.cuda.synchronize()
    total = {"cuda": 0.0, "plain": 0.0}
    for name in ("plain", "cuda", "cuda", "plain"):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fns[name](codes, l)
        stop.record()
        torch.cuda.synchronize()
        total[name] += start.elapsed_time(stop)
    return total["cuda"] / (2 * reps), total["plain"] / (2 * reps)


def engine_run(torch, window_hash, args, workdir, engine, card):
    """One CLI run on cuda with the launch counter and the peak device
    memory reset just before it and read just after; prints its phase
    times.  Returns (Assembler, launches)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    window_hash.launches = 0
    asm, _ = run_cli(args, workdir, engine)
    torch.cuda.synchronize()
    launches = window_hash.launches
    peak = torch.cuda.max_memory_allocated()
    log("  %s engine (ran %s) [%s]: %d unique reads, window_hash launches "
        "%d, peak device memory %d bytes"
        % (engine, asm.engine, card, asm.dataset.number_of_unique_reads,
           launches, peak))
    for k, v in asm.timings.items():
        log("    %-32s %.6f s" % (k, v))
    return asm, launches


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
    if launches <= 0:
        raise SystemExit("the main path never launched the kernel")
    by_path = {"hybrid": launches}
    ds = asm.dataset
    _, by_path["device"] = engine_run(torch, window_hash, args,
                                      os.path.join(tmp, "real_device"),
                                      "device", card)
    if by_path["device"] <= 0:
        raise SystemExit("the device engine never launched the kernel")
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
    # the first 4096 rows with codes masked to 2 bits: the input the TPU
    # kernel's own on-chip check used (TPU_KERNEL_CHECK.json), kept so the
    # two records compare; the full matrix below is the main path's input
    err = check_hashes(torch, window_hash,
                       torch.from_numpy(ds.codes_fwd[:4096] & 3).cuda(), l,
                       "dataset rows [4096, %d]" % ds.codes_fwd.shape[1])
    codes = torch.from_numpy(ds.codes_fwd).cuda()
    err = max(err, check_hashes(torch, window_hash, codes, l,
                                "dataset [%d, %d]" % tuple(codes.shape)))
    ms, plain_ms = time_kernel(torch, window_hash, codes, l)
    log("  window_hash at [%d, %d], l=%d [%s]: kernel %.6f ms, plain "
        "%.6f ms" % (codes.shape[0], codes.shape[1], l, card, ms,
                     plain_ms))
    return {"launches": launches, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "paths": sorted(by_path),
            "launches_by_path": by_path}


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
        record = real_size_phase(torch, window_hash, tmp, card)
    record["max_abs_err"] = max(err, record["max_abs_err"])
    if "jax" in sys.modules:
        raise SystemExit("the port imported jax")

    log(card)
    log(json.dumps({"kernels": [{
        "name": "window_hash", "route": "cuda",
        "source": "metagenomics_tpu_torch/csrc/window_hash.cu",
        "replaces": "metagenomics_tpu/ops/pallas_hash.py:56",
        **record}]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
