#!/usr/bin/env python3
"""On-card check of the PyTorch/CUDA port (metagenomics_tpu_torch).

Run from the root of a checkout on a machine with one NVIDIA Hopper card:

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught):
  1. setup: card name and power limit, torch/CUDA/nvcc versions, and the
     build of the window-hash kernels (csrc/window_hash.cu: window_hash
     and window_hash_at), of the setup_pack kernel (csrc/setup_pack.cu)
     and of the port's native library from the sources;
  2. kernel check: each CUDA kernel is bit-equal to its plain PyTorch
     version (window_hashes_torch, window_hashes_at_torch) on the card at
     the reference's test shapes, a long-read shape and both l extremes,
     window_hash_at in its standalone and its flagged form (phase 4
     repeats the checks on its full code matrix); starts -1 and
     lmax - l + 1 make the standalone form raise, and in the flagged form
     set the flag and give 0 there, the plain version's value elsewhere;
     the emit_verify kernel (csrc/emit_verify.cu, _emit2 on the card) is
     bit-equal to the plain _emit2_torch in the slots callers read (the
     first n_keep survivors, keep_counts, n_keep) in every mode, in both
     survivor layouts, at one length and mixed lengths, on all rows and
     on the hybrid's shard, on a later chunk of a multi-chunk plan and
     with spare slots past the total, and launches once under
     torch.cuda.set_sync_debug_mode("error"); the setup_pack kernel
     (csrc/setup_pack.cu, _setup_kernel's row packing on the card) is
     bit-equal to the plain _setup_pack_torch in its three outputs at
     w 10 and 19 with lmax off and at a multiple of 16, at the 4096
     length cap and at short rows, on packed reads of mixed lengths and on
     arbitrary words, and launches once under the sync debug mode
     "error"; then at each benchmark cell's shapes (its sample from
     omegabench/, the hybrid's shard and mode), where emit_verify and
     setup_pack are each timed in turns with their plain versions beside
     their bounds, and the share of slots whose rows emit_verify compares
     is printed (counted by the numpy model tests/emit_model.py);
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
     main path's shapes (window_hash also at l = 15 and 63; window_hash_at
     in the flagged form _setup_kernel uses, its standalone form beside
     it, after one flagged call under torch.cuda.set_sync_debug_mode
     ("error")) beside its bound and its share of the bound, with the
     card's name and power limit;
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
  6. entry(): entry() (metagenomics_tpu_torch/entry.py) on cuda equals
     the same call on the CPU, element for element;
  7. fuzz and scale: the port's fuzzer (measure/pipefuzz.py) in this
     process on seeds 7, 9 and 20 (random repeat-heavy sets of mixed read
     lengths) in each mode (se, pe, mix: a -pe and a -se file) under the
     device and hybrid engines on cuda:0, and one seed a mode under the
     sharded engine at (2, 2); every run's 11 artifacts and rc must equal
     the native engine's (native vs the reference binary is counted and
     printed); then measure/scale.py at 200,000 reads (native, auto,
     device, each a child process) must print equal artifacts, auto
     resolved to hybrid, a peak RSS and the device runs' peak device
     memory;
  8. recorder: a device-engine construction (golden pe_real through the
     CLI) under torch.profiler; the recorder's CLOCK and overlap.* spans
     must be annotations of the trace, the overlap.* ones inside
     buildOverlapGraphFromHashTable, every kernel, copy and set the
     construction ran must have been launched inside an overlap.*
     annotation, and every host-to-card copy inside overlap.upload.

Each kernel's launch counter is set to 0 just before each run of the CLI
and read just after it; a device or hybrid run (one that did not fall
back) that did not launch each kernel fails the smoke, and a se_1m device
or hybrid run must launch each exactly once, a sharded run exactly once a
shard (dp * ix; the dry run's sweep is checked in total), and phase 7's
fuzz runs once each a device or hybrid run and once a shard a sharded
run.  emit_verify's count is printed beside them (one a chunk); each
device or hybrid run of phase 4 must launch it, and launch setup_pack
exactly once (the sharded run never: its shards pack their own rows).  The main path is phase
4's `auto` (hybrid) run.  The smoke fails if jax or any module of the
JAX package (metagenomics_tpu) was imported.  The last two lines are the
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

# _emit2's modes (check_cont, dedup): stream(check_cont=False); stream()
# and stream_canon(True); the hybrid's canonical stream (one length); the
# hybrid's canonical stream with every containment hit (mixed lengths)
EMIT_MODES = [(False, False), (True, False), (False, True), (True, True)]

# the benchmark's samples for the emit_verify check at the cells' shapes
CELL_SEED = 3150000001

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
    from metagenomics_tpu_torch.ops import setup_pack
    t1 = time.time()
    pack_so = setup_pack.build_library()
    setup_pack._load()
    log("setup_pack kernel built in %.3f s: %s"
        % (time.time() - t1, os.path.relpath(pack_so, REPO)))
    g.join()
    if built["lib"] is None:
        raise SystemExit("the native replay library failed to build")
    log("native replay library ready in %.3f s" % built["s"])
    for lib in (so, pack_so):
        build_log = os.path.join(os.path.dirname(lib), "build.log")
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
    """window_hash_at vs window_hashes_at_torch on one CUDA tensor, in the
    standalone form (the wrapper reads its own range flag back) and in the
    flagged form the pipelines use (the caller's flag must stay 0)."""
    err = check_equal(
        torch, lambda: window_hash.window_hashes_at_cuda(codes, l, starts),
        lambda: window_hash.window_hashes_at_torch(codes, l, starts),
        "window_hash_at %s l=%d" % (label, l))
    bad = torch.zeros(1, dtype=torch.int32, device=codes.device)
    err = max(err, check_equal(
        torch,
        lambda: window_hash.window_hashes_at_cuda(codes, l, starts, bad),
        lambda: window_hash.window_hashes_at_torch(codes, l, starts),
        "window_hash_at flagged %s l=%d" % (label, l)))
    if bad.item():
        raise SystemExit("window_hash_at flagged in-range starts at %s"
                         % label)
    return err


def bad_start_check(torch, window_hash, rng):
    """Starts -1 and lmax - l + 1 on the card: the standalone wrapper
    raises; the flagged form sets the flag, gives 0 at those outputs and
    the plain version's value elsewhere (the plain version's flagged form
    agrees), and the card reports no fault."""
    n, lmax, l = 300, 100, 39
    codes = torch.from_numpy(
        rng.integers(0, 5, (n, lmax)).astype("uint8")).cuda()
    starts = torch.from_numpy(rng.integers(0, lmax - l + 1, (n, 2))).cuda()
    starts[5, 0] = -1
    starts[n - 1, 1] = lmax - l + 1
    raised = None
    try:
        window_hash.window_hashes_at_cuda(codes, l, starts)
    except ValueError as e:
        raised = str(e)
    if not raised or "out of range" not in raised:
        raise SystemExit("window_hash_at took bad starts without raising "
                         "(%r)" % raised)
    bad = torch.zeros(1, dtype=torch.int32, device=codes.device)
    got = window_hash.window_hashes_at_cuda(codes, l, starts, bad)
    torch.cuda.synchronize()
    plain_bad = torch.zeros_like(bad)
    want = window_hash.window_hashes_at_torch(codes, l, starts, plain_bad)
    good = (starts >= 0) & (starts <= lmax - l)
    gathered = torch.gather(window_hash.window_hashes_torch(codes, l), 1,
                            starts.clamp(0, lmax - l))
    ok = (bad.item() == 1 and plain_bad.item() == 1
          and torch.equal(got, want) and not got[~good].any()
          and torch.equal(got[good], gathered[good]))
    torch.cuda.synchronize()
    log("  %-52s %s" % ("window_hash_at starts -1 and lmax - l + 1",
                        "standalone raised (%s); flagged: flag set, 0 there, "
                        "plain's values elsewhere, no fault" % raised
                        if ok else "WRONG"))
    if not ok:
        raise SystemExit("window_hash_at's flagged form mishandled bad "
                         "starts: flag %d, got %s" % (bad.item(), got[~good]))


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
    bad_start_check(torch, window_hash, rng)
    stream_check(torch, window_hash)
    setup_pack_check(torch, rng)
    emit_check(torch)
    return err


def stream_check(torch, window_hash):
    """The stream handle the wrappers launch on (a private torch call) is
    the one torch.cuda.current_stream gives, on the default stream and
    inside another."""
    t = torch.zeros(1, device="cuda")
    for s in (torch.cuda.current_stream(), torch.cuda.Stream()):
        with torch.cuda.stream(s):
            got = window_hash._device_and_stream(t)
            want = (t.device.index, torch.cuda.current_stream().cuda_stream)
        if got != want:
            raise SystemExit("the wrappers' stream handle %s is not the "
                             "current stream's %s" % (got, want))
    log("  %-52s %s" % ("launch stream handle", "the current stream's, on "
                        "the default stream and another"))


def _quiet(*args, **kwargs):
    pass


def emit_args(p, check_cont, off_bits, uniform_len, chunk=0, cap=None):
    """The positional arguments of _emit2 on chunk `chunk` of pipeline p's
    plan (cap: the plan's unless given)."""
    pcap, nqt, chunks = p._plan_chunks()
    h0, nh = chunks[chunk]
    rk_pad, rleft_pad, rcnt_pad = p._padded(nqt)
    return (p.packed2, p.lengths, rk_pad, rleft_pad, rcnt_pad, p.sid, h0, nh,
            p.row0, p.hash_len, nqt, cap or pcap, p.npos, p.w, p.qw_max,
            check_cont, off_bits, uniform_len)


def emit_equal(torch, args, dedup, label):
    """The emit_verify kernel (_emit2 on CUDA tensors) vs the plain
    _emit2_torch on the same arguments: the first n_keep survivors (words,
    or r2 and meta), keep_counts and n_keep must be bit-equal.  Returns
    n_keep."""
    from metagenomics_tpu_torch.ops import device_overlap as dov
    got = dov._emit2(*args, dedup=dedup)
    want = dov._emit2_torch(*args, dedup=dedup)
    torch.cuda.synchronize()
    nk = int(want[2])
    gout, wout = got[0], want[0]
    if not isinstance(gout, tuple):
        gout, wout = (gout,), (wout,)
    same = (int(got[2]) == nk and got[1].dtype == want[1].dtype
            and torch.equal(got[1], want[1])
            and all(g.dtype == w.dtype and torch.equal(g[:nk], w[:nk])
                    for g, w in zip(gout, wout)))
    log("  %-64s %s" % (label, "bit-equal (%d survivors)" % nk if same
                        else "MISMATCH"))
    if not same:
        raise SystemExit("emit_verify disagrees with the plain _emit2 at %s "
                         "(n_keep %d vs %d)" % (label, int(got[2]), nk))
    return nk


def emit_check(torch):
    """Phase 2's emit_verify check on the golden sets: every mode, both
    survivor layouts, one length (se_small) and mixed lengths (se_mixlen),
    all rows and the hybrid's shard of the top tenth; a later chunk of a
    multi-chunk plan; spare slots past the total; one launch under the
    sync debug mode "error"."""
    from metagenomics_tpu_torch.dataset import Dataset
    from metagenomics_tpu_torch.ops import device_overlap as dov
    from metagenomics_tpu_torch.ops import emit_verify
    cuda = torch.device("cuda", 0)
    emit_verify.launches = 0
    calls = 0
    for name in ("se_small", "se_mixlen"):
        ds = Dataset([], _data(name + ".fasta"), MIN_OVERLAP, log=_quiet)
        n = ds.number_of_unique_reads
        for row_lo in (0, 1 + int(0.9 * n)):
            p = dov.DeviceOverlapPipeline(ds, MIN_OVERLAP, row_lo=row_lo,
                                          device=cuda)
            lens = ("one length %d" % p.uniform_len if p.uniform_len >= 0
                    else "mixed lengths")
            for cc, dd in EMIT_MODES:
                for ob in (p.off_bits, -1):
                    emit_equal(torch, emit_args(p, cc, ob, p.uniform_len), dd,
                               "emit_verify %s rows >= %d, %s, cont %d dedup "
                               "%d, %s" % (name, row_lo, lens, cc, dd,
                                           "words" if ob >= 0
                                           else "(r2, meta)"))
                    calls += 1
    p = dov.DeviceOverlapPipeline(ds, MIN_OVERLAP, device=cuda)
    cap = p._plan_chunks()[0]
    emit_equal(torch, emit_args(p, True, p.off_bits, -1, cap=4 * cap), True,
               "emit_verify se_mixlen, cap %d, 4x the plan's" % (4 * cap))
    calls += 1
    ds = Dataset([], _data("se_small.fasta"), MIN_OVERLAP, log=_quiet)
    old = dov.DeviceOverlapPipeline.MAX_CAP
    try:
        dov.DeviceOverlapPipeline.MAX_CAP = 1 << 14
        p = dov.DeviceOverlapPipeline(ds, MIN_OVERLAP, device=cuda)
        chunks = p._plan_chunks()[2]
        if len(chunks) < 2:
            raise SystemExit("se_small's plan at MAX_CAP 2^14 has one chunk")
        for i in range(1, len(chunks)):
            for cc, dd in EMIT_MODES:
                emit_equal(torch, emit_args(p, cc, p.off_bits, p.uniform_len,
                                            chunk=i), dd,
                           "emit_verify se_small chunk %d of %d (h0 %d), cont "
                           "%d dedup %d" % (i, len(chunks), chunks[i][0], cc,
                                            dd))
                calls += 1
    finally:
        dov.DeviceOverlapPipeline.MAX_CAP = old
    args = emit_args(p, True, p.off_bits, -1)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        emit_verify.emit2_cuda(*args, dedup=True)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    calls += 1
    log("  emit_verify under set_sync_debug_mode(\"error\"): no "
        "synchronising operation")
    if emit_verify.launches != calls:
        raise SystemExit("emit_verify launched %d times for %d calls"
                         % (emit_verify.launches, calls))
    log("  emit_verify launches: %d, one a call" % calls)


def pack_equal(torch, pf, w, wp, lmax, label):
    """The setup_pack kernel vs the plain _setup_pack_torch on the same
    CUDA words: codes_fwd, flipped and packed2 must be bit-equal."""
    from metagenomics_tpu_torch.ops import device_overlap as dov
    from metagenomics_tpu_torch.ops import setup_pack
    got = setup_pack.setup_pack_cuda(pf, w, wp, lmax)
    want = dov._setup_pack_torch(pf, w, wp, lmax)
    torch.cuda.synchronize()
    same = all(g.dtype == e.dtype and g.shape == e.shape
               and torch.equal(g, e) for g, e in zip(got, want))
    log("  %-64s %s" % (label, "bit-equal" if same else "MISMATCH"))
    if not same:
        raise SystemExit("setup_pack disagrees with the plain version at %s "
                         "(equal: %s)" % (label, [torch.equal(g, e)
                                                  for g, e in zip(got, want)]))
    return got


def setup_pack_check(torch, rng):
    """Phase 2's setup_pack check: every shape of tests/setup_pack_model.py
    on packed reads and on arbitrary words; one launch under the sync
    debug mode "error"; one launch a call."""
    import setup_pack_model
    from metagenomics_tpu_torch.ops import setup_pack
    setup_pack.launches = 0
    calls = 0
    for rows, lmax, w in setup_pack_model.SHAPES:
        wp = setup_pack_model.spill_width(lmax, w)
        for full in (False, True):
            pf = torch.from_numpy(setup_pack_model.words(
                rng, rows, lmax, w, full).astype("int64")).cuda()
            pack_equal(torch, pf, w, wp, lmax,
                       "setup_pack [%d, %d] words, lmax %d, wp %d, %s"
                       % (rows, w, lmax, wp, "arbitrary words" if full
                          else "mixed lengths"))
            calls += 1
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        setup_pack.setup_pack_cuda(pf, w, wp, lmax)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    calls += 1
    log("  setup_pack under set_sync_debug_mode(\"error\"): no "
        "synchronising operation")
    if setup_pack.launches != calls:
        raise SystemExit("setup_pack launched %d times for %d calls"
                         % (setup_pack.launches, calls))
    log("  setup_pack launches: %d, one a call" % calls)


def pack_cell(torch, ds, p, name, card):
    """setup_pack at one cell's shapes: the cell's uploaded words, the
    kernel bit-equal to the plain version and to the pipeline's packed2,
    both timed in turns on the card alone beside the bound (the words
    read once, the three outputs written once, at the data sheet's
    rate).  Returns the record."""
    from metagenomics_tpu_torch.ops import device_overlap as dov
    from metagenomics_tpu_torch.ops import setup_pack
    cuda = torch.device("cuda", 0)
    pf = dov._upload_words(dov.pack_codes_host(ds.codes_fwd), cuda)
    n1, w = pf.shape
    args = (pf, p.w, p.wp, p.lmax)
    got = pack_equal(torch, *args, "setup_pack %s: [%d, %d] words, lmax %d, "
                     "wp %d" % (name, n1, w, p.lmax, p.wp))
    if not torch.equal(got[2], p.packed2):
        raise SystemExit("setup_pack's packed2 is not the pipeline's at %s"
                         % name)
    ms = device_turns(torch, {
        "plain": lambda: dov._setup_pack_torch(*args),
        "kernel": lambda: setup_pack.setup_pack_cuda(*args)}, 20)
    nbytes = n1 * w * 8 + 2 * n1 * p.lmax + 2 * n1 * p.wp * 8
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    log("    [%s] kernel %.6f ms, plain %.6f ms, bound %.6f ms (%d bytes), "
        "kernel at %.3f%% of the bound" % (
            card, ms["kernel"], ms["plain"], bound_ms, nbytes,
            100 * bound_ms / ms["kernel"]))
    return {"cell": name, "n1": n1, "w": w, "wp": p.wp, "lmax": p.lmax,
            "ms": ms["kernel"], "plain_ms": ms["plain"],
            "bound_ms": bound_ms, "bytes": nbytes}


def cell_checks(torch, tmp, card):
    """emit_verify and setup_pack at the benchmark cells' shapes: each
    cell's sample (seed CELL_SEED) as its construction loads it, the
    hybrid's device shard (rows above nine tenths) and mode; emit_verify
    bit-equal to the plain _emit2, both timed in turns on the card alone
    (device_turns) beside the bound (omegabench.stages.stage_bytes' least
    bytes at the data sheet's rate), and the share of slots whose rows
    the kernel compares (from tests/emit_model.py, a numpy model of the
    kernel, on the host); setup_pack as pack_cell says.  Returns one
    record a cell for each kernel."""
    import emit_model
    from omegabench import generator, layout, stages
    from metagenomics_tpu_torch.dataset import Dataset
    from metagenomics_tpu_torch.ops import device_overlap as dov
    cuda = torch.device("cuda", 0)
    spec = layout.benchmark(REPO)
    out = []
    packs = []
    for w in spec["workloads"]:
        cell = layout.Cell(w["name"], spec)
        cdir = os.path.join(tmp, "cell_" + w["name"])
        os.makedirs(cdir)
        t0 = time.time()
        paths, _ = generator.write_sample(cell.config, cell.traffic,
                                          CELL_SEED, cdir)
        ds = Dataset(paths, [], cell.config["min_overlap"], log=_quiet)
        n = ds.number_of_unique_reads
        row_lo = max(1, min(n + 1, 1 + int(n * 0.9)))
        p = dov.DeviceOverlapPipeline(ds, cell.config["min_overlap"],
                                      row_lo=row_lo, device=cuda)
        cc = p.uniform_len < 0
        cap, _, chunks = p._plan_chunks()
        if len(chunks) != 1:
            raise SystemExit("%s plans %d chunks" % (w["name"], len(chunks)))
        args = emit_args(p, cc, p.off_bits, p.uniform_len)
        label = ("%s: %d unique reads, rows >= %d, %d hits, %d candidates, "
                 "cap %d, w %d" % (w["name"], n, row_lo, p.h_total, p.grand,
                                   cap, p.w))
        nk = emit_equal(torch, args, True, label)
        ms = device_turns(torch, {
            "plain": lambda: dov._emit2_torch(*args, dedup=True),
            "kernel": lambda: dov._emit2(*args, dedup=True)}, 5)
        host = [a.cpu().numpy() if hasattr(a, "cpu") else a
                for a in args[:6]]
        _, _, mnk, compared = emit_model.emit2(
            *host, *args[6:10], cap, *args[12:], True)
        if mnk != nk:
            raise SystemExit("the model kept %d at %s, the kernel %d"
                             % (mnk, w["name"], nk))
        nbytes = stages.stage_bytes({
            "n1": int(p.hf.shape[0]), "row0": p.row0, "w": p.w,
            "npos": p.npos, "h_total": p.h_total,
            "survivors": nk})["emit_verify"]
        bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
        rec = {"cell": w["name"], "unique_reads": n, "row_lo": row_lo,
               "h_total": p.h_total, "candidates": p.grand, "cap": cap,
               "survivors": nk, "compared": compared,
               "compared_pct": 100 * compared / max(p.grand, 1),
               "ms": ms["kernel"], "plain_ms": ms["plain"],
               "bound_ms": bound_ms, "bytes": nbytes}
        log("    [%s] kernel %.6f ms, plain %.6f ms, bound %.6f ms (%d "
            "bytes), kernel at %.3f%% of the bound; rows compared in %d of "
            "%d candidate slots (%.2f%%); %.1f s" % (
                card, ms["kernel"], ms["plain"], bound_ms, nbytes,
                100 * bound_ms / ms["kernel"], compared, p.grand,
                rec["compared_pct"], time.time() - t0))
        out.append(rec)
        packs.append(pack_cell(torch, ds, p, w["name"], card))
        del p, args
        torch.cuda.empty_cache()
    return out, packs


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
    from metagenomics_tpu_torch.ops import emit_verify, setup_pack
    window_hash.launches = 0
    window_hash.at_launches = 0
    emit_verify.launches = 0
    setup_pack.launches = 0


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


def device_turns(torch, fns, reps=20):
    """Mean device ms per call of each no-argument fn, in turns as
    time_turns, each batch queued behind a 0.1 s sleep kernel so that
    the events time the card alone, not the host's launches."""
    for fn in fns.values():
        fn()
    torch.cuda.synchronize()
    names = list(fns)
    total = dict.fromkeys(names, 0.0)
    for name in names + names[::-1]:
        torch.cuda._sleep(100_000_000)
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
    from metagenomics_tpu_torch.ops import emit_verify, setup_pack
    emits = emit_verify.launches
    packs = setup_pack.launches
    peak = torch.cuda.max_memory_allocated()
    log("  %s engine (ran %s) [%s]: %d unique reads, launches %s, "
        "emit_verify %d, setup_pack %d, peak device memory %d bytes"
        % (engine, asm.engine, card, asm.dataset.number_of_unique_reads,
           counts, emits, packs, peak))
    if asm.engine in ("device", "hybrid") and emits < 1:
        raise SystemExit("the %s run did not launch emit_verify"
                         % asm.engine)
    if packs != (1 if asm.engine in ("device", "hybrid") else 0):
        raise SystemExit("the %s run launched setup_pack %d times"
                         % (asm.engine, packs))
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
    """Time the kernel's wrapper vs the plain version (and, where fns has
    it, the wrapper's standalone form) in turns; print each beside the
    bound and the kernel's share of it."""
    ms = time_turns(torch, fns, reps)
    log("  %s [%s]: plain %.6f ms, kernel %.6f ms, bound %.6f ms (%s: %d "
        "bytes), kernel at %.1f%% of the bound"
        % (label, card, ms["plain"], ms["kernel"], bound_ms, bound_by,
           nbytes, 100 * bound_ms / ms["kernel"]))
    rec = {"ms": ms["kernel"], "plain_ms": ms["plain"],
           "bound_ms": bound_ms, "bound_by": bound_by}
    if "standalone" in ms:
        log("    standalone form (reads its flag back) [%s]: %.6f ms, %.1f%% "
            "of the bound" % (card, ms["standalone"],
                              100 * bound_ms / ms["standalone"]))
        rec["standalone_ms"] = ms["standalone"]
    return rec


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
    rev = flipped[1:]
    err["window_hash_at"] = check_at(
        torch, window_hash, rev, l, starts,
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

    # window_hash_at as _setup_kernel calls it: the caller's zeroed flag,
    # no read-back.  One call first under the sync debug mode "error": any
    # synchronising operation before or around the launch raises
    bad = torch.zeros(1, dtype=torch.int32, device=codes.device)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        window_hash.window_hashes_at_cuda(rev, l, starts, bad)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    log("  window_hash_at flagged call under set_sync_debug_mode(\"error\"): "
        "no synchronising operation")
    plain_bad = torch.zeros_like(bad)
    bound_ms, bound_by, nbytes = at_bound(torch, starts, l)
    at = timed_record(
        torch,
        {"plain": lambda: window_hash.window_hashes_at_torch(rev, l, starts,
                                                             plain_bad),
         "kernel": lambda: window_hash.window_hashes_at_cuda(rev, l, starts,
                                                             bad),
         "standalone": lambda: window_hash.window_hashes_at_cuda(rev, l,
                                                                 starts)},
        20, bound_ms, bound_by, nbytes,
        "window_hash_at (flagged) at [%d, %d] x [%d, 2], l=%d"
        % (rows - 1, lmax, rows - 1, l), card)
    torch.cuda.synchronize()
    if bad.item() or plain_bad.item():
        raise SystemExit("window_hash_at flagged the main path's starts")
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


def entry_phase(torch):
    """Phase 6: entry() on cuda equals the same call on the CPU."""
    from metagenomics_tpu_torch.entry import entry
    log("== phase 6: entry() on cuda vs the CPU")
    fn, args = entry(torch.device("cuda", 0))
    got = fn(*args).cpu()
    fn, args = entry("cpu")
    want = fn(*args)
    log("  %d of %d pairs verified on both, %s"
        % (int(got.sum()), got.numel(),
           "equal" if torch.equal(got, want) else "DIFFERENT"))
    if not torch.equal(got, want):
        raise SystemExit("entry() on cuda differs from the CPU call")


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


PIPELINE_SPANS = ("overlap.pipeline", "overlap.upload", "overlap.stream",
                  "overlap.emit", "overlap.fetch")


def recorder_phase(torch, tmp):
    """Phase 8: the recorder's spans in a profiler trace, around the
    device work they launched."""
    from torch.profiler import ProfilerActivity, profile
    log("== phase 8: the recorder's spans in a profiler trace")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run_cli(GOLDEN_CONFIGS["pe_real"], os.path.join(tmp, "recorder"),
                "device")
        torch.cuda.synchronize()
    path = os.path.join(tmp, "recorder_trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X"]

    def within(e, a):
        return a["ts"] <= e["ts"] and \
            e["ts"] + e.get("dur", 0) <= a["ts"] + a["dur"]

    ann = {}
    for e in events:
        if e.get("cat") == "user_annotation":
            ann.setdefault(e["name"], []).append(e)
    missing = [n for n in ("buildOverlapGraphFromHashTable",)
               + PIPELINE_SPANS if n not in ann]
    if missing:
        raise SystemExit("the trace lacks the spans %s" % missing)
    build, = ann["buildOverlapGraphFromHashTable"]
    spans = [a for n in PIPELINE_SPANS for a in ann[n]]
    if not all(within(a, build) for a in spans):
        raise SystemExit("an overlap.* span lies outside the construction")
    launch = {e["args"]["correlation"]: e for e in events
              if e.get("cat") == "cuda_runtime"
              and "correlation" in e.get("args", {})}
    work = [(e, launch.get(e.get("args", {}).get("correlation")))
            for e in events
            if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    ours = [(e, l) for e, l in work if l is not None and within(l, build)]
    stray = sorted({e["name"] for e, l in ours
                    if not any(within(l, a) for a in spans)})
    h2d = [(e, l) for e, l in ours if "HtoD" in e["name"]]
    stray_h2d = [e["name"] for e, l in h2d
                 if not any(within(l, a) for a in ann["overlap.upload"])]
    log("  spans in the trace: %s; %d kernels, copies and sets launched in "
        "the construction (%d unmatched to a launch), %d outside an "
        "overlap.* span; %d host-to-card copies, %d outside overlap.upload; "
        "%d device-side annotations" % (
            {n: len(ann[n]) for n in PIPELINE_SPANS}, len(ours),
            sum(l is None for _, l in work), len(stray), len(h2d),
            len(stray_h2d), sum(e.get("cat") == "gpu_user_annotation"
                                for e in events)))
    if not ours or stray or not h2d or stray_h2d:
        raise SystemExit("device work outside its span: %s %s (copies in "
                         "the trace: %s)" % (stray, stray_h2d, sorted(
                             {e["name"] for e, _ in work
                              if e.get("cat") == "gpu_memcpy"})))


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
        cells, pack_cells = cell_checks(torch, tmp, card)
        golden_phase(window_hash, tmp)
        records, by_path = real_size_phase(torch, window_hash, tmp, card)
        by_path["sharded"] = sharded_phase(torch, window_hash, tmp, card)
        entry_phase(torch)
        by_path["fuzz"] = fuzz_phase(torch, window_hash, card)
        recorder_phase(torch, tmp)
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
    kernels.append({
        "name": "emit_verify", "route": "cuda",
        "source": "metagenomics_tpu_torch/csrc/emit_verify.cu",
        "replaces": None, "replaces_ops":
            "metagenomics_tpu/ops/device_overlap.py:445 (_emit2, XLA ops)",
        "max_abs_err": 0, "cells": cells})
    kernels.append({
        "name": "setup_pack", "route": "cuda",
        "source": "metagenomics_tpu_torch/csrc/setup_pack.cu",
        "replaces": None, "replaces_ops":
            "metagenomics_tpu/ops/device_overlap.py:329-341 (_setup_kernel's "
            "rows, XLA ops)",
        "max_abs_err": 0, "cells": pack_cells})
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
