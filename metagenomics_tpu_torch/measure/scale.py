"""Real-size run of the port: wall time, peak RSS and peak device memory
of the full CLI on the 10M-read set, each engine against the native one
(the counterpart of tools/measure_scale.py).

    python -m metagenomics_tpu_torch.measure.scale [--n-reads N]
        [--skip-reference] [--engines native,auto,device[,sharded]]

The data set is tools/measure_scale.gen_data(N)'s, byte for byte (seed 11,
a 5N-base genome, 100 bp reads on random strands), written to
bench_data/scale_se.fasta unless that file's first line is already
`>r0_<N>`; write_first_reads also writes the first n reads of a larger
set without the rest.  Each engine runs the port's CLI (`-se 1 <data>
-f t_ -l 40`) in a child process of its own under MGTPU_OVERLAP_ENGINE,
and each run records its wall seconds, its phase times, its peak RSS
(VmHWM polled, or VmRSS where /proc has no VmHWM), the child's own
torch.cuda.max_memory_allocated() and max_memory_reserved() per card, the
engine that ran, its rc and, on a failure, the last line of its stderr
(an out-of-memory error, say).  `auto` is hybrid on one card, which runs
the device pipeline where a read id, 4 flags and an offset overflow one
32-bit word (above 2^22 unique reads of 100 bp at -l 40), and sharded on
several.  Engines default to native,auto,device, plus sharded over every
card where several are visible; native always runs, first.  The 7
artifacts of ARTS of every engine are compared with native's, and, unless
--skip-reference, native's with the reference binary's.  Runs on cuda
unless MGTPU_TORCH_DEVICE=cpu; asked for cuda with no card present, it
raises.  Prints one JSON object and writes no result file; exits non-zero
if an engine fails or differs from native.
"""

import argparse
import filecmp
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DATA_DIR = os.path.join(REPO, "bench_data")
DATA = os.path.join(DATA_DIR, "scale_se.fasta")
REF = os.path.join(REPO, "golden", "metagenomics_ref_O0")
ARTS = ["contigs1.fasta", "contigs2.fasta", "contigs3.fasta",
        "contigs4.fasta", ".unitig", "_sortedReads.fasta", "_flow.output"]
N_READS = 10_000_000
CHILD_TAG = "SCALE_CHILD "
CHILD_TIMEOUT_S = 7200
# tools/measure_scale.gen_data's parameters
SEED = 11
READ_LEN = 100
BLOCK = 1 << 18


def card_label():
    """`nvidia-smi --query-gpu=name,power.limit` of the first card."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()
    return out[0].strip()


def write_first_reads(path, n_total, n):
    """The first n reads of tools/measure_scale.gen_data(n_total), byte
    for byte.  gen_data draws the genome and all n_total starts first,
    then one flip vector per BLOCK reads, so n reads need only the first
    ceil(n / BLOCK) blocks' flips."""
    rng = np.random.default_rng(SEED)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    comp = np.zeros(256, np.uint8)
    for k, v in zip(b"ACGT", b"TGCA"):
        comp[k] = v
    glen = n_total * 5
    genome = bases[rng.integers(0, 4, glen)]
    starts = rng.integers(0, glen - READ_LEN + 1, n_total)
    tmp = "%s.%d.tmp" % (path, os.getpid())
    with open(tmp, "wb") as f:
        for s in range(0, n, BLOCK):
            flip = rng.random(min(s + BLOCK, n_total) - s) < 0.5
            e = min(s + BLOCK, n)
            block = genome[starts[s:e, None] + np.arange(READ_LEN)[None, :]]
            block = np.where(flip[:e - s, None], comp[block[:, ::-1]], block)
            f.write(b"".join(
                (b">r%d_%d\n" % (s + t, n_total) if s + t == 0
                 else b">r%d\n" % (s + t)) + block[t].tobytes() + b"\n"
                for t in range(e - s)))
    os.replace(tmp, path)


def gen_data(n_reads):
    """tools/measure_scale.gen_data(n_reads): the same bytes into DATA,
    kept where its first line is already >r0_<n_reads>."""
    if os.path.exists(DATA):
        with open(DATA) as f:
            if f.readline() == ">r0_%d\n" % n_reads:
                return
    os.makedirs(os.path.dirname(DATA), exist_ok=True)
    write_first_reads(DATA, n_total=n_reads, n=n_reads)


def _rss_kb(pid):
    """The process's peak RSS so far in kB: VmHWM from /proc/<pid>/status,
    or VmRSS on hosts whose /proc has no VmHWM (the largest of the polled
    values is then the peak); 0 once the process is gone."""
    fields = {}
    try:
        with open("/proc/%d/status" % pid) as f:
            for line in f:
                key, _, value = line.partition(":")
                if key in ("VmHWM", "VmRSS"):
                    fields[key] = int(value.split()[0])
    except OSError:
        pass
    return fields.get("VmHWM", fields.get("VmRSS", 0))


def run_timed(cmd, cwd, env, timeout):
    """Run cmd with stdout and stderr to files in cwd; (rc, wall seconds,
    peak RSS in bytes, polled every 0.1 s).  wait4's ru_maxrss would not
    do: a child spawned by a large parent inherits the parent's peak."""
    t0 = time.time()
    with open(os.path.join(cwd, "stdout.txt"), "wb") as out, \
            open(os.path.join(cwd, "stderr.txt"), "wb") as err:
        proc = subprocess.Popen(cmd, cwd=cwd, env=env, stdout=out,
                                stderr=err)
    peak_kb = 0
    try:
        while proc.poll() is None:
            peak_kb = max(peak_kb, _rss_kb(proc.pid))
            if time.time() - t0 > timeout:
                raise subprocess.TimeoutExpired(cmd, timeout)
            time.sleep(0.1)
    except BaseException:
        proc.kill()
        proc.wait()
        raise
    return proc.returncode, time.time() - t0, 1024 * peak_kb


def _tail(path, prefix=""):
    """The last non-empty line of a file that starts with prefix, or
    None."""
    with open(path, errors="replace") as f:
        lines = [ln.rstrip("\n") for ln in f if ln.strip()]
    hits = [ln for ln in lines if ln.startswith(prefix)]
    return hits[-1] if hits else None


def run_engine(engine, workdir, device):
    """The CLI under `engine` in a child process; its record."""
    os.makedirs(workdir)
    env = dict(os.environ, MGTPU_OVERLAP_ENGINE=engine,
               MGTPU_TORCH_DEVICE=str(device))
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    rc, wall, rss = run_timed(
        [sys.executable, "-m", "metagenomics_tpu_torch.measure.scale",
         "--child", "-se", "1", DATA, "-f", "t_", "-l", "40"],
        workdir, env, CHILD_TIMEOUT_S)
    rec = {"rc": rc, "wall_s": wall, "peak_rss_bytes": rss}
    line = _tail(os.path.join(workdir, "stdout.txt"), CHILD_TAG)
    if rc == 0 and line is not None:
        rec.update(json.loads(line[len(CHILD_TAG):]))
        if rec["max_memory_allocated"] is not None:
            rec["device_bytes_per_unique_read"] = (
                rec["max_memory_allocated"] / rec["n_unique_reads"])
    else:
        rec["error"] = _tail(os.path.join(workdir, "stderr.txt"))
    return rec


def child(argv):
    """The CLI on argv, then one tagged line: the engine that ran, the
    unique reads, the phase times (Assembler.timings) and each card's peak
    device memory (None on the CPU)."""
    import torch
    from .. import cli
    asm = cli.main(["cli", *argv])
    cards = ([{"device": k,
               "max_memory_allocated": torch.cuda.max_memory_allocated(k),
               "max_memory_reserved": torch.cuda.max_memory_reserved(k)}
              for k in range(torch.cuda.device_count())]
             if torch.cuda.is_initialized() else [])
    print(CHILD_TAG + json.dumps({
        "engine": asm.engine,
        "n_unique_reads": asm.dataset.number_of_unique_reads,
        "timings": asm.timings,
        "max_memory_allocated": max(
            (c["max_memory_allocated"] for c in cards), default=None),
        "max_memory_reserved": max(
            (c["max_memory_reserved"] for c in cards), default=None),
        "cards": cards}), flush=True)


def parse_args(argv):
    ap = argparse.ArgumentParser(
        prog="python -m metagenomics_tpu_torch.measure.scale")
    ap.add_argument("--n-reads", type=int, default=N_READS)
    ap.add_argument("--skip-reference", action="store_true")
    ap.add_argument("--engines", default=None,
                    help="comma list of native, auto, device, hybrid, host "
                         "and sharded (native,auto,device, and sharded "
                         "where several cards are visible)")
    return ap.parse_args(argv)


def measure(n_reads, engines, skip_reference, log):
    """Every engine on the n_reads set; the result the tool prints."""
    import torch
    from ..ops.device_overlap import torch_device
    device = torch_device()
    cards = torch.cuda.device_count() if device.type == "cuda" else 0
    if engines is None:
        engines = ["native", "auto", "device"] + (["sharded"] if cards > 1
                                                  else [])
    engines = ["native"] + [e for e in engines if e != "native"]
    t0 = time.time()
    gen_data(n_reads)
    log("data: %d reads in %s (%.1f s)" % (n_reads, DATA, time.time() - t0))
    result = {"tool": "scale", "n_reads": n_reads, "device": str(device),
              "card": card_label() if cards else None, "cards": cards,
              "engines": {}, "reference_O0": None}
    with tempfile.TemporaryDirectory(dir=os.path.dirname(DATA),
                                     prefix="scale_runs_") as td:
        def prefix(name):
            return os.path.join(td, name, "t_")
        for engine in engines:
            rec = run_engine(engine, os.path.join(td, engine), device)
            if engine != "native" and rec["rc"] == 0 and \
                    result["engines"]["native"]["rc"] == 0:
                rec["artifacts_differing"] = [
                    a for a in ARTS if not filecmp.cmp(
                        prefix(engine) + a, prefix("native") + a,
                        shallow=False)]
            if engine != "native":
                # at 10M reads an engine's files take gigabytes
                shutil.rmtree(os.path.join(td, engine))
            result["engines"][engine] = rec
            log("%s: %s" % (engine, json.dumps(rec)))
        if not skip_reference and os.path.exists(REF):
            wd = os.path.join(td, "reference")
            os.makedirs(wd)
            rc, wall, rss = run_timed(
                [REF, "-se", "1", DATA, "-f", "t_", "-l", "40"], wd,
                dict(os.environ), 8 * CHILD_TIMEOUT_S)
            ref = {"rc": rc, "wall_s": wall, "peak_rss_bytes": rss}
            if rc == 0 and result["engines"]["native"]["rc"] == 0:
                ref["native_artifacts_differing"] = [
                    a for a in ARTS if not filecmp.cmp(
                        prefix("reference") + a, prefix("native") + a,
                        shallow=False)]
            result["reference_O0"] = ref
            log("reference: %s" % json.dumps(ref))
    result["ok"] = all(rec["rc"] == 0 and not rec.get("artifacts_differing")
                       for rec in result["engines"].values())
    return result


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["--child"]:
        return child(argv[1:])
    args = parse_args(argv)
    engines = args.engines.split(",") if args.engines else None
    result = measure(args.n_reads, engines, args.skip_reference,
                     lambda msg: print(msg, file=sys.stderr, flush=True))
    print(json.dumps(result), flush=True)
    if not result["ok"]:
        raise SystemExit("an engine failed or differs from native")
    return result


if __name__ == "__main__":
    main()
