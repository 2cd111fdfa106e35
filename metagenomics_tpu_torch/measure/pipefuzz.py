"""Full-pipeline fuzzer of the port: random repeat-heavy data sets through
the port's CLI under the native engine and under each card engine, every
staged artifact byte-compared (the counterpart of tools/pipefuzz.py).

    python -m metagenomics_tpu_torch.measure.pipefuzz [seeds...]

Seeds default to 1..40.  Environment, read as tools/pipefuzz.py reads it:

  FUZZ_MODE    se (default), pe (interleaved mate pairs) or mix (a -pe and
               a -se file from one seed and one genome, so reads contain
               and overlap each other across the two data sets)
  FUZZ_L       the minimum overlap, -l (40)
  FUZZ_ENGINE  a comma list of device, hybrid and sharded (device,hybrid)

Every read's length is drawn from {60, 70, 80, 90, 100}, so each seed runs
the mixed-length path, and planted tandem and dispersed repeats drive
flow > 1, self-loops and the late merges.  For each seed the CLI runs in
this process (so the window-hash kernels' launches are counted) under the
native engine and under each listed engine; the 11 artifacts of ARTS and
the return codes of each engine must equal native's, and any difference
fails the run.  `sharded` runs a (2, 2) mesh on cuda:0 on one card, and a
mesh of one shard per card where several are visible.  Where the reference
binary (golden/metagenomics_ref_O0) runs on this host, native's artifacts
are also compared with the binary's: a difference there is the graph
layer's known deviation (ROUND5.md), counted and printed, not a failure.

The engines run on cuda unless MGTPU_TORCH_DEVICE=cpu, where the kernels'
plain versions run; asked for cuda with no card present, the tool raises.
Progress goes to stderr; the last line of stdout is one JSON object.
"""

import contextlib
import json
import os
import random
import shutil
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
REF = os.path.join(REPO, "golden", "metagenomics_ref_O0")
ARTS = [".unitig", "_flow.input", "graph1.gdl", "contigs1.fasta",
        "graph2.gdl", "contigs2.fasta", "graph3.gdl", "contigs3.fasta",
        "graph4.gdl", "contigs4.fasta", "_sortedReads.fasta"]
COMP = {"A": "T", "C": "G", "G": "C", "T": "A"}
MODES = ("se", "pe", "mix")
ENGINES = ("device", "hybrid", "sharded")
KERNELS = ("window_hash", "window_hash_at")


def _write_reads(seed, path, pe):
    """tools/pipefuzz.gen(seed, path) with FUZZ_MODE=pe when `pe`."""
    rng = random.Random(seed)
    n_rep = rng.randint(1, 3)
    glen = rng.randint(4000, 8000)
    g = [rng.choice("ACGT") for _ in range(glen)]
    # plant tandem/dispersed repeats (induce self-loops + flow>1 edges)
    for _ in range(n_rep):
        rl = rng.randint(150, 400)
        s = rng.randint(0, glen - rl - 1)
        seg = g[s:s + rl]
        if rng.random() < 0.5:
            # tandem: duplicate in place
            g[s + rl:s + rl] = list(seg)
        else:
            d = rng.randint(0, len(g) - 1)
            g[d:d] = list(seg)
    genome = "".join(g)

    def mutate(r):
        if rng.random() < 0.05:  # low error rate
            j = rng.randint(0, len(r) - 1)
            r = r[:j] + rng.choice("ACGT") + r[j + 1:]
        return r

    def rc(r):
        return "".join(COMP[c] for c in reversed(r))

    if pe:
        # interleaved mate pairs (the pairing Dataset expects): fragments
        # of ~300 bp, a read off each end, second mate reverse-complemented
        npairs = rng.randint(2500, 4500)
        with open(path, "w") as f:
            for i in range(npairs):
                L = rng.choice((60, 70, 80, 90, 100))
                frag = rng.randint(max(2 * L, 250), 400)
                p = rng.randint(0, len(genome) - frag)
                r1 = mutate(genome[p:p + L])
                r2 = mutate(rc(genome[p + frag - L:p + frag]))
                f.write(">p%d/1\n%s\n>p%d/2\n%s\n" % (i, r1, i, r2))
        return
    nreads = rng.randint(4000, 9000)
    cov_reads = []
    for i in range(nreads):
        L = rng.choice((60, 70, 80, 90, 100))
        p = rng.randint(0, len(genome) - L)
        r = genome[p:p + L]
        if rng.random() < 0.5:
            r = rc(r)
        r = mutate(r)
        cov_reads.append(r)
    with open(path, "w") as f:
        for i, r in enumerate(cov_reads):
            f.write(">r%d\n%s\n" % (i, r))


def se_path(path):
    """Where mode `mix` writes its single-end file beside `path`."""
    root, ext = os.path.splitext(path)
    return root + "_se" + ext


def gen(seed, path, mode="se"):
    """Write seed's data set for `mode` and return the CLI's input
    arguments.  se and pe write `path`; mix writes the paired-end set to
    `path` and the single-end set of the same seed to se_path(path), as
    tools/pipefuzz.run_one does."""
    if mode not in MODES:
        raise ValueError("unknown fuzz mode %r" % mode)
    if mode == "mix":
        _write_reads(seed, path, pe=True)
        _write_reads(seed, se_path(path), pe=False)
        return ["-pe", "1", path, "-se", "1", se_path(path)]
    _write_reads(seed, path, pe=mode == "pe")
    return ["-pe" if mode == "pe" else "-se", "1", path]


def launch_counts():
    from ..ops import window_hash
    return {"window_hash": window_hash.launches,
            "window_hash_at": window_hash.at_launches}


def make_fuzz_mesh(device):
    """The sharded engine's mesh: one shard per card where several cards
    are visible, else (2, 2) with every shard on `device`."""
    import torch
    from ..parallel.mesh import make_mesh
    n = torch.cuda.device_count() if device.type == "cuda" else 1
    if n > 1:
        return make_mesh(dp=n, ix=1,
                         devices=[torch.device("cuda", k) for k in range(n)])
    return make_mesh(dp=2, ix=2, devices=[device] * 4)


def _exit_code(exc):
    if exc.code is None:
        return 0
    return exc.code if isinstance(exc.code, int) else 1


def run_cli(args, prefix, engine, device, l_opt, mesh=None):
    """The port's CLI in this process with `engine` on `device`, output
    files under `prefix` and its log in prefix + "log.txt".  Returns (rc,
    the engine that ran or None, kernel launches by name).  The CLI exits
    through SystemExit on a labelled fatal diagnostic or a flow error; its
    code is the run's rc, as the command line would return it."""
    from .. import cli
    from ..parallel.dryrun import _env
    before = launch_counts()
    argv = ["cli", *args, "-f", prefix, "-l", str(l_opt)]
    with _env(MGTPU_OVERLAP_ENGINE=engine, MGTPU_TORCH_DEVICE=str(device)), \
            open(prefix + "log.txt", "w") as f, contextlib.redirect_stdout(f):
        try:
            ran, rc = cli.main(argv, mesh).engine, 0
        except SystemExit as exc:
            ran, rc = None, _exit_code(exc)
    after = launch_counts()
    return rc, ran, {k: after[k] - before[k] for k in KERNELS}


def diff_artifacts(prefix_a, prefix_b):
    """ARTS whose files differ between two runs ("(exist)" where one run
    wrote the file and the other did not)."""
    bad = []
    for a in ARTS:
        fa, fb = prefix_a + a, prefix_b + a
        if os.path.exists(fa) != os.path.exists(fb):
            bad.append(a + "(exist)")
        elif os.path.exists(fa):
            with open(fa, "rb") as h1, open(fb, "rb") as h2:
                if h1.read() != h2.read():
                    bad.append(a)
    return bad


def binary_runs():
    """Whether the reference binary is present and runs on this host."""
    if not os.access(REF, os.X_OK):
        return False
    try:
        subprocess.run([REF], capture_output=True, timeout=60)
    except OSError:
        return False
    return True


def run_binary(args, workdir, l_opt):
    """The reference binary on args in workdir, prefix x_; its rc."""
    os.makedirs(workdir)
    return subprocess.run([REF, *args, "-f", "x_", "-l", str(l_opt)],
                          cwd=workdir, capture_output=True,
                          timeout=600).returncode


def fuzz_seed(seed, mode, l_opt, engines, device, with_binary, workdir):
    """One seed: native, then each engine, then the binary.  Returns a
    record: per engine the rc, the engine that ran, the launches and the
    artifacts that differ from native's; native's rc; and, with the binary,
    its rc and the artifacts in which native differs from it."""
    args = gen(seed, os.path.join(workdir, "f.fasta"), mode)
    nat = os.path.join(workdir, "native_x_")
    rec = {"seed": seed, "native_rc": run_cli(args, nat, "native", device,
                                               l_opt)[0], "engines": {}}
    for engine in engines:
        mesh = make_fuzz_mesh(device) if engine == "sharded" else None
        prefix = os.path.join(workdir, engine + "_x_")
        rc, ran, launched = run_cli(args, prefix, engine, device, l_opt,
                                    mesh)
        diff = diff_artifacts(prefix, nat)
        if rc != rec["native_rc"]:
            diff.insert(0, "rc %d, native %d" % (rc, rec["native_rc"]))
        if ran is not None and ran != engine:
            diff.insert(0, "ran %s" % ran)
        want = (mesh.shape["dp"] * mesh.shape["ix"] if mesh else 1) \
            if device.type == "cuda" and ran is not None else 0
        if launched != dict.fromkeys(KERNELS, want):
            diff.append("launches %s, want %d each" % (launched, want))
        rec["engines"][engine] = {"rc": rc, "ran": ran, "launches": launched,
                                  "differs": diff}
    if with_binary:
        ref = os.path.join(workdir, "ref")
        rec["binary_rc"] = run_binary(args, ref, l_opt)
        diff = diff_artifacts(os.path.join(ref, "x_"), nat)
        if rec["binary_rc"] != rec["native_rc"]:
            diff.insert(0, "rc")
        rec["native_vs_binary"] = diff
    return rec


def fuzz(seeds, mode="se", l_opt=40, engines=("device", "hybrid"),
         device=None, with_binary=None, log=None):
    """Fuzz `seeds`; returns the summary the command line prints.  Each
    failure names the seed, the engine and what differs from native."""
    import torch
    from ..ops.device_overlap import torch_device
    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    device = torch_device() if device is None else torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("the fuzzer was asked for %s but no CUDA device "
                           "is available" % device)
    for e in engines:
        if e not in ENGINES:
            raise ValueError("unknown card engine %r (one of %s)"
                             % (e, ", ".join(ENGINES)))
    if with_binary is None:
        with_binary = binary_runs()
    t0 = time.time()
    out = {"tool": "pipefuzz", "mode": mode, "l": l_opt,
           "seeds": list(seeds), "device": str(device),
           "card": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else None),
           "engines": {e: {"equal_native": 0,
                           "launches": dict.fromkeys(KERNELS, 0)}
                       for e in engines},
           "native": {"binary_ran": with_binary, "equal_binary": 0,
                      "differs_from_binary": {}},
           "failures": []}
    for seed in seeds:
        workdir = tempfile.mkdtemp(prefix="pf%d_%s_" % (seed, mode))
        rec = fuzz_seed(seed, mode, l_opt, engines, device, with_binary,
                        workdir)
        bad = []
        for e, r in rec["engines"].items():
            summary = out["engines"][e]
            for k in KERNELS:
                summary["launches"][k] += r["launches"][k]
            if r["differs"]:
                bad.append("%s: %s" % (e, ", ".join(r["differs"])))
                out["failures"].append({"seed": seed, "engine": e,
                                        "differs": r["differs"],
                                        "workdir": workdir})
            else:
                summary["equal_native"] += 1
        if with_binary:
            if rec["native_vs_binary"]:
                out["native"]["differs_from_binary"][str(seed)] = \
                    rec["native_vs_binary"]
            else:
                out["native"]["equal_binary"] += 1
        log("seed %d %s: %s%s" % (
            seed, mode, "FAIL " + "; ".join(bad) if bad else "ok",
            "" if not with_binary else ", native vs binary %s" % (
                "equal" if not rec["native_vs_binary"]
                else "differs: " + ",".join(rec["native_vs_binary"]))))
        if not bad:
            shutil.rmtree(workdir)
        else:
            log("  kept for inspection: %s" % workdir)
    out["seconds"] = time.time() - t0
    return out


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    seeds = [int(a) for a in argv] or list(range(1, 41))
    mode = os.environ.get("FUZZ_MODE") or "se"
    engines = [e for e in os.environ.get(
        "FUZZ_ENGINE", "device,hybrid").split(",") if e]
    out = fuzz(seeds, mode, int(os.environ.get("FUZZ_L", "40")), engines)
    print(json.dumps(out), flush=True)
    if out["failures"]:
        raise SystemExit("%d engine run(s) differ from native"
                         % len(out["failures"]))


if __name__ == "__main__":
    main()
