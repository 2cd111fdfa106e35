"""Construction time of each engine at 1M reads on the card, against the
reference binary timed on the same host.

    python -m metagenomics_tpu_torch.measure.engines_1m      (needs a card)

The data set is the first 1,000,000 reads of tools/measure_scale.py's
10M-read set (seed 11, a 50 Mb genome, random strand), the same bytes as
the 2,000,000-line slice tools/measure_sharded_scale.py takes, written to
bench_data/scale_se_1m.fasta without the other 9M reads.  Engines: native
(host), device and hybrid (card), each a warm-up and then the best of 3,
over the construction span (insertDataset + buildOverlapGraphFromHashTable
in the reference).  Every engine's .unitig must equal the native one's and
the reference's.  Prints one JSON object; writes no result file.
"""

import json
import os
import sys
import tempfile

import numpy as np
import torch

from .. import bench

DATA_1M = os.path.join(bench.DATA_DIR, "scale_se_1m.fasta")
SEED = 11
N_TOTAL = 10_000_000
N_1M = 1_000_000
READ_LEN = 100
BLOCK = 1 << 18


def write_first_reads(path, n_total=N_TOTAL, n=N_1M):
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


def ensure_1m():
    if not os.path.exists(DATA_1M):
        os.makedirs(os.path.dirname(DATA_1M), exist_ok=True)
        write_first_reads(DATA_1M)
    return DATA_1M


def build(engine, ds, cfg, device, unitig):
    """One construction by `engine`; seconds, and the graph's .unitig
    written to `unitig`."""
    from ..ops.device_overlap import DeviceOverlapPipeline
    graph = bench._fresh_graph(ds, cfg)
    if engine == "native":
        fn = graph.build_full_native
    elif engine == "hybrid":
        fn = graph.build_hybrid
    else:
        def fn():
            graph.build_from_pipeline(
                DeviceOverlapPipeline(ds, 40, device=device))
            return True
    with bench._env(MGTPU_TORCH_DEVICE=str(device)):
        dt, ok = bench.wall(fn, device)
    if not ok:
        raise RuntimeError("the %s engine did not apply" % engine)
    graph.save_graph_to_file(unitig)
    return dt


def main():
    if not torch.cuda.is_available():
        raise SystemExit("engines_1m runs on a CUDA card; none is available")
    device = torch.device("cuda", 0)
    card = bench.card_label()
    print("card:", card, file=sys.stderr, flush=True)
    data = ensure_1m()
    ds, cfg = bench.load_dataset(data)
    n = ds.number_of_unique_reads
    result = {"card": card, "n_unique_reads": n, "engines": {}}
    with tempfile.TemporaryDirectory() as td:
        def unitig(name):
            return os.path.join(td, "m1m_%s.unitig" % name)
        for engine in ("native", "device", "hybrid"):
            build(engine, ds, cfg, device, unitig(engine))
            runs = [build(engine, ds, cfg, device, unitig(engine))
                    for _ in range(3)]
            print("%s runs (s): %s" % (engine, runs), file=sys.stderr,
                  flush=True)
            result["engines"][engine] = {
                "construction_s": min(runs), "runs_s": runs,
                "reads_per_s": n / min(runs)}
        with open(unitig("native"), "rb") as f:
            want = f.read()

        def same(path):
            with open(path, "rb") as f:
                return f.read() == want
        result["unitig_equal_across_engines"] = all(
            same(unitig(e)) for e in ("device", "hybrid"))
        out, wall_s = bench._run_reference(
            ["-se", "1", data, "-f", "r_", "-l", "40"], td)
        p = bench.log_phases(out)
        result["reference_O0"] = {
            "binary": os.path.basename(bench.REF_BINARY),
            "construction_s": p["construction"],
            "reads_per_s": p["unique_reads"] / p["construction"],
            "e2e_s": wall_s, "cpu_model": bench.cpu_model()}
        result["unitig_equal_reference"] = same(
            os.path.join(td, "r_.unitig"))
    for rec in result["engines"].values():
        rec["vs_reference_at_1m"] = (rec["reads_per_s"]
                                     / result["reference_O0"]["reads_per_s"])
    print(json.dumps(result), flush=True)
    if not (result["unitig_equal_across_engines"]
            and result["unitig_equal_reference"]):
        raise SystemExit("the engines' .unitig files differ")


if __name__ == "__main__":
    main()
