"""The sharded engine at scale on cards: artifacts against the native
engine, and the collective ledger measured at (dp, ix) = (4, 2).

    python -m metagenomics_tpu_torch.measure.sharded_scale

Two data sets: the bench's 200k-read set and the 1M-read slice of the
10M-read scale set (measure/engines_1m.py).  For each:

  * the CLI under the sharded engine with a (4, 2) mesh of 8 shards, and
    under the native engine, every staged artifact byte-compared;
  * a sharded construction run at (4, 2) recording the collective
    ledger's payload and wire bytes per phase.

The 8 shards sit on 8 cards when 8 are visible, else all on cuda:0: then
they share one card, and the record's keys say so (`one_card_shared`).
Prints one JSON object; writes no result file.
"""

import contextlib
import json
import os
import sys
import tempfile

import torch

from .. import bench
from . import engines_1m

ARTIFACTS = [
    "_sortedReads.fasta", ".unitig", "_flow.input", "_flow.output",
    "graph1.gdl", "contigs1.fasta", "graph2.gdl", "contigs2.fasta",
    "graph3.gdl", "contigs3.fasta", "graph4.gdl", "contigs4.fasta",
]


def placement(n_shards):
    """(devices, label): one shard per card when there are n_shards
    cards, else every shard on cuda:0."""
    if torch.cuda.device_count() >= n_shards:
        return ([torch.device("cuda", k) for k in range(n_shards)],
                "%d_cards" % n_shards)
    return [torch.device("cuda", 0)] * n_shards, "one_card_shared"


def run_cli(data, engine, outdir, mesh=None):
    """The port's CLI in this process; seconds."""
    from .. import cli
    argv = ["cli", "-se", "1", data, "-f", os.path.join(outdir, "o_"),
            "-l", "40"]
    with bench._env(MGTPU_OVERLAP_ENGINE=engine, MGTPU_TORCH_DEVICE="cuda"), \
            open(os.path.join(outdir, "log.txt"), "w") as f, \
            contextlib.redirect_stdout(f):
        dt, asm = bench.wall(lambda: cli.main(argv, mesh), bench.CPU)
    if asm.engine != engine:
        raise RuntimeError("the %s run ran %s" % (engine, asm.engine))
    return dt


def measured_ledger(data, mesh, label):
    """A sharded construction at (4, 2): the ledger as measured."""
    from ..dataset import Dataset
    from ..parallel.collectives import LEDGER
    from ..parallel.sharded import ShardedOverlapPipeline
    ds = Dataset([], [data], 40, log=lambda *a, **k: None)
    LEDGER.reset()

    def go():
        sp = ShardedOverlapPipeline(ds, 40, mesh=mesh)
        return sp.stream(check_cont=ds.longest_read_length
                         != ds.shortest_read_length)
    dt, (_, r2, _) = bench.wall(go, torch.device("cuda", 0))
    rep = LEDGER.report()
    return {
        "mesh": "dp=4 x ix=2, %s" % label,
        "n_unique_reads": ds.number_of_unique_reads,
        "stream_records": int(len(r2)),
        "construction_stream_seconds": dt,
        "measured_payload_bytes": rep["total_payload_bytes"],
        "measured_wire_bytes": rep["total_wire_bytes"],
        "per_phase": {
            name: {"invocations": p["invocations"],
                   "payload_bytes": p["payload_bytes"],
                   "wire_bytes": p["wire_bytes"]}
            for name, p in rep["phases"].items()},
        "projected_nvlink_seconds": rep["model"]["projected_nvlink_seconds"],
    }


def one_dataset(name, data, mesh, label):
    print("== %s ==" % name, file=sys.stderr, flush=True)
    row = {"dataset": name, "file": os.path.basename(data)}
    with tempfile.TemporaryDirectory() as ta, \
            tempfile.TemporaryDirectory() as tb:
        row["native_cli_seconds"] = run_cli(data, "native", ta)
        row["sharded_cli_seconds_" + label] = run_cli(data, "sharded", tb,
                                                      mesh)
        differ = []
        for a in ARTIFACTS:
            with open(os.path.join(ta, "o_" + a), "rb") as fa, \
                    open(os.path.join(tb, "o_" + a), "rb") as fb:
                if fa.read() != fb.read():
                    differ.append(a)
        row["artifacts_equal"] = not differ
        row["artifacts_differing"] = differ
        row["artifacts_checked"] = len(ARTIFACTS)
    print("  %s" % row, file=sys.stderr, flush=True)
    row["ledger_" + label] = measured_ledger(data, mesh, label)
    return row


def main():
    if not torch.cuda.is_available():
        raise SystemExit("sharded_scale runs on CUDA cards; none is "
                         "available")
    from ..parallel.mesh import make_mesh
    card = bench.card_label()
    devices, label = placement(8)
    mesh = make_mesh(dp=4, ix=2, devices=devices)
    bench.gen_bench_data()
    rows = [one_dataset("bench_200k", bench.DATA_FILE, mesh, label),
            one_dataset("scale_1m", engines_1m.ensure_1m(), mesh, label)]
    print(json.dumps({
        "card": card, "cards_visible": torch.cuda.device_count(),
        "placement": label,
        "what": "the CLI under the sharded engine at (4, 2) vs the native "
                "engine, every staged artifact byte-compared; ledger bytes "
                "measured at run time (parallel/collectives.py)%s" % (
                    "; the 8 shards share cuda:0, so nothing crosses "
                    "NVLink and the times say nothing about scaling"
                    if label == "one_card_shared" else ""),
        "rows": rows}), flush=True)
    if not all(r["artifacts_equal"] for r in rows):
        raise SystemExit("sharded artifacts differ from native")


if __name__ == "__main__":
    main()
