"""Scaling of the sharded overlap stream over (dp, ix) meshes on cards.

    python -m metagenomics_tpu_torch.measure.scaling

The shapes (1,1), (2,1), (4,1), (8,1), (4,2), (2,4) run the full sharded
stream (parallel/sharded.py: pipeline construction and stream) over one
24,000-read data set (tools/measure_scaling.py's, seed 5), each after a
warm-up run, twice:

  * distinct_cards: shard s on cuda:(s mod k), k = min(visible cards,
    dp * ix): with k = dp * ix every shard has a card of its own;
  * one_card: every shard on cuda:0, so shards share the card and the
    curve measures the exchange and orchestration overhead, not speed-up.

Every shape's stream must equal the (1, 1) stream.  speedup =
T(1, 1) / T(shape) within each placement.  Prints one JSON object; writes
no result file.
"""

import json
import os
import sys
import tempfile

import numpy as np
import torch

from .. import bench

N_READS = 24_000
GENOME = 120_000
READ_LEN = 100
MIN_OVERLAP = 40
SHAPES = [(1, 1), (2, 1), (4, 1), (8, 1), (4, 2), (2, 4)]


def make_dataset(tmpdir):
    rng = np.random.default_rng(5)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    comp_lut = np.zeros(256, np.uint8)
    for k, v in zip(b"ACGT", b"TGCA"):
        comp_lut[k] = v
    genome = bases[rng.integers(0, 4, GENOME)]
    starts = rng.integers(0, GENOME - READ_LEN + 1, N_READS)
    reads = genome[starts[:, None] + np.arange(READ_LEN)[None, :]]
    flip = rng.random(N_READS) < 0.5
    reads = np.where(flip[:, None], comp_lut[reads[:, ::-1]], reads)
    path = os.path.join(tmpdir, "scaling_se.fasta")
    with open(path, "wb") as f:
        for i, row in enumerate(reads):
            f.write(b">r%d\n" % i)
            f.write(row.tobytes())
            f.write(b"\n")
    return path


def shard_devices(n_shards, placement):
    if placement == "one_card":
        return [torch.device("cuda", 0)] * n_shards
    k = min(torch.cuda.device_count(), n_shards)
    return [torch.device("cuda", s % k) for s in range(n_shards)]


def run_shape(ds, dp, ix, devices):
    """(seconds, stream, ledger report) of one timed sharded stream."""
    from ..parallel.collectives import LEDGER
    from ..parallel.mesh import make_mesh
    from ..parallel.sharded import ShardedOverlapPipeline
    mesh = make_mesh(dp=dp, ix=ix, devices=devices)

    def go():
        out = ShardedOverlapPipeline(ds, MIN_OVERLAP,
                                     mesh=mesh).stream(check_cont=False)
        for d in set(devices):
            torch.cuda.synchronize(d)
        return out
    go()                                   # warm-up
    LEDGER.reset()
    dt, out = bench.wall(go, bench.CPU)
    return dt, out, LEDGER.report()


def main():
    if not torch.cuda.is_available():
        raise SystemExit("scaling runs on CUDA cards; none is available")
    from ..dataset import Dataset
    card = bench.card_label()
    visible = torch.cuda.device_count()
    result = {"card": card, "cards_visible": visible, "n_reads": N_READS}
    with tempfile.TemporaryDirectory() as td:
        ds = Dataset([], [make_dataset(td)], MIN_OVERLAP,
                     log=lambda *a, **k: None)
        ref_stream = None
        for placement in ("distinct_cards", "one_card"):
            rows = []
            for dp, ix in SHAPES:
                devices = shard_devices(dp * ix, placement)
                dt, out, rep = run_shape(ds, dp, ix, devices)
                if ref_stream is None:
                    ref_stream = out
                elif not all(np.array_equal(a, b)
                             for a, b in zip(ref_stream, out)):
                    raise SystemExit("stream mismatch at dp=%d ix=%d (%s)"
                                     % (dp, ix, placement))
                cards = len(set(devices))
                rows.append({
                    "dp": dp, "ix": ix, "cards": cards, "seconds": dt,
                    "collective_payload_bytes": rep["total_payload_bytes"],
                    "collective_wire_bytes": rep["total_wire_bytes"],
                    "projected_nvlink_seconds":
                        rep["model"]["projected_nvlink_seconds"],
                    "per_phase_wire_bytes": {
                        ph: p["wire_bytes"]
                        for ph, p in rep["phases"].items()}})
                print("%s dp=%d ix=%d on %d card(s): %.6f s, wire %d bytes"
                      % (placement, dp, ix, cards, dt,
                         rep["total_wire_bytes"]), file=sys.stderr,
                      flush=True)
            for r in rows:
                r["speedup"] = rows[0]["seconds"] / r["seconds"]
            result["rows_" + placement] = rows
    result["byte_equal_across_shapes"] = True
    result["what"] = (
        "sharded stream wall time (construction + stream, after a warm-up) "
        "on %d visible card(s) of %s. rows_distinct_cards: shard s on "
        "cuda:(s mod k), k = min(%d, dp*ix); rows_one_card: every shard on "
        "cuda:0. speedup = T(1,1) / T(shape) in each; where shards share "
        "a card it measures exchange and orchestration overhead, not "
        "speed-up" % (visible, card, visible))
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
