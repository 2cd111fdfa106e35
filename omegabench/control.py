"""The control of a cell's correctness check: the plain reference put in
the program's place with one guarantee of the configuration broken.

The configuration guarantees every exact overlap of at least min_overlap
bases and no other.  The control enumerates overlaps of min_overlap - 1
bases and more, packs the sampled rows into the program's canonical
stream layout, and hands that stream to the same comparison a run makes
(check.rows_check).  It has to come out not correct.

    python3 omegabench/control.py --workload <cell> --seeds <n> [<n> ...]

One JSON line a seed on standard output.  It needs no card.
"""

import argparse
import json
import os
import shutil
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if sys.path and os.path.abspath(sys.path[0] or os.curdir) == HERE:
    sys.path[0] = ROOT
elif ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402

from omegabench import check, generator, layout  # noqa: E402
from omegabench.reference import ingest, overlaps  # noqa: E402


def control_stream(reads, ids, min_overlap):
    """The sampled rows of overlaps of min_overlap - 1 bases and more, in
    the program's canonical stream layout; other rows empty."""
    rows = overlaps.StrandIndex(reads).rows(ids, min_overlap - 1)
    lmax = int(reads.lengths.max())
    ob = max(1, (lmax - min_overlap + 1).bit_length())
    counts = np.zeros(reads.count + 1, np.int64)
    words = []
    for r in ids:
        key = rows[int(r)]
        counts[r] = len(key)
        r2_eo, off = key >> 16, key & 0xFFFF
        words.append(((r2_eo >> 2) << (4 + ob)) | ((4 | (r2_eo & 3)) << ob)
                     | off)
    return counts, np.concatenate(words).astype(np.uint32), ob


def run_control(cell, seed, log):
    """(checks, correct) of the control on one seed's sample."""
    workdir = tempfile.mkdtemp(prefix="omegabench-control-")
    try:
        fasta, _ = generator.write_sample(cell.config, cell.traffic, seed,
                                          workdir)
        mo = cell.config["min_overlap"]
        reads = ingest.load(fasta, mo)
        ids = check.sample_rows(reads.count, cell.traffic["check_rows"],
                                seed, None)
        stream = control_stream(reads, ids, mo)
        found = overlaps.StrandIndex(reads).overlaps(ids, mo)
        checks = [check.rows_check(reads, stream, ids, found, log)]
        return checks, all(c.ok for c in checks)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    cell = layout.Cell(args.workload, layout.benchmark())

    def log(msg):
        print(msg, file=sys.stderr, flush=True)
    for seed in args.seeds:
        checks, correct = run_control(cell, seed, log)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "correct": correct,
                          "checks": {c.name: c.record() for c in checks}}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
