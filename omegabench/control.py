"""The controls of a cell's correctness check: the plain reference put in
the program's place with one guarantee of the configuration broken.  Each
has to come out not correct.  Every control that applies to a seed's
sample runs:

- overlap (every sample): the configuration guarantees every exact
  overlap of at least min_overlap bases and no other.  The control
  enumerates overlaps of min_overlap - 1 bases and more, packs the sampled
  rows into the program's canonical stream layout, and hands that stream
  to the same comparison a run makes (check.rows_check).
- first-container (samples of several lengths): a contained read's super
  read is the lowest-numbered of its longest containers.  The control
  keeps the first container and never replaces it with a longer one
  (reference/contained.py's first_wins), and hands those super reads to
  check.supers_check.

    python3 omegabench/control.py --workload <cell> --seeds <n> [<n> ...]

One JSON line a control and seed on standard output.  It needs no card.
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
from omegabench.reference import contained, ingest, overlaps  # noqa: E402


def control_stream(reads, ids, found, min_len):
    """The overlaps `found` (r1, key, of min_len bases and more) of the
    sampled rows, those with a partner numbered no lower, in the program's
    canonical stream layout; other rows empty."""
    r1, key = found
    keep = (key >> 18) >= r1
    rows = overlaps.split_rows(ids, r1[keep], key[keep])
    lmax = int(reads.lengths.max())
    ob = max(1, (lmax - min_len + 1).bit_length())
    counts = np.zeros(reads.count + 1, np.int64)
    words = []
    for r in ids:
        key = rows[int(r)]
        counts[r] = len(key)
        r2_eo, off = key >> 16, key & 0xFFFF
        words.append(((r2_eo >> 2) << (4 + ob)) | ((4 | (r2_eo & 3)) << ob)
                     | off)
    return counts, np.concatenate(words).astype(np.uint32), ob


def overlap_control(s, log):
    """Overlaps one base shorter than the guarantee allows."""
    found = contained.without_contained(s.index.overlaps(s.ids, s.mo - 1),
                                        s.sup)
    stream = control_stream(s.reads, s.ids, found, s.mo - 1)
    return [check.rows_check(s.reads, stream, s.ids, s.found, log)]


def first_container_control(s, log):
    """The first container kept as the super read, never a longer one."""
    got = contained.supers(s.reads, first_wins=True)
    return [check.supers_check(s.sup, got, log)]


class Sample:
    """One seed's sample as the check sees it: its reads, their index,
    the sampled ids, the reference's super reads (None for one length) and
    the sampled rows' overlaps with no contained read."""

    def __init__(self, cell, seed, fasta):
        self.mo = cell.config["min_overlap"]
        self.reads = ingest.load(fasta, self.mo)
        self.sup = (contained.supers(self.reads)
                    if check.several_lengths(self.reads) else None)
        self.index = overlaps.StrandIndex(self.reads)
        self.ids = check.sample_rows(self.reads.count,
                                     cell.traffic["check_rows"], seed, None)
        self.found = contained.without_contained(
            self.index.overlaps(self.ids, self.mo), self.sup)


def run_control(cell, seed, log):
    """{control: (checks, correct)} of every control that applies to one
    seed's sample."""
    workdir = tempfile.mkdtemp(prefix="omegabench-control-")
    try:
        fasta, _ = generator.write_sample(cell.config, cell.traffic, seed,
                                          workdir)
        sample = Sample(cell, seed, fasta)
        controls = {"overlap": overlap_control}
        if sample.sup is not None:
            controls["first-container"] = first_container_control
        out = {}
        for name, control in controls.items():
            checks = control(sample, log)
            out[name] = (checks, all(c.ok for c in checks))
        return out
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
        for name, (checks, correct) in run_control(cell, seed, log).items():
            print(json.dumps({"workload": args.workload, "seed": seed,
                              "control": name, "correct": correct,
                              "checks": {c.name: c.record()
                                         for c in checks}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
