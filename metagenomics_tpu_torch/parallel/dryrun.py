"""The port's multi-shard dry run: the counterpart of
__graft_entry__.dryrun_multichip, with shards on a torch device.

dryrun_multichip(n, device) runs a miniature END-TO-END assembly over every
(dp, ix) split of n shards (8: (8,1), (4,2), (2,4), (1,8)), each shard on
`device` (MGTPU_TORCH_DEVICE, cuda by default), and requires all 12 staged
artifacts to equal the single-device (device engine) run's.
"""

import contextlib
import os
import tempfile

import numpy as np
import torch

ARTIFACTS = [
    "_sortedReads.fasta", ".unitig", "_flow.input", "_flow.output",
    "graph1.gdl", "contigs1.fasta", "graph2.gdl", "contigs2.fasta",
    "graph3.gdl", "contigs3.fasta", "graph4.gdl", "contigs4.fasta",
]

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


@contextlib.contextmanager
def _env(**values):
    old = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _write_reads(path):
    """The reference dry run's repeat-dense paired-end genome: unique arms
    + a 2-copy 120bp repeat + a 6x tandem 20mer (reads inside it overlap
    THEMSELVES) + a 2x tandem of a 300bp unit (contraction leaves a
    SELF-LOOP composite edge at the copy junction, the twin-pick-sensitive
    case of OverlapGraph.cpp:460) + a 1-SNP bubble copy of a 90bp
    stretch."""
    rng = np.random.default_rng(3)
    uniq = rng.integers(0, 4, 1400)
    rep = rng.integers(0, 4, 120)
    tandem = np.tile(rng.integers(0, 4, 20), 6)
    bigrep = np.tile(rng.integers(0, 4, 300), 2)
    bub = uniq[200:290].copy()
    bub[45] = (bub[45] + 1) % 4
    genome = np.concatenate([
        uniq[:500], rep, uniq[500:900], tandem, uniq[900:1200], rep,
        bub, uniq[1200:1350], bigrep, uniq[1350:1400]])
    comp = np.array([3, 2, 1, 0])
    lut = np.frombuffer(b"ACGT", dtype=np.uint8)
    with open(path, "w") as f:
        i = 0
        for p in range(0, len(genome) - 150, 3):
            r1 = genome[p:p + 48]
            r2 = comp[genome[p + 102:p + 150][::-1]]
            if i % 3 == 0:
                r1, r2 = comp[r2[::-1]], comp[r1[::-1]]
            f.write(">a%d\n%s\n>b%d\n%s\n"
                    % (i, lut[r1].tobytes().decode(),
                       i, lut[r2].tobytes().decode()))
            i += 1


def splits(n_shards):
    """Every (dp, ix) with dp * ix = n_shards and ix a power of two."""
    out = []
    ix = 1
    while ix <= n_shards:
        if n_shards % ix == 0:
            out.append((n_shards // ix, ix))
        ix *= 2
    return out


def dryrun_multichip(n_devices, device=None):
    """Assemble the repeat-dense paired-end genome plus the se_heap golden
    set (mixed numbering, contained reads, late-phase merges that leave
    self-loop twin pairs alive through contig emission, asserted below)
    once with the device engine on `device`, then with the sharded engine
    at every (dp, ix) split of n_devices shards, all on `device`; every
    staged artifact must be byte-equal.  Returns the splits run."""
    from ..assembler import Assembler
    from ..config import AssemblerConfig
    from .mesh import make_mesh
    from ..ops.device_overlap import torch_device

    device = torch_device() if device is None else torch.device(device)
    se_heap = os.path.join(_REPO, "golden", "data", "se_heap.fasta")
    se_files = [se_heap] if os.path.exists(se_heap) else []
    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "reads.fasta")
        _write_reads(path)

        def run(engine, mesh, out):
            cfg = AssemblerConfig(
                paired_end_files=[path], single_end_files=se_files,
                min_overlap=40, output_prefix=os.path.join(td, out),
                overlap_engine=engine, mesh=mesh)
            with _env(MGTPU_OVERLAP_ENGINE=engine,
                      MGTPU_TORCH_DEVICE=str(device)):
                asm = Assembler(cfg, log=lambda *a, **k: None)
                graph = asm.run()
            if asm.engine != engine:
                raise RuntimeError("the %s run ran %s" % (engine, asm.engine))
            arts = {a: open(os.path.join(td, out + a), "rb").read()
                    for a in ARTIFACTS}
            return arts, graph

        single, graph = run("device", None, "d_")
        assert len(single["contigs4.fasta"]) > 0
        if se_files:
            loops = sum(1 for i in range(len(graph.adj))
                        for e in graph.adj[i]
                        if e.source == e.destination)
            assert loops > 0, "expected surviving self-loop edges"
        done = splits(n_devices)
        for dp, ix in done:
            mesh = make_mesh(dp=dp, ix=ix, devices=[device] * n_devices)
            sharded, _ = run("sharded", mesh, "s%d_%d_" % (dp, ix))
            for a in ARTIFACTS:
                assert sharded[a] == single[a], (
                    "sharded(dp=%d, ix=%d) artifact %s differs from "
                    "single-device" % (dp, ix, a))
    return done

