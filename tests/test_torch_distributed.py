"""Multi-process torch.distributed runs of the port (the counterpart of
tests/test_distributed.py): two localhost gloo processes join one process
group through the port's initialize_distributed (MGTPU_* variables) and
exchange data through the sharded engine's Distributed backend; then the
port's CLI runs the sharded engine over a mesh spanning the processes,
two (dp = 2) and four (the default split, dp = 2 by ix = 2: the ix process
groups, the all_to_all and all_gather over ix, the hash-range routing
across ranks), and every staged artifact of each rank must equal golden.
Each process runs with jax and the JAX package unimportable."""

import ast

import os
import socket
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "golden")
ARTIFACTS = [
    "_sortedReads.fasta", ".unitig", "_flow.input", "_flow.output",
    "graph1.gdl", "contigs1.fasta", "graph2.gdl", "contigs2.fasta",
    "graph3.gdl", "contigs3.fasta", "graph4.gdl", "contigs4.fasta",
]

_NO_JAX = "import sys; sys.modules['jax'] = None; " \
          "sys.modules['metagenomics_tpu'] = None\n"

_WORKER = _NO_JAX + r"""
import torch
import torch.distributed as dist
from metagenomics_tpu_torch.parallel import initialize_distributed, make_mesh

assert initialize_distributed(log=lambda *a, **k: None)
assert dist.get_backend() == "gloo" and dist.get_world_size() == 2
rank = dist.get_rank()
mesh = make_mesh()
assert mesh.shape == {"dp": 2, "ix": 1} and mesh.local == [(rank, 0)]
comm = mesh.comm
key = (rank, 0)
# a uint32 value above 2^31 crosses as 32 bits and comes back equal
x = {key: torch.tensor([0xFFFFFFF0 + rank, 10 * rank + 7])}
assert comm.all_gather(x, "dp")[key].tolist() == [
    0xFFFFFFF0, 7, 0xFFFFFFF1, 17]
assert comm.ppermute(x)[key].tolist() == [0xFFFFFFF0 + 1 - rank,
                                          10 * (1 - rank) + 7]
blocks = {key: torch.tensor([[rank, 0], [rank, 1]], dtype=torch.int32)}
assert comm.all_to_all(blocks, "dp")[key].tolist() == [[0, rank], [1, rank]]
assert int(comm.psum({key: torch.tensor(rank + 1, dtype=torch.int32)},
                     "dp")[key]) == 3
host = comm.host(x, [(0, 0), (1, 0)])
assert [h.tolist() for h in host.values()] == [[0xFFFFFFF0, 7],
                                              [0xFFFFFFF1, 17]]
dist.destroy_process_group()
print("DIST_OK", rank)
"""

_CLI = _NO_JAX + r"""
from metagenomics_tpu_torch.cli import main
from metagenomics_tpu_torch.parallel.collectives import LEDGER
asm = main(sys.argv[1:])
print("ENGINE", asm.engine)
print("RING", sorted(k for k in LEDGER.totals if k[1] == "ppermute"))
print("LEDGER", sorted(LEDGER.totals))
"""


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _launch(tmp_path, argv, extra_env=None, ranks=2):
    """Start `ranks` ranks (cwd tmp_path/rank<r>); returns their outputs."""
    port = _free_port()
    procs = []
    for rank in range(ranks):
        env = dict(os.environ)
        env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
        env["MGTPU_TORCH_DEVICE"] = "cpu"
        env["MGTPU_COORDINATOR"] = "127.0.0.1:%d" % port
        env["MGTPU_NUM_PROCESSES"] = str(ranks)
        env["MGTPU_PROCESS_ID"] = str(rank)
        env["OMP_NUM_THREADS"] = "1"
        env.update(extra_env or {})
        rankdir = tmp_path / ("rank%d" % rank)
        rankdir.mkdir()
        procs.append(subprocess.Popen(
            [sys.executable, "-c", *argv], env=env, cwd=rankdir,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=300)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, "rank %d:\n%s" % (rank, out[-3000:])
    return outs


def test_two_process_distributed(tmp_path):
    outs = _launch(tmp_path, [_WORKER])
    for rank, out in enumerate(outs):
        assert "DIST_OK %d" % rank in out


def _cli_pe_hard(tmp_path, ranks):
    """The port's CLI on the adversarial paired-end set over `ranks`
    processes, so mate-pair merging, the scaffolder and resolveNodes all
    run: every staged artifact of each rank equals golden.  Returns each
    rank's output and the ledger keys it counted."""
    outs = _launch(tmp_path, [
        _CLI, "cli", "-pe", "2",
        os.path.join(GOLDEN, "data", "pe_hard_a.fasta"),
        os.path.join(GOLDEN, "data", "pe_hard_b.fasta"),
        "-f", "t_", "-l", "40"], {"MGTPU_OVERLAP_ENGINE": "sharded"}, ranks)
    keys = []
    for rank, out in enumerate(outs):
        rankdir = tmp_path / ("rank%d" % rank)
        for art in ARTIFACTS:
            got = (rankdir / ("t_" + art)).read_bytes()
            want = open(os.path.join(GOLDEN, "out", "pe_hard", "g_" + art),
                        "rb").read()
            assert got == want, "rank %d artifact mismatch: %s" % (rank, art)
        assert "joined distributed runtime as process %d/%d" % (
            rank, ranks) in out
        assert "ENGINE sharded" in out
        assert "Pairs of Edges merged out of" in out
        assert "Average distance:" in out      # scaffolder merge lines
        assert "Merging edges (" in out        # resolveNodes
        keys.append(set(ast.literal_eval(
            out.split("LEDGER ")[1].splitlines()[0])))
    return outs, keys


def test_two_process_full_pipeline(tmp_path):
    """The port's CLI across 2 processes: both ranks run the sharded
    engine over a dp = 2 mesh spanning the processes (the ring over dp
    ran), and every staged artifact of each rank equals golden."""
    outs, _ = _cli_pe_hard(tmp_path, 2)
    for out in outs:
        assert "RING [('emit', 'ppermute', 'dp', 2)]" in out


def test_four_process_full_pipeline(tmp_path):
    """The same across 4 processes under the default split (2, 2): each
    rank routes its queries and index entries by hash range to the other
    member of its ix group (all_to_all over ix), merges the verified
    windows over ix (all_gather over ix) and runs the ring over dp."""
    _, keys = _cli_pe_hard(tmp_path, 4)
    for k in keys:
        assert ("probe", "all_to_all", "ix", 2) in k
        assert ("emit", "all_gather", "ix", 2) in k
        assert ("emit", "ppermute", "dp", 2) in k
