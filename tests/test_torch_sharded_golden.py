"""The port's sharded engine end to end on the CPU: the golden configs
through the Assembler with cfg.mesh (an in-process (4, 2) mesh of CPU
shards), all 12 artifacts byte-equal to golden/out/<cfg>/, and the port's
dry run (parallel/dryrun.py) over every (dp, ix) split of 8 CPU shards."""

import os

import pytest
import torch

torch.set_num_threads(1)

from metagenomics_tpu_torch.assembler import Assembler
from metagenomics_tpu_torch.config import AssemblerConfig
from metagenomics_tpu_torch.parallel import collectives
from metagenomics_tpu_torch.parallel.mesh import make_mesh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "golden")
CPU = torch.device("cpu")
ARTIFACTS = [
    "_sortedReads.fasta", ".unitig", "_flow.input", "_flow.output",
    "graph1.gdl", "contigs1.fasta", "graph2.gdl", "contigs2.fasta",
    "graph3.gdl", "contigs3.fasta", "graph4.gdl", "contigs4.fasta",
]


def _data(*names):
    return [os.path.join(GOLDEN, "data", n) for n in names]


# (paired-end files, single-end files): tests/test_sharded.py's configs
CONFIGS = {
    "pe_small": (_data("pe_small.fasta"), []),
    "se_hard": ([], _data("se_hard.fasta")),
    "pe_hard": (_data("pe_hard_a.fasta", "pe_hard_b.fasta"), []),
    "pe_real": (_data("pe_real.fastq"), []),
}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_sharded_assembler_golden(name, tmp_path, monkeypatch):
    monkeypatch.setenv("MGTPU_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("MGTPU_OVERLAP_ENGINE", "sharded")
    pe, se = CONFIGS[name]
    cfg = AssemblerConfig(paired_end_files=pe, single_end_files=se,
                          min_overlap=40,
                          output_prefix=str(tmp_path / "t_"),
                          mesh=make_mesh(dp=4, ix=2, devices=[CPU] * 8))
    collectives.LEDGER.reset()
    asm = Assembler(cfg, log=lambda *a, **k: None)
    asm.run()
    assert asm.engine == "sharded"
    # the (4, 2) mesh ran: the ring over dp and the merge over ix
    keys = set(collectives.LEDGER.totals)
    assert ("emit", "ppermute", "dp", 4) in keys
    assert ("emit", "all_gather", "ix", 2) in keys
    for art in ARTIFACTS:
        got = (tmp_path / ("t_" + art)).read_bytes()
        want = open(os.path.join(GOLDEN, "out", name, "g_" + art),
                    "rb").read()
        assert got == want, "sharded artifact mismatch: %s %s" % (name, art)


def test_dryrun_multichip_cpu():
    """The port's counterpart of __graft_entry__.dryrun_multichip(8): all
    12 artifacts of every split equal the device engine's."""
    from metagenomics_tpu_torch.parallel.dryrun import dryrun_multichip
    assert dryrun_multichip(8, "cpu") == [(8, 1), (4, 2), (2, 4), (1, 8)]
