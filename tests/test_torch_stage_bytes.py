"""The least bytes of the device pipeline's stages (omegabench/stages.py
stage_bytes, the yardstick the benchmark's stage lines and chip_smoke.py's
emit_verify bound share) against the port's own tensors on the CPU.

Each stage's least bytes count its real inputs read once and its outputs
written once at 4 bytes a value, so they are positive and stay below one
pass over the port's own input and output tensors (int64-held and
padded).  The survivors the benchmark feeds in (the shard's rows of the
stream's counts) are the words the fetch reads back, and the yardstick
charges exactly their bytes.  Every single-file golden set, on the device
engine's pipeline (row_lo 0) and on the hybrid's device shard (row_lo the
split build_hybrid takes by default), in the stream build_hybrid asks
for: canonical, and with every containment hit where lengths differ.
"""

import functools
import os

import pytest
import torch

from metagenomics_tpu_torch.dataset import Dataset
from metagenomics_tpu_torch.ops import device_overlap as tdo
from omegabench.stages import stage_bytes

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "golden", "data")
CPU = torch.device("cpu")
SETS = ["se_small.fasta", "se_hard.fasta", "se_heap.fasta",
        "se_mixlen.fasta", "pe_small.fasta", "pe_meta.fastq",
        "pe_real.fastq"]


def _nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


@functools.lru_cache(maxsize=None)
def _dataset(name):
    path = [os.path.join(GOLDEN, name)]
    pe, se = (path, []) if name.startswith("pe_") else ([], path)
    return Dataset(pe, se, 40, log=lambda *a, **k: None)


@pytest.mark.parametrize("shard", ["device", "hybrid"])
@pytest.mark.parametrize("name", SETS)
def test_stage_bytes_stay_below_one_pass_of_the_port(monkeypatch, name,
                                                     shard):
    ds = _dataset(name)
    n = ds.number_of_unique_reads
    row_lo = 0 if shard == "device" else max(1, min(n + 1,
                                                    1 + int(n * 0.9)))
    emitted = []
    emit2 = tdo._emit2

    def spy(*a, **k):
        out = emit2(*a, **k)
        emitted.append(out)
        return out
    monkeypatch.setattr(tdo, "_emit2", spy)
    p = tdo.DeviceOverlapPipeline(ds, 40, row_lo=row_lo, device=CPU)
    if ds.longest_read_length != ds.shortest_read_length:
        counts, words = p.stream_canon_raw_mixed()
    else:
        counts, words, _, _ = p.stream_canon(check_cont=False)
    (out, kc, _), = emitted

    dims = {"n1": int(p.hf.shape[0]), "row0": p.row0, "w": p.w,
            "npos": p.npos, "h_total": p.h_total,
            "survivors": int(counts[p.row0:].sum())}
    assert dims["row0"] == row_lo and len(counts) == dims["n1"]
    pf = tdo._upload_words(tdo.pack_codes_host(ds.codes_fwd), CPU)
    port = {
        "setup_kernel": _nbytes(pf, p.lengths, p.packed2, p.hf, p.sk,
                                p.sid),
        "probe_join": _nbytes(p.hf[p.row0:], p.lengths[p.row0:], p.sk,
                              p.rk, p.rleft, p.rcnt),
        "emit_verify": _nbytes(p.rk, p.rleft, p.rcnt, p.sid, p.packed2,
                               p.lengths, kc, out),
    }
    least = stage_bytes(dims)
    assert set(least) == set(port)
    for stage, most in port.items():
        assert 0 < least[stage] < most, stage
    # the survivors' d2h: the words fetched, 4 bytes each, as the
    # yardstick charges them
    assert dims["survivors"] == len(words)
    assert least["emit_verify"] - stage_bytes(
        dict(dims, survivors=0))["emit_verify"] == words.nbytes
