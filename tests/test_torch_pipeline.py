"""The port's DeviceOverlapPipeline (on the CPU) against the JAX package's,
array for array: stream() and stream_canon() on all nine golden datasets
with check_cont on and off, multi-chunk runs, the row_lo shard, and the
port's Dataset against the JAX Dataset.  Exact equality throughout."""

import os

import numpy as np
import pytest
import torch

# one torch thread: the suite runs several workers side by side, and
# torch's spinning OpenMP threads would fight them (and JAX) for the cores
torch.set_num_threads(1)

from metagenomics_tpu.dataset import Dataset as JDataset
from metagenomics_tpu.ops import device_overlap as jdo
from metagenomics_tpu_torch.dataset import Dataset as TDataset
from metagenomics_tpu_torch.ops import device_overlap as tdo

GOLDEN = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "golden", "data")
CPU = torch.device("cpu")

# (paired-end files, single-end files) of the nine golden configs
DATASETS = {
    "se_small": ([], ["se_small.fasta"]),
    "se_mixlen": ([], ["se_mixlen.fasta"]),
    "pe_small": (["pe_small.fasta"], []),
    "pe_meta": (["pe_meta.fastq"], []),
    "pe_real": (["pe_real.fastq"], []),
    "mix_ps": (["pe_small.fasta"], ["se_mixlen.fasta"]),
    "se_heap": ([], ["se_heap.fasta"]),
    "se_hard": ([], ["se_hard.fasta"]),
    "pe_hard": (["pe_hard_a.fasta", "pe_hard_b.fasta"], []),
}


def _quiet(*a, **k):
    pass


def _dataset(cls, name):
    pe, se = DATASETS[name]
    return cls([os.path.join(GOLDEN, f) for f in pe],
               [os.path.join(GOLDEN, f) for f in se], 40, log=_quiet)


def _same(got, want, what):
    if want is None:
        assert got is None, what
        return
    assert got is not None, what
    assert len(got) == len(want), what
    for i, (g, w) in enumerate(zip(got, want)):
        if w is None:
            assert g is None, "%s[%d]" % (what, i)
            continue
        g, w = np.asarray(g), np.asarray(w)
        assert g.dtype == w.dtype, "%s[%d]: %s != %s" % (what, i, g.dtype,
                                                         w.dtype)
        np.testing.assert_array_equal(g, w, err_msg="%s[%d]" % (what, i))


@pytest.mark.parametrize("name", sorted(DATASETS))
def test_streams_match_jax(name):
    ds = _dataset(JDataset, name)
    jp = jdo.DeviceOverlapPipeline(ds, 40)
    tp = tdo.DeviceOverlapPipeline(ds, 40, device=CPU)
    assert (tp.grand, tp.h_total, tp.off_bits, tp.uniform_len) == \
        (jp.grand, jp.h_total, jp.off_bits, jp.uniform_len)
    for check_cont in (True, False):
        _same(tp.stream(check_cont), jp.stream(check_cont),
              "%s stream(check_cont=%s)" % (name, check_cont))
        _same(tp.stream_canon(check_cont), jp.stream_canon(check_cont),
              "%s stream_canon(check_cont=%s)" % (name, check_cont))


def _with_max_cap(cap, fn):
    old = tdo.DeviceOverlapPipeline.MAX_CAP
    try:
        tdo.DeviceOverlapPipeline.MAX_CAP = cap
        return fn()
    finally:
        tdo.DeviceOverlapPipeline.MAX_CAP = old


@pytest.mark.parametrize("cap", [1 << 14, 1 << 16])
def test_multichunk_matches_single_chunk(cap):
    """Forced multi-chunk runs reproduce the single-chunk stream and
    canonical stream exactly (tests/test_ops.py:163 and
    tests/test_canon_stream.py:137 on the port)."""
    ds = _dataset(JDataset, "se_hard")
    one = tdo.DeviceOverlapPipeline(ds, 40, device=CPU)
    want_stream = one.stream(check_cont=True)
    want_canon = one.stream_canon(check_cont=False)

    def run():
        p = tdo.DeviceOverlapPipeline(ds, 40, device=CPU)
        assert len(p._plan_chunks()[2]) > 1
        return p.stream(check_cont=True), p.stream_canon(check_cont=False)

    got_stream, got_canon = _with_max_cap(cap, run)
    _same(got_stream, want_stream, "stream, cap %d" % cap)
    _same(got_canon, want_canon, "stream_canon, cap %d" % cap)


def test_multichunk_mixed_canon_is_refused():
    """A mixed-length set that needs several chunks has no canonical
    stream (containment is global), exactly like the reference."""
    ds = _dataset(JDataset, "se_heap")
    got = _with_max_cap(1 << 16, lambda: tdo.DeviceOverlapPipeline(
        ds, 40, device=CPU).stream_canon(check_cont=True))
    assert got is None


@pytest.mark.parametrize("name", ["se_hard", "se_heap"])
def test_row_lo_shard_matches_jax(name):
    ds = _dataset(JDataset, name)
    a = 1 + ds.number_of_unique_reads // 3
    jp = jdo.DeviceOverlapPipeline(ds, 40, row_lo=a)
    tp = tdo.DeviceOverlapPipeline(ds, 40, row_lo=a, device=CPU)
    _same(tp.stream(True), jp.stream(True), "stream row_lo")
    _same(tp.stream_canon(False), jp.stream_canon(False),
          "stream_canon row_lo")
    _same(tp.stream_canon_raw_mixed(), jp.stream_canon_raw_mixed(),
          "stream_canon_raw_mixed row_lo")


def test_stream_r2_meta_layout_matches_jax():
    """The (r2 int32, meta uint16) layout that reads too long or too many
    for one 32-bit word take (off_bits < 0), forced on a golden set."""
    ds = _dataset(JDataset, "se_mixlen")
    jp = jdo.DeviceOverlapPipeline(ds, 40)
    tp = tdo.DeviceOverlapPipeline(ds, 40, device=CPU)
    jp.off_bits = tp.off_bits = -1
    got = tp.stream(True)
    _same(got, jp.stream(True), "stream, r2/meta layout")
    assert got[2].dtype == np.uint16 and len(got[1]) > 0
    assert tp.stream_canon(True) is None


@pytest.mark.parametrize("name", ["mix_ps", "pe_real"])
def test_dataset_matches_jax(name):
    """The port's Dataset (a host copy) builds the same arrays."""
    jd = _dataset(JDataset, name)
    td = _dataset(TDataset, name)
    for attr in ("codes_fwd", "codes_rev", "lengths", "frequencies"):
        np.testing.assert_array_equal(getattr(td, attr), getattr(jd, attr),
                                      err_msg=attr)
    n = jd.number_of_unique_reads
    assert [td.read_strs[i] for i in range(n + 1)] == \
        [jd.read_strs[i] for i in range(n + 1)]
    jd.read_mate_pairs_from_file()
    td.read_mate_pairs_from_file()
    for attr in ("mp_rid", "mp_mate", "mp_orient", "mp_dataset"):
        np.testing.assert_array_equal(getattr(td, attr), getattr(jd, attr),
                                      err_msg=attr)
    assert len(td.mp_rid) > 0
