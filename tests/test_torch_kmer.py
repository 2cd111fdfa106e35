"""The port's host-engine index (ops/kmer.py on the CPU, index.py) against
the JAX package's: window limbs at every limb boundary, chunked window
hashes, and the OverlapIndex arrays and candidates on golden datasets.
Exact equality throughout."""

import os

import numpy as np
import pytest
import torch

# one torch thread: the suite runs several workers side by side
torch.set_num_threads(1)

from metagenomics_tpu.dataset import Dataset as JDataset
from metagenomics_tpu.index import OverlapIndex as JIndex
from metagenomics_tpu.ops import kmer as jkmer
from metagenomics_tpu_torch.index import OverlapIndex as TIndex
from metagenomics_tpu_torch.ops import kmer as tkmer

GOLDEN = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "golden", "data")
CPU = torch.device("cpu")


def _codes(seed, n, lmax):
    """Random base codes with a pad tail (code 4) past each row's length,
    some rows padded from column 0, and some 255 (invalid) codes."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, (n, lmax)).astype(np.uint8)
    lens = rng.integers(0, lmax + 1, n)
    lens[:3] = lmax
    codes[np.arange(lmax)[None, :] >= lens[:, None]] = 4
    codes[rng.random((n, lmax)) < 0.01] = 255
    return codes


# l at and around the 16-base limb boundaries (the last limb partial or
# full), the main path's 39 and 63, and l == lmax / l > lmax
@pytest.mark.parametrize("lmax,l", [
    (70, 15), (70, 16), (70, 17), (70, 32), (70, 33), (70, 39), (100, 63),
    (40, 40), (30, 33)])
def test_window_limbs_match_jax(lmax, l):
    codes = _codes(l * lmax, 37, lmax)
    want = np.asarray(jkmer.window_limbs(codes, l))
    got = tkmer.window_limbs(torch.from_numpy(codes), l)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


@pytest.mark.parametrize("l", [17, 39])
def test_all_window_hashes_match_jax(l):
    """Several row chunks, the last one partial."""
    codes = _codes(l, 300, 90)
    want = jkmer.all_window_hashes(codes, l, chunk=128)
    got = tkmer.all_window_hashes(codes, l, chunk=128, device=CPU)
    assert got.dtype == want.dtype == np.uint64
    np.testing.assert_array_equal(got, want)


def _quiet(*a, **k):
    pass


@pytest.mark.parametrize("files", [
    ("se_mixlen.fasta",), ("pe_real.fastq",), ("se_hard.fasta",)])
def test_overlap_index_matches_jax(files, monkeypatch):
    monkeypatch.setenv("MGTPU_TORCH_DEVICE", "cpu")
    ds = JDataset([], [os.path.join(GOLDEN, f) for f in files], 40,
                  log=_quiet)
    ji, ti = JIndex(ds, 40), TIndex(ds, 40)
    for attr in ("q_hashes", "sorted_keys", "sorted_rid", "sorted_orient",
                 "_bloom"):
        j, t = getattr(ji, attr), getattr(ti, attr)
        assert t.dtype == j.dtype, attr
        np.testing.assert_array_equal(t, j, err_msg=attr)
    rng = np.random.default_rng(len(files[0]))
    subset = np.sort(rng.choice(np.arange(1, ds.number_of_unique_reads + 1),
                                200, replace=False))
    for read_ids in (None, subset):
        jb, tb = ji.candidates(read_ids), ti.candidates(read_ids)
        assert len(tb) == len(jb) > 0
        for f in ("r1", "j", "r2", "orient"):
            np.testing.assert_array_equal(getattr(tb, f), getattr(jb, f),
                                          err_msg=f)
