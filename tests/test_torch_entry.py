"""The port's entry() (metagenomics_tpu_torch/entry.py) against
__graft_entry__.entry() on the CPU: the same arguments, and exactly the
same outputs of the verification kernel, on entry's own random pairs and
on reads that overlap."""

import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from metagenomics_tpu_torch import entry as tentry
from metagenomics_tpu_torch.parallel import dryrun


def test_entry_arguments_equal():
    _, args = tentry.entry("cpu")
    _, jargs = graft.entry()
    assert len(args) == len(jargs) == 7
    for a, b in zip(args, jargs):
        b = np.asarray(b)
        assert a.device.type == "cpu"
        assert a.numpy().dtype == b.dtype
        np.testing.assert_array_equal(a.numpy(), b)


def test_entry_outputs_equal():
    fn, args = tentry.entry("cpu")
    jfn, jargs = graft.entry()
    got = fn(*args)
    want = np.asarray(jax.jit(jfn)(*jargs))
    assert got.numpy().dtype == want.dtype
    np.testing.assert_array_equal(got.numpy(), want)


def _overlapping_reads(seed):
    """Reads of 40-48 bases tiled 4 bases apart along one genome (PAD code
    4 past each length), and candidates between neighbours in all four
    orientations, many of which verify."""
    rng = np.random.default_rng(seed)
    n, lmax = 64, 48
    genome = rng.integers(0, 4, 4 * n + lmax)
    lengths = rng.integers(40, lmax + 1, n).astype(np.int32)
    codes = np.stack([genome[4 * i:4 * i + lmax] for i in range(n)])
    codes = np.where(np.arange(lmax)[None, :] < lengths[:, None], codes,
                     4).astype(np.uint8)
    m = 512
    r1 = rng.integers(0, n - 3, m).astype(np.int32)
    r2 = (r1 + rng.integers(0, 4, m)).astype(np.int32)
    j = rng.integers(0, 16, m).astype(np.int32)
    orient = rng.integers(0, 4, m).astype(np.int32)
    j = np.where(orient == 0, 4 * (r2 - r1), j).astype(np.int32)
    return codes, lengths, r1, j, r2, orient


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_entry_fn_equal_on_overlapping_reads(seed):
    fn, _ = tentry.entry("cpu")
    jfn, _ = graft.entry()
    codes, lengths, r1, j, r2, orient = _overlapping_reads(seed)
    from metagenomics_tpu.ops.packing import reverse_complement_codes
    rev = np.asarray(reverse_complement_codes(codes,
                                              lengths.astype(np.int64)))
    arrays = (codes, rev, lengths, r1, j, r2, orient)
    got = fn(*(torch.from_numpy(np.array(a)) for a in arrays)).numpy()
    want = np.asarray(jax.jit(jfn)(*(jax.numpy.asarray(a) for a in arrays)))
    np.testing.assert_array_equal(got, want)
    assert 0 < got.sum() < len(got)


def test_entry_reexports_the_dry_run():
    assert tentry.dryrun_multichip is dryrun.dryrun_multichip
    assert tentry.ARTIFACTS == graft.ARTIFACTS
