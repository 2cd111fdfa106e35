"""The port's packing device kernels (torch, on the CPU) against the JAX
package's jitted ones and the numpy twins: reverse complement,
lexicographic compare, canonicalization and QC, including palindromes,
N codes and low-complexity reads exactly at their threshold.  Exact
equality throughout."""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from metagenomics_tpu.ops import packing as jp
from metagenomics_tpu_torch.ops import packing as tp


def _pad(reads):
    lmax = max(len(r) for r in reads)
    arr = np.zeros((len(reads), lmax), dtype=np.uint8)
    lens = np.array([len(r) for r in reads])
    for i, r in enumerate(reads):
        arr[i, :len(r)] = np.frombuffer(r.encode(), dtype=np.uint8)
    return jp.ascii_to_codes(arr, lens), lens


def _random_reads(seed, n, lmin, lmax):
    rng = np.random.default_rng(seed)
    return ["".join(rng.choice(list("ACGTN") if k % 9 == 0 else list("ACGT"),
                               rng.integers(lmin, lmax + 1)))
            for k in range(n)]


def _palindromes():
    # reads equal to their reverse complement (the tie stores the reverse)
    # and reads whose reverse complement differs only in the last base
    return ["ACGT", "AATT", "GAATTC", "ACGCGT" * 3 + "ACGCGT"[::-1].translate(
        str.maketrans("ACGT", "TGCA")), "ACGTA", "TACGT"]


def _at_threshold(seed):
    """For lengths 5..140: one base exactly trunc(len * 0.8) times (bad)
    and one time fewer (good), the rest random other bases."""
    rng = np.random.default_rng(seed)
    reads = []
    for ln in range(5, 141):
        t = int(np.trunc(ln * 0.8))
        for count in (t, t - 1):
            base = "ACGT"[ln % 4]
            others = [b for b in "ACGT" if b != base]
            rest = rng.choice(others, ln - count)
            read = np.array(list(base * count) + list(rest))
            rng.shuffle(read)
            reads.append("".join(read))
    return reads


DATASETS = {
    "random": lambda: _random_reads(3, 80, 5, 70),
    "palindromes": _palindromes,
    "threshold": lambda: _at_threshold(4),
}


@pytest.mark.parametrize("name", sorted(DATASETS))
def test_packing_kernels_match_jax_and_numpy(name):
    codes, lens = _pad(DATASETS[name]())
    tc, tl = torch.from_numpy(codes), torch.from_numpy(lens)

    rc = tp.reverse_complement_codes(tc, tl)
    assert rc.dtype == torch.uint8
    np.testing.assert_array_equal(
        rc.numpy(), np.asarray(jp.reverse_complement_codes(codes, lens)))
    np.testing.assert_array_equal(
        rc.numpy(), jp.reverse_complement_codes_np(codes, lens))

    rcn = rc.numpy()
    np.testing.assert_array_equal(
        tp._lex_less(tc, rc).numpy(),
        np.asarray(jp._lex_less(codes, rcn)))
    np.testing.assert_array_equal(
        tp._lex_less(tc, rc).numpy(), jp._lex_less_np(codes, rcn))

    can, was_rev = tp.canonicalize_codes(tc, tl)
    jcan, jrev = jp.canonicalize_codes(codes, lens)
    ncan, nrev = jp.canonicalize_codes_np(codes, lens)
    assert can.dtype == torch.uint8 and was_rev.dtype == torch.bool
    np.testing.assert_array_equal(can.numpy(), np.asarray(jcan))
    np.testing.assert_array_equal(can.numpy(), ncan)
    np.testing.assert_array_equal(was_rev.numpy(), np.asarray(jrev))
    np.testing.assert_array_equal(was_rev.numpy(), nrev)

    for mo in (4, 20, 60):
        got = tp.qc_mask(tc, tl, mo)
        assert got.dtype == torch.bool
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(jp.qc_mask(codes, lens, mo)))
        np.testing.assert_array_equal(got.numpy(),
                                      jp.qc_mask_np(codes, lens, mo))


def test_palindrome_stores_the_reverse():
    """read == rc: the reference keeps the reverse (strict less-than)."""
    codes, lens = _pad(["ACGT", "AACC"])
    _, was_rev = tp.canonicalize_codes(torch.from_numpy(codes),
                                       torch.from_numpy(lens))
    assert was_rev.tolist() == [True, False]


def test_qc_threshold_is_float64_truncation():
    """Reads with the majority base exactly at trunc(len * 0.8) fail QC and
    one below passes, for every length 5..140."""
    reads = _at_threshold(5)
    codes, lens = _pad(reads)
    got = tp.qc_mask(torch.from_numpy(codes), torch.from_numpy(lens), 4)
    assert got.tolist() == [False, True] * (len(reads) // 2)
