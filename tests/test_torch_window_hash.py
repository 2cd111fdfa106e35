"""The port's plain window hash (window_hashes_torch) against the JAX
package's rolling hash and its Pallas kernel (interpret mode), and against
a numpy uint32 model of the CUDA kernel's prefix-difference arithmetic;
window_hashes_at against a gather of the full matrix.  Inputs are made
with numpy from fixed seeds.  Every value is an integer, so the tolerance
is exact equality."""

import numpy as np
import pytest
import torch

from metagenomics_tpu.ops.device_overlap import window_hashes_u32
from metagenomics_tpu.ops.pallas_hash import window_hashes_pallas
from metagenomics_tpu_torch.ops import window_hash


def _codes(seed, n, lmax):
    return np.random.default_rng(seed).integers(0, 5, (n, lmax)).astype(
        np.uint8)


def _port(codes, l):
    out = window_hash.window_hashes(torch.from_numpy(codes), l)
    assert out.dtype == torch.int64
    return out.numpy()


@pytest.mark.parametrize("n,lmax,l", [
    (3, 50, 11), (300, 100, 39), (64, 130, 64),   # tests/test_ops.py
    (9, 40, 1),                                    # l = 1
    (9, 40, 40),                                   # l = lmax (npos = 1)
])
def test_window_hashes_match_jax(n, lmax, l):
    codes = _codes(5, n, lmax)
    want = np.asarray(window_hashes_u32(codes, l))
    got = _port(codes, l)
    assert got.shape == want.shape == (n, lmax - l + 1)
    np.testing.assert_array_equal(got, want.astype(np.int64))


def test_window_hashes_match_pallas_interpret():
    codes = _codes(6, 300, 100)
    want = np.asarray(window_hashes_pallas(codes, 39, interpret=True))
    np.testing.assert_array_equal(_port(codes, 39), want.astype(np.int64))


# chip_smoke.py's kernel shapes (its long-read shape at 4 rows)
KERNEL_SHAPES = [(3, 50, 11), (300, 100, 39), (64, 130, 64), (5, 40, 40),
                 (7, 33, 1), (4, 4095, 63)]


def _mixed_codes(seed, n, lmax, l):
    """Rows of random lengths in [l, lmax], padded with code 4 as the
    data set pads them; returns (codes, lengths)."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(l, lmax + 1, n)
    codes = rng.integers(0, 4, (n, lmax)).astype(np.uint8)
    codes[np.arange(lmax)[None, :] >= lengths[:, None]] = 4
    return codes, lengths


def _prefix_difference_model(codes, l):
    """The CUDA kernel's arithmetic in numpy uint32: prefix hashes
    P[i] = P[i-1] * B + c[i-1] per row, then w[j] = P[j+l] - P[j] * B^l,
    mixed as (w1 * M1) xor (w2 * M2)."""
    c = (codes.astype(np.uint32) & 3) + 1
    n, lmax = codes.shape
    out = []
    for base in (window_hash._B1, window_hash._B2):
        b = np.uint32(base)
        p = np.zeros((n, lmax + 1), dtype=np.uint32)
        for i in range(lmax):
            p[:, i + 1] = p[:, i] * b + c[:, i]
        bl = np.uint32(pow(base, l, 1 << 32))
        out.append(p[:, l:] - p[:, :lmax - l + 1] * bl)
    return ((out[0] * np.uint32(window_hash._M1))
            ^ (out[1] * np.uint32(window_hash._M2))).astype(np.int64)


@pytest.mark.parametrize("n,lmax,l", KERNEL_SHAPES)
def test_prefix_difference_model_matches_plain(n, lmax, l):
    with np.errstate(over="ignore"):
        codes = _codes(11, n, lmax)
        np.testing.assert_array_equal(_prefix_difference_model(codes, l),
                                      _port(codes, l))
        codes, _ = _mixed_codes(12, n, lmax, l)
        np.testing.assert_array_equal(_prefix_difference_model(codes, l),
                                      _port(codes, l))


@pytest.mark.parametrize("n,lmax,l", KERNEL_SHAPES)
def test_window_hashes_at_is_a_gather(n, lmax, l):
    """At the pipeline's reverse-strand starts (lmax - len, lmax - l) and
    at random starts, on rows of mixed lengths."""
    codes, lengths = _mixed_codes(13, n, lmax, l)
    rng = np.random.default_rng(14)
    starts = np.stack([lmax - lengths, np.full(n, lmax - l),
                       rng.integers(0, lmax - l + 1, n)], axis=1)
    codes_t = torch.from_numpy(codes)
    starts_t = torch.from_numpy(starts.astype(np.int64))
    got = window_hash.window_hashes_at(codes_t, l, starts_t)
    want = torch.gather(window_hash.window_hashes_torch(codes_t, l), 1,
                        starts_t)
    assert got.dtype == torch.int64 and got.shape == (n, 3)
    assert torch.equal(got, want)
    assert torch.equal(window_hash.window_hashes_at_torch(codes_t, l,
                                                          starts_t), want)


@pytest.mark.parametrize("bad", [-1, 62])
def test_window_hashes_at_raises_out_of_range(bad):
    """A start outside [0, lmax - l] raises; nothing is clamped."""
    codes = torch.from_numpy(_codes(15, 4, 100))
    starts = torch.zeros((4, 2), dtype=torch.int64)
    window_hash.window_hashes_at(codes, 39, starts + 61)
    starts[2, 1] = bad
    with pytest.raises(ValueError, match="out of range"):
        window_hash.window_hashes_at(codes, 39, starts)
    with pytest.raises(ValueError, match="out of range"):
        window_hash.window_hashes_at_torch(codes, 39, starts)


def test_mul32_is_multiplication_mod_2_32():
    rng = np.random.default_rng(7)
    a = rng.integers(0, 1 << 32, 1000, dtype=np.uint64)
    b = rng.integers(0, 1 << 32, 1000, dtype=np.uint64)
    want = (a * b) & np.uint64(0xFFFFFFFF)      # uint64 wraps mod 2^64
    got = window_hash.mul32(torch.from_numpy(a.astype(np.int64)),
                            torch.from_numpy(b.astype(np.int64)))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


def test_cuda_wrapper_refuses_cpu_tensors():
    """The kernel wrappers never take a CPU tensor, and the dispatchers
    send CPU tensors to the plain versions without touching a kernel."""
    codes = torch.from_numpy(_codes(8, 4, 20))
    starts = torch.zeros((4, 2), dtype=torch.int64)
    with pytest.raises(ValueError):
        window_hash.window_hashes_cuda(codes, 5)
    with pytest.raises(ValueError):
        window_hash.window_hashes_at_cuda(codes, 5, starts)
    before = window_hash.launches, window_hash.at_launches
    window_hash.window_hashes(codes, 5)
    window_hash.window_hashes_at(codes, 5, starts)
    assert (window_hash.launches, window_hash.at_launches) == before


def test_kernel_source_and_build_rule():
    """The CUDA source ships in the package and is built for sm_90a."""
    import os
    assert os.path.exists(window_hash.SOURCE)
    assert "arch=compute_90a,code=sm_90a" in window_hash.NVCC_FLAGS
    src = open(window_hash.SOURCE).read()
    assert 'extern "C" int window_hash_launch' in src
    assert 'extern "C" int window_hash_at_launch' in src
