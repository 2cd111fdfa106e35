"""The port's plain window hash (window_hashes_torch) against the JAX
package's rolling hash and its Pallas kernel (interpret mode), on inputs
made with numpy from fixed seeds.  Every value is an integer, so the
tolerance is exact equality."""

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


def test_mul32_is_multiplication_mod_2_32():
    rng = np.random.default_rng(7)
    a = rng.integers(0, 1 << 32, 1000, dtype=np.uint64)
    b = rng.integers(0, 1 << 32, 1000, dtype=np.uint64)
    want = (a * b) & np.uint64(0xFFFFFFFF)      # uint64 wraps mod 2^64
    got = window_hash.mul32(torch.from_numpy(a.astype(np.int64)),
                            torch.from_numpy(b.astype(np.int64)))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


def test_cuda_wrapper_refuses_cpu_tensors():
    """The kernel wrapper never takes a CPU tensor, and the dispatcher
    sends CPU tensors to the plain version without touching the kernel."""
    codes = torch.from_numpy(_codes(8, 4, 20))
    with pytest.raises(ValueError):
        window_hash.window_hashes_cuda(codes, 5)
    before = window_hash.launches
    window_hash.window_hashes(codes, 5)
    assert window_hash.launches == before


def test_kernel_source_and_build_rule():
    """The CUDA source ships in the package and is built for sm_90a."""
    import os
    assert os.path.exists(window_hash.SOURCE)
    assert "arch=compute_90a,code=sm_90a" in window_hash.NVCC_FLAGS
    src = open(window_hash.SOURCE).read()
    assert 'extern "C" int window_hash_launch' in src
