"""Driver entry points of the port: the counterpart of __graft_entry__.py.

entry(device) returns (fn, args): the batched overlap-verification kernel
(ops/overlap._verify_kernel, edge mode, l = 11) and tiny random reads made
exactly as the reference's entry() makes them, as tensors on `device`.
dryrun_multichip and ARTIFACTS are parallel/dryrun.py's.
"""

import numpy as np
import torch

from .ops.device_overlap import torch_device
from .ops.overlap import _verify_kernel
from .ops.packing import reverse_complement_codes
from .parallel.dryrun import ARTIFACTS, dryrun_multichip

__all__ = ["entry", "dryrun_multichip", "ARTIFACTS"]


def _tiny_reads(n=64, lmax=48, seed=0):
    rng = np.random.default_rng(seed)
    lengths = rng.integers(24, lmax + 1, n).astype(np.int32)
    codes = rng.integers(0, 4, (n, lmax)).astype(np.uint8)
    codes = np.where(np.arange(lmax)[None, :] < lengths[:, None], codes, 4)
    return codes, lengths


def entry(device=None):
    """(fn, args): fn(*args) verifies 128 random candidate pairs of 64
    reads; args are tensors on `device` (MGTPU_TORCH_DEVICE, cuda by
    default)."""
    device = torch_device() if device is None else torch.device(device)
    codes, lengths = _tiny_reads()
    m = 128
    rng = np.random.default_rng(1)
    r1 = rng.integers(0, len(codes), m).astype(np.int32)
    r2 = rng.integers(0, len(codes), m).astype(np.int32)
    j = rng.integers(1, 8, m).astype(np.int32)
    orient = rng.integers(0, 4, m).astype(np.int32)

    def fn(codes, rev, lengths, r1, j, r2, orient):
        return _verify_kernel(codes, rev, lengths, r1, j, r2, orient,
                              hash_len=11, mode="edge")

    codes_t = torch.from_numpy(codes).to(device)
    lengths_t = torch.from_numpy(lengths).to(device)
    rev = reverse_complement_codes(codes_t, lengths_t)
    args = (codes_t, rev, lengths_t,
            *(torch.from_numpy(a).to(device) for a in (r1, j, r2, orient)))
    return fn, args
