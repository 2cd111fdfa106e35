"""Verification of overlap / containment candidates as torch ops.

Port of metagenomics_tpu/ops/overlap.py: each candidate (r1, j, r2, orient)
implies two windows, gathered from the padded code arrays and compared
under a length mask, on one explicit torch.device.

Window derivation (l = hash string length = minOverlap - 1, string2 is the
forward strand of r2 for orient 0/1 and the reverse strand for orient 2/3);
each window INCLUDES the seed, giving the reference's accept set while
rejecting hash collisions:

  edge mode (checkOverlap, OverlapGraph.cpp:354-383):
    orient 0/2: needs len1 - j < len2;  window r1[j : len1]    == s2[0 : len1-j]
    orient 1/3: needs len2 - l >= j;    window r1[0 : j+l]     == s2[len2-l-j : len2]
  containment mode (checkOverlapForContainedRead, :302-340), m = len2 - l:
    orient 0/2: needs len1-j-l >= m;    window r1[j : j+len2]  == s2[0 : len2]
    orient 1/3: needs j >= m;           window r1[j-m : j+l]   == s2[0 : len2]
"""

from dataclasses import dataclass

import numpy as np
import torch


@dataclass
class CandidateBatch:
    """A flat batch of hash-hit candidates in reference discovery order
    (read id ascending, substring position j ascending, bucket order k)."""

    r1: np.ndarray      # int32 read id of the probing read
    j: np.ndarray       # int32 substring start position in r1's forward string
    r2: np.ndarray      # int32 read id of the indexed read
    orient: np.ndarray  # uint8 0..3 (prefix/suffix of forward/reverse)

    def __len__(self):
        return len(self.r1)


def _window_equal(str1, str2, s1, s2, m, lmax):
    """Row-wise: str1[i, s1[i]:s1[i]+m[i]] == str2[i, s2[i]:s2[i]+m[i]]."""
    k = torch.arange(lmax, device=str1.device)[None, :]
    i1 = torch.clamp(s1[:, None] + k, 0, lmax - 1)
    i2 = torch.clamp(s2[:, None] + k, 0, lmax - 1)
    a = torch.gather(str1, 1, i1)
    b = torch.gather(str2, 1, i2)
    mask = k < m[:, None]
    return torch.where(mask, a == b, True).all(dim=1)


def _verify_kernel(codes_fwd, codes_rev, lengths, r1, j, r2, orient,
                   hash_len, mode):
    l = hash_len
    len1 = lengths[r1]
    len2 = lengths[r2]
    str1 = codes_fwd[r1]
    fwd2 = codes_fwd[r2]
    rev2 = codes_rev[r2]
    str2 = torch.where((orient <= 1)[:, None], fwd2, rev2)
    is_pre = (orient == 0) | (orient == 2)

    zeros = torch.zeros_like(j)
    if mode == "edge":
        ok_pre = len1 - j < len2
        s1_pre, s2_pre, m_pre = j, zeros, len1 - j
        ok_suf = len2 - l >= j
        s1_suf, s2_suf, m_suf = zeros, len2 - l - j, j + l
    else:  # containment
        m2 = len2 - l
        ok_pre = len1 - j - l >= m2
        s1_pre, s2_pre, m_pre = j, zeros, len2
        ok_suf = j >= m2
        s1_suf, s2_suf, m_suf = j - m2, zeros, len2

    ok = torch.where(is_pre, ok_pre, ok_suf)
    s1 = torch.clamp(torch.where(is_pre, s1_pre, s1_suf), min=0)
    s2 = torch.clamp(torch.where(is_pre, s2_pre, s2_suf), min=0)
    m = torch.where(ok, torch.where(is_pre, m_pre, m_suf), 0)
    eq = _window_equal(str1, str2, s1, s2, m, codes_fwd.shape[1])
    return ok & eq


def verify_candidates(
    codes_fwd: np.ndarray,
    codes_rev: np.ndarray,
    lengths: np.ndarray,
    batch: CandidateBatch,
    hash_len: int,
    mode: str = "edge",
    chunk: int = 1 << 16,
    device=None,
) -> np.ndarray:
    """Verify a candidate batch on `device` (default: the pipeline's
    device, ops.device_overlap.torch_device), chunked to bound memory.

    Returns a bool array aligned with the batch.
    """
    assert mode in ("edge", "containment")
    if device is None:
        from .device_overlap import torch_device
        device = torch_device()
    n = len(batch)
    out = np.empty(n, dtype=bool)
    cf = torch.from_numpy(np.ascontiguousarray(codes_fwd)).to(device)
    cr = torch.from_numpy(np.ascontiguousarray(codes_rev)).to(device)
    ln = torch.from_numpy(lengths.astype(np.int64)).to(device)

    def col(a, s, e):
        return torch.from_numpy(np.asarray(a[s:e], np.int64)).to(device)

    for s in range(0, n, chunk):
        e = min(n, s + chunk)
        ok = _verify_kernel(cf, cr, ln, col(batch.r1, s, e),
                            col(batch.j, s, e), col(batch.r2, s, e),
                            col(batch.orient, s, e), hash_len, mode)
        out[s:e] = ok.cpu().numpy()
    return out
