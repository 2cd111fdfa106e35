"""l-mer window packing for the host engine, as torch ops.

Port of metagenomics_tpu/ops/kmer.py: every length-l window of every read
is packed into limbs of 16 bases at 2 bits each (big-endian within a
limb) on one explicit torch.device, and the host mixes the limbs into one
64-bit hash for the sorted join of index.py.  Hash collisions are harmless
because verification compares the whole window including the seed
(ops/overlap.py).

The limbs are uint32 values held in int64 tensors (torch's uint32 has few
ops).  A limb is built by Horner steps, one window base at a time, so no
[N, npos, l] tensor is materialized: sixteen 2-bit digits never exceed
2^32 - 1, which int64 holds exactly.
"""

import numpy as np
import torch

from .window_hash import MASK32

BASES_PER_LIMB = 16

# odd 64-bit mixing constants (splitmix64 / xxhash style)
_MIX = np.array([0x9E3779B97F4A7C15, 0xC2B2AE3D27D4EB4F, 0x165667B19E3779F9,
                 0x27D4EB2F165667C5], dtype=np.uint64)


def window_limbs(codes, hash_len):
    """[N, npos, nlimb] int64 limbs (values < 2^32) of uint8 codes
    [N, lmax], on the codes' device.

    Window w at (i, p) covers codes[i, p : p+hash_len]; limb k packs bases
    [16k, 16k+16) big-endian 2-bit.  Padding codes (PAD_CODE=4) poison the
    limb value (4 & 3 = 0), but such windows are masked out by the caller
    via lengths.  As in the reference, npos is at least 1 and window
    columns past lmax - 1 read column lmax - 1 (JAX's gather clamps).
    """
    n, lmax = codes.shape
    l = hash_len
    npos = max(lmax - l + 1, 1)
    nlimb = (l + BASES_PER_LIMB - 1) // BASES_PER_LIMB
    pos = torch.arange(npos, device=codes.device)
    limbs = []
    for k in range(nlimb):
        limb = torch.zeros((n, npos), dtype=torch.int64, device=codes.device)
        for t in range(k * BASES_PER_LIMB, min(l, (k + 1) * BASES_PER_LIMB)):
            col = codes[:, torch.clamp(pos + t, max=lmax - 1)] & 3
            limb = limb * 4 + col
        limbs.append(limb & MASK32)
    return torch.stack(limbs, dim=-1)


def mix_limbs(limbs: np.ndarray) -> np.ndarray:
    """Host: fold uint32 limbs [..., nlimb] into one uint64 hash."""
    limbs = np.asarray(limbs)
    h = np.zeros(limbs.shape[:-1], dtype=np.uint64)
    for k in range(limbs.shape[-1]):
        h ^= limbs[..., k].astype(np.uint64) * _MIX[k % len(_MIX)]
    return h


def all_window_hashes(codes: np.ndarray, hash_len: int,
                      chunk: int = 1 << 14, device=None) -> np.ndarray:
    """uint64 window hashes [N, npos] computed on `device` (default: the
    pipeline's device, ops.device_overlap.torch_device) in row chunks."""
    if device is None:
        from .device_overlap import torch_device
        device = torch_device()
    n = codes.shape[0]
    outs = []
    cj = torch.from_numpy(np.ascontiguousarray(codes)).to(device)
    for s in range(0, n, chunk):
        limbs = window_limbs(cj[s:s + chunk], hash_len)
        outs.append(mix_limbs(limbs.cpu().numpy().astype(np.uint32)))
    return np.concatenate(outs, axis=0) if outs else np.zeros(
        (0, 1), dtype=np.uint64)
