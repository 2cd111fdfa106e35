"""Base packing, reverse complement, canonicalization and QC.

Port of metagenomics_tpu/ops/packing.py.  Rank codes (A=0, C=1, G=2, T=3,
PAD=4 past each read's length) and two halves:

* the numpy ingest kernels the Dataset runs (ASCII <-> code maps, the
  *_np twins, the lexicographic sort limbs): verbatim copies of the
  reference's host functions (tests/test_torch_host_copies.py keeps them
  equal);
* the device kernels (reverse_complement_codes, _lex_less,
  canonicalize_codes, _qc_kernel, qc_mask) as torch ops on the device of
  the tensors they are given.  JAX's gathers clamp and torch's raise, so
  the indices are clamped explicitly; torch.argmax takes no bool, so the
  first difference is found on uint8.  Ingest does not call them.
"""

import numpy as np
import torch

PAD_CODE = np.uint8(4)

# ASCII -> rank code lookup (256 entries), non-ACGT maps to 255 (invalid).
_ASCII_LUT = np.full(256, 255, dtype=np.uint8)
for _i, _b in enumerate(b"ACGT"):
    _ASCII_LUT[_b] = _i
_CODE_TO_ASCII = np.frombuffer(b"ACGT?", dtype=np.uint8).copy()


def ascii_to_codes(ascii_arr: np.ndarray, lengths: np.ndarray) -> np.ndarray:
    """Map padded ASCII bytes [N, Lmax] to rank codes; positions >= length
    become PAD_CODE, invalid characters become 255."""
    codes = _ASCII_LUT[ascii_arr]
    mask = np.arange(ascii_arr.shape[1])[None, :] < lengths[:, None]
    return np.where(mask, codes, PAD_CODE)


def codes_to_ascii(codes: np.ndarray, length: int) -> bytes:
    """Decode one row of rank codes back to an ASCII byte string."""
    return _CODE_TO_ASCII[np.asarray(codes[:length], dtype=np.uint8)].tobytes()


def reverse_complement_codes(codes, lengths):
    """Per-row reverse complement honouring each row's length, on the
    device of `codes` (uint8 [N, Lmax]); `lengths` is an integer tensor.

    rc[i, k] = 3 - codes[i, L_i - 1 - k] for k < L_i, PAD_CODE otherwise.
    (complement of rank codes is 3 - c: A<->T, C<->G; reference semantics at
    MetaGenomics/Read.cpp:115-127.)
    """
    n, lmax = codes.shape
    k = torch.arange(lmax, device=codes.device)[None, :]
    ln = lengths.to(codes.device, torch.int64)[:, None]
    src = torch.clamp(ln - 1 - k, 0, lmax - 1)
    gathered = torch.gather(codes, 1, src)
    return torch.where(k < ln, 3 - gathered, int(PAD_CODE)).to(torch.uint8)


def _lex_less(a, b):
    """Row-wise lexicographic a < b for equal-shape padded code tensors."""
    neq = a != b
    # index of first difference; lmax if equal (argmax returns the first
    # maximal index, and takes no bool)
    lmax = a.shape[1]
    first = torch.where(neq.any(dim=1), torch.argmax(neq.to(torch.uint8),
                                                     dim=1), lmax)
    idx = torch.clamp(first, 0, lmax - 1)[:, None]
    av = torch.gather(a, 1, idx)[:, 0]
    bv = torch.gather(b, 1, idx)[:, 0]
    return (first < lmax) & (av < bv)


def canonicalize_codes(codes, lengths):
    """Return (canonical_codes, was_reversed): the lexicographically smaller
    of each read and its reverse complement (reference: Dataset.cpp:164-167).

    Matches the reference's tie handling: if read == rc the *reverse* is
    stored (strict less-than keeps the forward only when forward < rc).
    """
    rc = reverse_complement_codes(codes, lengths)
    fwd_less = _lex_less(codes, rc)
    out = torch.where(fwd_less[:, None], codes, rc)
    return out.to(torch.uint8), ~fwd_less


def _qc_kernel(codes, lengths, thresholds, min_overlap):
    valid_pos = (torch.arange(codes.shape[1], device=codes.device)[None, :]
                 < lengths[:, None])
    ok_chars = torch.where(valid_pos, codes <= 3, True).all(dim=1)
    counts = torch.stack(
        [(valid_pos & (codes == c)).sum(dim=1) for c in range(4)], dim=1)
    not_lowcomp = (counts < thresholds[:, None]).all(dim=1)
    return ok_chars & not_lowcomp & (lengths > min_overlap)


def qc_mask(codes, lengths, min_overlap: int):
    """Good-read mask (reference: Dataset.cpp:160 and testRead at :398-413)
    on the device of `codes`.

    A read is good iff length > min_overlap, all chars in {A,C,G,T}, and no
    single base accounts for >= trunc(len * 0.8) positions.  The threshold is
    computed host-side in float64 to replicate the C++ double->integer
    truncation exactly (not in float32 on the device).
    """
    lens = lengths.cpu().numpy()
    thresholds = np.trunc(lens.astype(np.float64) * 0.8).astype(np.int64)
    return _qc_kernel(codes, lengths.to(codes.device, torch.int64),
                      torch.from_numpy(thresholds).to(codes.device),
                      min_overlap)


def reverse_complement_codes_np(codes: np.ndarray,
                                lengths: np.ndarray,
                                out: np.ndarray = None) -> np.ndarray:
    """Host (numpy) twin of reverse_complement_codes — identical semantics,
    no XLA compile cost.  Used on the ingest path; tests assert equality
    with the device kernel.  Pass `out` (may be a view) to fill a
    preallocated destination without a full-size transient."""
    n, lmax = codes.shape
    lengths = np.asarray(lengths)
    if out is None:
        out = np.empty((n, lmax), dtype=np.uint8)
    if n and int(lengths.min()) == lmax:
        # uniform-length fast path: no padding anywhere, RC is a mirror.
        # chunked subtract-into-out keeps transients row-block bounded
        # (one full-size intermediate would add ~2x the code bytes of
        # peak RSS at metagenome scale)
        step = 1 << 16
        for s in range(0, n, step):
            e = min(s + step, n)
            np.subtract(3, codes[s:e, ::-1], out=out[s:e])
        return out
    k = np.arange(lmax)[None, :]
    # row-chunked: the [rows, lmax] int64 index matrix would be 8x the
    # code bytes if built for the whole dataset at once
    step = 1 << 16
    for s in range(0, max(n, 1), step):
        e = min(s + step, n)
        ln = lengths[s:e, None]
        src = np.maximum(ln - 1 - k, 0)     # k >= 0 keeps src < lmax
        gathered = np.take_along_axis(codes[s:e], src, axis=1)
        out[s:e] = np.where(k < ln, 3 - gathered, PAD_CODE)
    return out


def _lex_less_np(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    lmax = a.shape[1]
    neq = a != b
    first = np.where(neq.any(axis=1), neq.argmax(axis=1), lmax)
    idx = np.clip(first, 0, lmax - 1)
    av = np.take_along_axis(a, idx[:, None], axis=1)[:, 0]
    bv = np.take_along_axis(b, idx[:, None], axis=1)[:, 0]
    return (first < lmax) & (av < bv)


def canonicalize_codes_np(codes: np.ndarray, lengths: np.ndarray):
    """Host twin of canonicalize_codes (same tie handling)."""
    rc = reverse_complement_codes_np(codes, lengths)
    fwd_less = _lex_less_np(codes, rc)
    out = np.where(fwd_less[:, None], codes, rc).astype(np.uint8)
    return out, ~fwd_less


def qc_mask_np(codes: np.ndarray, lengths: np.ndarray,
               min_overlap: int) -> np.ndarray:
    """Host twin of qc_mask (thresholds already float64-exact on host).

    Padding is PAD_CODE and invalid characters are 255 — neither aliases a
    base code 0..3 — so per-base counts need no position mask, and
    "every in-length char is a base" is exactly sum(counts) == length
    (saves five full-matrix temporaries per ingest chunk)."""
    thresholds = np.trunc(
        np.asarray(lengths, dtype=np.float64) * 0.8).astype(np.int64)
    counts = np.stack([(codes == c).sum(axis=1, dtype=np.int64)
                       for c in range(4)], axis=1)
    ok_chars = counts.sum(axis=1) == lengths
    not_lowcomp = (counts < thresholds[:, None]).all(axis=1)
    return ok_chars & not_lowcomp & (lengths > min_overlap)


def codes_to_ascii_all(codes: np.ndarray) -> np.ndarray:
    """Decode a whole [N, Lmax] code array to ASCII bytes in one gather."""
    return _CODE_TO_ASCII[np.ascontiguousarray(codes)]


def pack_sort_limbs(codes: np.ndarray, lengths: np.ndarray) -> np.ndarray:
    """Pack rank codes into big-endian uint64 limbs for lexicographic sorting.

    Each limb holds 8 bases at 8 bits (code+1 so that PAD sorts before any
    base, giving std::string prefix-compare semantics).  np.lexsort /
    searchsorted over the limb columns then reproduces the reference's
    lexicographic read sort (Dataset.cpp:197-202) exactly.
    """
    n, lmax = codes.shape
    nlimb = (lmax + 7) // 8
    # byte-wise pack: a big-endian 8-byte view IS the shifted sum, without
    # the [n, lmax] uint64 transients (8x the bytes) the naive pack makes
    out8 = np.zeros((n, nlimb * 8), dtype=np.uint8)
    np.add(codes, 1, out=out8[:, :lmax], where=(
        np.arange(lmax)[None, :] < lengths[:, None]), casting="unsafe")
    return out8.view(">u8").astype(np.uint64)
