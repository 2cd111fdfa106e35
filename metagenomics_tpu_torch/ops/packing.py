"""Host (numpy) half of metagenomics_tpu/ops/packing.py.

Rank codes (A=0, C=1, G=2, T=3, PAD=4 past each read's length) and the
numpy ingest kernels the Dataset runs: ASCII <-> code maps, reverse
complement, canonicalization, QC and the lexicographic sort limbs.  The
bodies are verbatim copies of the reference's host functions
(tests/test_torch_host_copies.py keeps them equal).  The device twins
(reverse_complement_codes, canonicalize_codes, qc_mask) are not ported:
ingest never calls them.
"""

import numpy as np

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
