"""Reads as the assembler keeps them: quality-checked, canonical, sorted,
deduplicated, numbered from 1."""

import numpy as np

COMPLEMENT = np.zeros(256, dtype=np.uint8)
COMPLEMENT[np.frombuffer(b"ACGT", np.uint8)] = np.frombuffer(b"TGCA",
                                                             np.uint8)


class Reads:
    """Unique canonical reads in lexicographic order: read i (from 1) is
    row i - 1 of `fwd` ([u, lmax] uint8 ASCII, zero-padded), `rev` its
    reverse complement (also left-aligned), `lengths` its length."""

    def __init__(self, fwd, lengths):
        self.fwd = fwd
        self.lengths = lengths
        self.rev = reverse_complement(fwd, lengths)

    @property
    def count(self):
        return len(self.lengths)

    def strings(self, matrix):
        """Rows of a padded matrix as a fixed-width byte-string array."""
        return np.ascontiguousarray(matrix).view(
            "S%d" % matrix.shape[1]).ravel()


def reverse_complement(mat, lengths):
    """Row-wise reverse complement of a zero-padded ASCII matrix, each row
    left-aligned at its own length."""
    n, lmax = mat.shape
    k = np.arange(lmax)[None, :]
    src = np.clip(lengths[:, None] - 1 - k, 0, lmax - 1)
    out = COMPLEMENT[np.take_along_axis(mat, src, axis=1)]
    return np.where(k < lengths[:, None], out, 0).astype(np.uint8)


def read_fasta(path):
    """Sequences of a two-line FASTA file (one header line, one sequence
    line a record), upper-cased: (zero-padded uint8 matrix, lengths)."""
    with open(path, "rb") as f:
        data = f.read().upper()
    if not data.endswith(b"\n"):
        data += b"\n"
    arr = np.frombuffer(data, dtype=np.uint8)
    nl = np.flatnonzero(arr == ord("\n"))
    starts = np.concatenate([[0], nl[:-1] + 1])
    if len(starts) % 2 or not (arr[starts[0::2]] == ord(">")).all():
        raise ValueError("%s is not a two-line FASTA file" % path)
    s0 = starts[1::2]
    lengths = nl[1::2] - s0
    lmax = int(lengths.max()) if len(lengths) else 0
    k = np.arange(lmax)[None, :]
    pos = np.minimum(s0[:, None] + k, len(arr) - 1)
    mat = np.where(k < lengths[:, None], arr[pos], 0).astype(np.uint8)
    return mat, lengths.astype(np.int64)


def passes_qc(mat, lengths, min_overlap):
    """The assembler's read test: only A, C, G and T; no base in 80% or
    more of the read (the count against the truncated 0.8 x length); longer
    than the minimum overlap."""
    counts = np.stack([(mat == b).sum(axis=1) for b in b"ACGT"], axis=1)
    only_bases = counts.sum(axis=1) == lengths
    threshold = np.trunc(lengths * 0.8).astype(np.int64)
    return (only_bases & (counts < threshold[:, None]).all(axis=1)
            & (lengths > min_overlap))


def load(paths, min_overlap):
    """The unique canonical reads of all files, as the assembler numbers
    them."""
    mats, lens = [], []
    for p in paths:
        m, ln = read_fasta(p)
        keep = passes_qc(m, ln, min_overlap)
        mats.append(m[keep])
        lens.append(ln[keep])
    lmax = max(m.shape[1] for m in mats)
    mat = np.concatenate([np.pad(m, ((0, 0), (0, lmax - m.shape[1])))
                          for m in mats])
    lengths = np.concatenate(lens)
    fwd = mat.view("S%d" % lmax).ravel()
    rev = reverse_complement(mat, lengths).view("S%d" % lmax).ravel()
    canon = np.where(fwd <= rev, fwd, rev)
    uniq = np.unique(canon)
    out = uniq.view(np.uint8).reshape(len(uniq), lmax)
    return Reads(out, (out != 0).sum(axis=1).astype(np.int64))
