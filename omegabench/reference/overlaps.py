"""Every exact suffix-prefix overlap of a read, in both orientations.

An overlap of read a (as A: itself, or its reverse complement) with read b
(as B: itself, or its reverse complement) at shift d is A[d:] == B[:m] with
m = len(a) - d bases, min_overlap <= m, 1 <= d and m < len(b) (b reaches
past a's end).  Its orientation is 2 x (A is a itself) + (B is b itself),
its offset d, and its key (b * 4 + orientation) * 2^16 + d.

All strands of all reads sit in one lexicographically sorted array, so the
strands that begin with a given string are one contiguous run of it.
"""

import numpy as np

QUERY_BLOCK = 1 << 16      # suffix queries searched at once


class StrandIndex:
    def __init__(self, reads):
        self.reads = reads
        u = reads.count
        both = np.concatenate([reads.strings(reads.fwd),
                               reads.strings(reads.rev)])
        self.order = np.argsort(both, kind="stable")
        self.sorted = both[self.order]
        self.u = u

    def overlaps(self, ids, min_overlap):
        """Every overlap in which a read of `ids` comes first, in either
        of its strands: (r1, key) int64 arrays, sorted by r1 then key."""
        reads = self.reads
        ids = np.asarray(ids, np.int64)
        lmax = reads.fwd.shape[1]
        width = lmax + 1
        out_r1, out_key = [], []
        # queries: (read, strand, m) for every m in [min_overlap, len);
        # the suffix of m bases, left-aligned in `width` bytes
        lens = reads.lengths[ids - 1]
        nq = np.maximum(lens - min_overlap, 0)
        per_read = 2 * nq
        first = np.cumsum(per_read) - per_read
        total = int(per_read.sum())
        for s in range(0, total, QUERY_BLOCK):
            e = min(s + QUERY_BLOCK, total)
            q = np.arange(s, e, dtype=np.int64)
            which = np.searchsorted(first, q, side="right") - 1
            rank = q - first[which]
            fwd = (rank < nq[which]).astype(np.int64)
            m = min_overlap + np.where(fwd == 1, rank, rank - nq[which])
            r1 = ids[which]
            n = lens[which]
            # each strand zero-padded, so that the `width` bytes from
            # n - m are the suffix followed by zeros
            rows_in = np.unique(which)
            padded = np.zeros((2 * len(rows_in), lmax + width), np.uint8)
            padded[0::2, :lmax] = reads.fwd[ids[rows_in] - 1]
            padded[1::2, :lmax] = reads.rev[ids[rows_in] - 1]
            row = 2 * np.searchsorted(rows_in, which) + (1 - fwd)
            lo_q = np.lib.stride_tricks.sliding_window_view(
                padded, width, axis=1)[row, n - m]
            hi_q = lo_q.copy()
            hi_q[np.arange(len(q)), m] = 0xFF
            lo = np.searchsorted(self.sorted, lo_q.view("S%d" % width)
                                 .ravel())
            hi = np.searchsorted(self.sorted, hi_q.view("S%d" % width)
                                 .ravel())
            hits = hi - lo
            hw = np.repeat(np.arange(len(q)), hits)
            start = np.repeat(lo - np.cumsum(hits) + hits, hits)
            strand = self.order[start + np.arange(len(hw))]
            r2 = np.where(strand < self.u, strand, strand - self.u) + 1
            b_fwd = (strand < self.u).astype(np.int64)
            mm = m[hw]
            keep = mm < reads.lengths[r2 - 1]
            d = n[hw] - mm
            key = ((r2 * 4 + 2 * fwd[hw] + b_fwd) << 16) + d
            out_r1.append(r1[hw][keep])
            out_key.append(key[keep])
        r1 = np.concatenate(out_r1) if out_r1 else np.zeros(0, np.int64)
        key = np.concatenate(out_key) if out_key else np.zeros(0, np.int64)
        order = np.lexsort((key, r1))
        return r1[order], key[order]

    def rows(self, ids, min_overlap):
        """{read id: sorted int64 array of keys} for each id: the overlaps
        in which it comes first with a read numbered no lower than itself
        (the rows of the assembler's canonical overlap stream)."""
        r1, key = self.overlaps(ids, min_overlap)
        keep = (key >> 18) >= r1
        return split_rows(ids, r1[keep], key[keep])


def split_rows(ids, r1, key):
    """{id: its keys} from (r1, key) arrays sorted by r1."""
    lo = np.searchsorted(r1, ids, side="left")
    hi = np.searchsorted(r1, ids, side="right")
    return {int(r): key[s:e] for r, s, e in zip(ids, lo, hi)}
