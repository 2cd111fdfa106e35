"""l-mer prefix/suffix index and candidate join.

The reference builds an open-addressing hash table with 4 entries per read —
prefix/suffix of the forward and reverse strands, tagged orient 0..3
(MetaGenomics/HashTable.cpp:88-104) — and probes it with every proper
substring of every read (OverlapGraph.cpp:529-565, :225-290).  A bucket holds
all entries sharing one exact l-mer, in insertion order (read id ascending,
orient 0..3 within a read).

Here the 4U index l-mers and all query windows are packed into 2-bit limbs
ON DEVICE (ops/kmer.py), mixed into 64-bit hashes, and joined with a sorted
uint64 searchsorted — fully vectorized.  Hash collisions are harmless:
verification compares the whole window including the seed (ops/overlap.py),
so spurious candidates are rejected exactly like a failed extension check.
Within a hash bucket the stable sort preserves (read id, orient) order, so
the verified subset appears in exactly the reference's bucket order.
"""

import numpy as np

from .ops.overlap import CandidateBatch
from .ops.kmer import all_window_hashes


class OverlapIndex:
    def __init__(self, dataset, min_overlap: int):
        self.dataset = dataset
        self.hash_len = min_overlap - 1
        l = self.hash_len
        u = dataset.number_of_unique_reads
        lens = dataset.lengths

        # all window hashes for forward and reverse strands (device)
        self.q_hashes = all_window_hashes(dataset.codes_fwd, l)  # [U+1, npos]
        rev_hashes = all_window_hashes(dataset.codes_rev, l)
        npos = self.q_hashes.shape[1]

        # 4 index keys per read in (read, orient) order: prefix-fwd,
        # suffix-fwd, prefix-rev, suffix-rev (HashTable.cpp:98-101).
        rows = np.arange(1, u + 1)
        suf = lens[1:] - l
        keys = np.empty(4 * u, dtype=np.uint64)
        keys[0::4] = self.q_hashes[rows, 0]
        keys[1::4] = self.q_hashes[rows, suf]
        keys[2::4] = rev_hashes[rows, 0]
        keys[3::4] = rev_hashes[rows, suf]

        rid = np.repeat(rows, 4)
        orient = np.tile(np.arange(4, dtype=np.uint8), u)
        order = np.argsort(keys, kind="stable")
        self.sorted_keys = keys[order]
        self.sorted_rid = rid[order].astype(np.int64)
        self.sorted_orient = orient[order]

        # membership bitmap over the low hash bits: rejects the vast majority
        # of non-matching queries before the binary search (false positives
        # are resolved by the search itself).
        self._bloom_bits = 27
        bloom = np.zeros(1 << (self._bloom_bits - 3), dtype=np.uint8)
        low = (self.sorted_keys & np.uint64((1 << self._bloom_bits) - 1))
        np.bitwise_or.at(bloom, (low >> np.uint64(3)).astype(np.int64),
                         np.uint8(1) << (low & np.uint64(7)).astype(np.uint8))
        self._bloom = bloom

    def candidates(self, read_ids=None) -> CandidateBatch:
        """All hash hits for every proper substring of the given reads
        (default: all), in reference discovery order (read asc, j asc,
        bucket order)."""
        ds = self.dataset
        l = self.hash_len
        if read_ids is None:
            read_ids = np.arange(1, ds.number_of_unique_reads + 1)
        read_ids = np.asarray(read_ids, dtype=np.int64)
        lens = ds.lengths[read_ids]
        npos = self.q_hashes.shape[1]
        # valid j range: 1 .. len - l - 1 (row-major scan = i asc, j asc)
        jj = np.arange(npos)[None, :]
        valid = (jj >= 1) & (jj < (lens[:, None] - l))
        qh = self.q_hashes[read_ids]
        # bitmap prefilter
        low = qh & np.uint64((1 << self._bloom_bits) - 1)
        maybe = (self._bloom[(low >> np.uint64(3)).astype(np.int64)]
                 >> (low & np.uint64(7)).astype(np.uint8)) & 1
        valid &= maybe.astype(bool)
        ii, jpos = np.nonzero(valid)
        if len(ii) == 0:
            z = np.zeros(0, np.int64)
            return CandidateBatch(z, z, z, np.zeros(0, np.uint8))
        i_arr = read_ids[ii]
        q = qh[ii, jpos]

        left = np.searchsorted(self.sorted_keys, q, side="left")
        right = np.searchsorted(self.sorted_keys, q, side="right")
        counts = right - left
        nz = counts > 0
        i_arr, jpos, left, counts = i_arr[nz], jpos[nz], left[nz], counts[nz]
        if len(counts) == 0:
            # every probe missed (bloom false positives only) — the repeat
            # broadcast below needs at least one row
            z = np.zeros(0, np.int64)
            return CandidateBatch(z, z, z, np.zeros(0, np.uint8))

        r1 = np.repeat(i_arr, counts)
        j = np.repeat(jpos, counts)
        total = int(counts.sum())
        within = np.arange(total) - np.repeat(
            np.concatenate(([0], np.cumsum(counts)[:-1])), counts)
        src = np.repeat(left, counts) + within
        return CandidateBatch(
            r1=r1, j=j, r2=self.sorted_rid[src], orient=self.sorted_orient[src])
