"""Contained reads and their super reads, from the sequences alone.

The assembler's rule (markContainedReads, OverlapGraph.cpp:225-290, with
checkOverlapForContainedRead, :302-340):

- A unique read b is contained where it occurs exactly, on either strand,
  inside a strictly longer unique read a: b or its reverse complement
  equals a[p:p + len(b)] for some p with 0 <= p <= len(a) - len(b).  Two
  unique canonical reads of one length never contain each other, so a
  sample of one length has no contained read.
- Every such placement is found, the prefix (p = 0) and the suffix
  (p = len(a) - len(b)) ones too.  The assembler probes each substring of
  l = min_overlap - 1 bases of a's forward strand at 1 <= j < len(a) - l,
  never a's own first or last l-mer, against four keys of every read: the
  first and the last l-mer of each of its strands.  b's strand placed at p
  is found through its first l-mer at j = p, which needs p >= 1, and
  through its last l-mer at j = p + len(b) - l, which needs
  p <= len(a) - len(b) - 1 (and j >= 1, which len(b) > l gives).  As
  len(a) > len(b), the two reach every p from 0 to len(a) - len(b).
- Its super read: hits come in discovery order, the probing read a
  ascending; the first container is kept and a strictly longer one
  replaces it.  So b's super read is the lowest-numbered of its longest
  containers.  A contained read may contain others in turn, and be a super
  read.

Read ids are the ingest reference's (reference/ingest.py), from 1.
"""

import numpy as np

K = 32                 # bases packed into one uint64 key
BLOCK = 1 << 12        # containers searched at once
CODE = np.zeros(256, np.uint8)
CODE[np.frombuffer(b"ACGT", np.uint8)] = np.arange(4, dtype=np.uint8)


def window_keys(mat, k):
    """[n, w - k + 1] uint64: the 2-bit codes of bases p .. p + k - 1 of
    each row of an ASCII matrix [n, w], one key per start p."""
    codes = CODE[mat]
    n, w = codes.shape
    nw = w - k + 1
    out = np.zeros((n, nw), np.uint64)
    q, r = divmod(k, 4)
    if q:
        # four bases a byte first, then a byte a pass
        quad = np.zeros((n, w - 3), np.uint8)
        for i in range(4):
            quad <<= np.uint8(2)
            quad |= codes[:, i:i + w - 3]
        for i in range(q):
            out <<= np.uint64(8)
            out |= quad[:, 4 * i:4 * i + nw]
    for i in range(4 * q, k):
        out <<= np.uint64(2)
        out |= codes[:, i:i + nw]
    return out


def supers(reads, first_wins=False):
    """int64 [reads.count + 1]: each read's super read, 0 where it is not
    contained.  With first_wins, the lowest-numbered container of any
    length instead (the rule broken: a longer container never replaces a
    first one)."""
    u = reads.count
    lens = reads.lengths
    lmax = int(lens.max()) if u else 0
    out = np.zeros(u + 1, np.int64)
    if u == 0 or int(lens.min()) == lmax:
        return out
    k = min(K, int(lens.min()))
    # queries: both strands of every read shorter than the longest, each
    # as the keys of its chunks at 0, k, 2k, ... and its last one at
    # len - k (chunks overlap there; a short query repeats its last)
    q_id = np.flatnonzero(lens < lmax) + 1
    q_len = lens[q_id - 1]
    n_chunks = -(-lmax // k)
    offs = np.minimum(np.arange(n_chunks)[None, :] * k,
                      (q_len - k)[:, None])
    chunks = []
    for strand in (reads.fwd, reads.rev):
        keys = np.empty((len(q_id), n_chunks), np.uint64)
        for s in range(0, len(q_id), BLOCK):
            e = min(s + BLOCK, len(q_id))
            win = window_keys(strand[q_id[s:e] - 1], k)
            keys[s:e] = np.take_along_axis(win, offs[s:e], axis=1)
        chunks.append(keys)
    chunks = np.concatenate(chunks)
    offs = np.concatenate([offs, offs])
    q_id = np.concatenate([q_id, q_id])
    q_len = np.concatenate([q_len, q_len])
    # containers by length, longest first: a read's longest containers
    # are those of the first length that holds one
    for length in np.unique(lens)[::-1]:
        active = q_len < length
        if not first_wins:
            active &= out[q_id] == 0
        act = np.flatnonzero(active)
        if not len(act):
            continue
        act = act[np.argsort(chunks[act, 0], kind="stable")]
        # the distinct first keys, each with its run of queries in act
        first, run0, runs = np.unique(chunks[act, 0], return_index=True,
                                      return_counts=True)
        found = np.zeros(u + 1, np.int64)
        cont = np.flatnonzero(lens == length) + 1
        for s in range(0, len(cont), BLOCK):
            _contain(reads, cont[s:s + BLOCK], k, act, (first, run0, runs),
                     chunks, offs, q_id, q_len, found)
        new = found > 0
        if first_wins:
            new &= (out == 0) | (found < out)
        out[new] = found[new]
    return out


def _contain(reads, cont, k, act, runs, chunks, offs, q_id, q_len, found):
    """Containers `cont` (one length) against the active queries `act`,
    sorted by their first chunk's key (runs: each distinct key, where its
    run starts in act, its length): for each read contained in one of
    them, the lowest container id into `found` (0: none yet)."""
    length = int(reads.lengths[cont[0] - 1])
    win = window_keys(reads.fwd[cont - 1, :length], k)
    keys, run0, run_len = runs
    at = np.minimum(np.searchsorted(keys, win.ravel()), len(keys) - 1)
    hit = keys[at] == win.ravel()
    hits = np.where(hit, run_len[at], 0)
    lo = run0[at]
    if not hits.any():
        return
    at = np.repeat(np.arange(len(lo)), hits)       # flat window index
    q = act[np.repeat(lo - np.cumsum(hits) + hits, hits)
            + np.arange(len(at))]
    t, p = np.divmod(at, win.shape[1])
    fit = p + q_len[q] <= length
    t, p, q = t[fit], p[fit], q[fit]
    same = np.ones(len(q), bool)
    for c in range(1, chunks.shape[1]):
        same &= win[t, p + offs[q, c]] == chunks[q, c]
    rid, tid = q_id[q[same]], cont[t[same]]
    order = np.lexsort((tid, rid))
    rid, tid = rid[order], tid[order]
    head = np.ones(len(rid), bool)
    head[1:] = rid[1:] != rid[:-1]
    rid, tid = rid[head], tid[head]
    better = (found[rid] == 0) | (tid < found[rid])
    found[rid[better]] = tid[better]


def without_contained(found, sup):
    """The overlaps found (r1, key) whose two reads are both
    non-contained; all of them where sup is None."""
    if sup is None:
        return found
    r1, key = found
    keep = (sup[r1] == 0) & (sup[key >> 18] == 0)
    return r1[keep], key[keep]
