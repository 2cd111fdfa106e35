"""The overlap graph that construction leaves, read by read.

Construction keeps a read's overlaps less those that are transitive: the
overlap of r with x goes where some other overlap partner v of r, placed
before x along the same strand of r, overlaps x in turn (Myers' string
graph; the assembler drops every overlap of r with such an x, whatever
its orientation).  Along a strand of r, every partner sits at its offset d
from r's start, so v overlaps x exactly where d_v < d_x and the part of v
beyond r's end is a prefix of the part of x beyond it.  The overlaps that
stay are r's links in the graph: where its reads lie one after the other
along an edge.

Contained reads (reference/contained.py) take no part: where `sup` is
given, every overlap with a contained read at either end is left out
before the reduction, so a contained read keeps no link and is never
required in the graph.

A read that keeps exactly one overlap on each side of it lies inside a
chain of such reads, which construction merges into one edge; an edge of
more than `dead_end_length` reads is never removed as a dead end, so the
reads of a chain that long (or of a closed cycle) are in the graph.
"""

import numpy as np

from omegabench.reference.contained import without_contained
from omegabench.reference.overlaps import split_rows


class Reduced:
    def __init__(self, index, min_overlap, sup=None):
        self.index = index
        self.reads = index.reads
        self.min_overlap = min_overlap
        self.sup = sup         # super read by id, or None: none contained
        self.links = {}        # id: sorted keys of the overlaps it keeps
        self.degree = {}       # id: (kept after its forward strand, before)

    def compute(self, ids, overlaps=None):
        """Fill links and degree for every id not computed yet; overlaps,
        where given, are index.overlaps(ids) already found."""
        if overlaps is None:
            ids = np.array(sorted({int(i) for i in ids} - set(self.links)),
                           np.int64)
            if not len(ids):
                return
            overlaps = self.index.overlaps(ids, self.min_overlap)
        ids = np.asarray(ids, np.int64)
        r1, key = without_contained(overlaps, self.sup)
        kept = keep_irreducible(self.reads, r1, key)
        rows = split_rows(ids, r1[kept], key[kept])
        for r in ids.tolist():
            k = rows[r]
            fwd = int((((k >> 17) & 1) == 1).sum())
            self.links[r] = k
            self.degree[r] = (fwd, len(k) - fwd)

    def must_be_present(self, ids, dead_end_length):
        """The ids whose chain of one-overlap-a-side reads holds more than
        dead_end_length reads, or closes into a cycle."""
        self.compute(ids)
        limit = dead_end_length + 1
        walks = {}
        for r in ids:
            r = int(r)
            if self.degree[r] == (1, 1):
                # one cursor a side: (read, strand along which to go on)
                walks[r] = [1, [(r, 1), (r, 0)]]
        while True:
            active = [(r, w) for r, w in walks.items()
                      if w[0] < limit and w[1]]
            if not active:
                break
            nxt = {}
            for r, w in active:
                for cur, strand in w[1]:
                    x, sx = self.next_read(cur, strand)
                    nxt[(cur, strand)] = (x, sx)
            self.compute([x for x, _ in nxt.values()])
            for r, w in active:
                cursors = []
                for cur, strand in w[1]:
                    x, sx = nxt[(cur, strand)]
                    if x == r:                       # a closed cycle
                        w[0] = limit
                        cursors = []
                        break
                    if self.degree[x] == (1, 1) and w[0] < limit:
                        w[0] += 1
                        cursors.append((x, sx))
                w[1] = cursors
        return {r for r, w in walks.items() if w[0] >= limit}

    def next_read(self, r, strand):
        """The one overlap partner of r after its strand `strand`, and the
        partner's strand there."""
        k = self.links[r]
        k = k[((k >> 17) & 1) == strand]
        return int(k[0] >> 18), int((k[0] >> 16) & 1)


def keep_irreducible(reads, r1, key):
    """Mask of the overlaps (r1, key) that construction keeps."""
    if not len(key):
        return np.zeros(0, bool)
    x = key >> 18
    s_r = (key >> 17) & 1
    s_x = (key >> 16) & 1
    d = key & 0xFFFF
    n = len(key)
    order = np.lexsort((d, s_r, r1))
    x, s_r, s_x, d, rr = x[order], s_r[order], s_x[order], d[order], r1[order]
    group = np.concatenate([[0], np.cumsum((np.diff(rr) != 0)
                                           | (np.diff(s_r) != 0))])
    len_r = reads.lengths[rr - 1]
    len_x = reads.lengths[x - 1]
    # the part of x beyond r's end, and where x ends along r's strand
    ext_len = d + len_x - len_r
    end = d + len_x
    width = int(ext_len.max()) if n else 0
    k = np.arange(width)[None, :]
    ext = np.zeros((n, width), np.uint8)
    for s in range(0, n, 1 << 16):
        e = min(s + (1 << 16), n)
        src = np.where(s_x[s:e, None] == 1, reads.fwd[x[s:e] - 1],
                       reads.rev[x[s:e] - 1])
        idx = np.clip(len_x[s:e, None] - ext_len[s:e, None] + k, 0,
                      reads.fwd.shape[1] - 1)
        ext[s:e] = np.where(k < ext_len[s:e, None],
                            np.take_along_axis(src, idx, axis=1), 0)
    status = np.zeros(n, np.int8)          # 0 open, 1 kept, 2 transitive
    while True:
        open_ = np.flatnonzero(status == 0)
        if not len(open_):
            break
        g = group[open_]
        first = np.concatenate([[True], g[1:] != g[:-1]])
        gmin = np.repeat(d[open_][first], np.diff(np.append(
            np.flatnonzero(first), len(open_))))
        new = open_[d[open_] == gmin]
        status[new] = 1
        # each group's newly kept overlaps in turn, against its open ones
        ng = group[new]
        tie = np.arange(len(new)) - np.searchsorted(ng, ng)
        for t in range(int(tie.max()) + 1):
            v = new[tie == t]
            rest = np.flatnonzero(status == 0)
            if not len(rest):
                break
            at = np.searchsorted(group[v], group[rest])
            at = np.minimum(at, len(v) - 1)
            has = group[v][at] == group[rest]
            u, vv = rest[has], v[at[has]]
            if not len(u):
                continue
            lv = ext_len[vv][:, None]
            same = ((ext[u] == ext[vv]) | (k >= lv)).all(axis=1)
            hit = (d[u] > d[vv]) & (end[u] > end[vv]) & same
            status[u[hit]] = 2
    # the assembler drops every overlap of r with a transitive partner
    pair = rr * (int(x.max()) + 1) + x
    gone = np.isin(pair, pair[status == 2])
    kept_sorted = (status == 1) & ~gone
    kept = np.zeros(n, bool)
    kept[order] = kept_sorted
    return kept
