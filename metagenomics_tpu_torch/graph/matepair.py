"""Mate-pair phase: insert-size estimation and path-supported edge merging.

Replicates OverlapGraph::calculateMeanAndSdOfInsertSize (OverlapGraph.cpp:
1124-1211), findPathBetweenMatepairs (:1645-1730), exploreGraph (:1781-1870,
including its quirky first-path-wins flag intersection, the depth-100 cap and
the "destination reached outside the insert window -> keep exploring through
it" behaviour) and findSupportByMatepairsAndMerge (:1892-2002).

All unsigned-underflow behaviours of the C++ (UINT64 mean - 3*SD etc.) are
reproduced with explicit 64-bit wrapping.
"""

from .core import match_edge_type

M64 = (1 << 64) - 1


def _u64(x):
    return x & M64


class _PairSupport:
    __slots__ = ("edge1", "edge2", "support", "distance", "is_freed")

    def __init__(self, edge1, edge2):
        self.edge1 = edge1
        self.edge2 = edge2
        self.support = 1
        self.distance = 0
        self.is_freed = False


class MatePairMixin:
    def get_mean(self, d):
        return self.mean_of_insert_sizes[d]

    def get_sd(self, d):
        return self.sd_of_insert_sizes[d]

    # ------------------------------------------------- insert-size estimate

    def calculate_mean_and_sd_of_insert_size(self):
        """Insert-size mean/SD per PE dataset (OverlapGraph.cpp:1124-1211).

        The reference walks every mate pair and cross-checks the two reads'
        edge-location lists with a nested loop; the accumulated statistics
        (count, u64 sum, u64 wrap-sum of squared deviations) are commutative,
        so the same multiset of same-edge distances is computed here as one
        vectorized sort-free join: a CSR location index over all reads built
        once, then per dataset a blocked cross-product of the paired reads'
        location slices filtered on (same edge, 0 < d1-d2 < 1000)."""
        from ..utils.timing import clock_start, clock_stop
        clk = clock_start("calculateMeanAndSdOfInsertSize", log=self.log,
                          src=__file__)
        ds = self.ds
        if not ds.pe_files:
            # reference returns before CLOCKSTOP here (OverlapGraph.cpp:1128)
            return
        import math
        import numpy as np
        n = ds.number_of_unique_reads
        ndatasets = len(ds.pe_files)

        # Location table built from the materialized per-read lists
        # (Read.h:39-42), NOT re-derived from live adj edges: because
        # remove_read_locations is bug-compatible with the reference's
        # swap-with-last index skip (OverlapGraph.cpp:1079-1115), a read
        # appearing 2+ times in one edge's manifest can keep a stale entry
        # for a removed edge, and the reference's scan (:1149-1161)
        # concatenates exactly these lists (forward then reverse) and sees
        # the stale entries too.  The edge token is its construction serial
        # (unique per Edge object == pointer identity; the stale list
        # reference keeps the Python object alive, so serials never alias).
        pend = getattr(ds, "_pending_locations", None)
        if pend is not None:
            # native-engine arrays, untouched by any list mutation: build
            # the CSR directly (rows are already forward-then-reverse per
            # read, the reference's concatenation order)
            edges_l, cf, cr, loc_edge_pos, loc_dist = pend
            serial_arr = np.fromiter((e.serial for e in edges_l), np.int64,
                                     len(edges_l)) if edges_l else \
                np.zeros(0, np.int64)
            toks = (serial_arr[loc_edge_pos] if len(edges_l)
                    else np.zeros(0, np.int64))
            locs = np.asarray(loc_dist, np.int64)
            counts = (np.asarray(cf, np.int64)
                      + np.asarray(cr, np.int64))[:n + 1]
            indptr = np.zeros(n + 2, np.int64)
            np.cumsum(counts, out=indptr[1:])
        else:
            EMPTY = ()
            efc, erc = ds.edges_forward, ds.edges_reverse
            lfc, lrc = ds.loc_forward, ds.loc_reverse
            if hasattr(efc, "d"):
                # lazy container: visit touched rows only (indexing through
                # it would materialize an empty list per untouched read)
                efd, erd, lfd, lrd = efc.d, erc.d, lfc.d, lrc.d
                ef = lambda i: efd.get(i, EMPTY)
                er = lambda i: erd.get(i, EMPTY)
                lf = lambda i: lfd.get(i, EMPTY)
                lr = lambda i: lrd.get(i, EMPTY)
                rows = sorted(k for k in (efd.keys() | erd.keys())
                              if efd.get(k) or erd.get(k))
            else:
                ef, er, lf, lr = (efc.__getitem__, erc.__getitem__,
                                  lfc.__getitem__, lrc.__getitem__)
                rows = [i for i in range(1, n + 1) if efc[i] or erc[i]]
            counts = np.zeros(n + 1, np.int64)
            for i in rows:
                counts[i] = len(ef(i)) + len(er(i))
            toks = np.asarray(
                [e.serial for i in rows
                 for lst in (ef(i), er(i)) for e in lst], np.int64)
            locs = np.asarray(
                [v for i in rows
                 for lst in (lf(i), lr(i)) for v in lst], np.int64)
            indptr = np.zeros(n + 2, np.int64)
            np.cumsum(counts, out=indptr[1:])

        for d in range(ndatasets):
            self.log("Calculating mean and SD of dataset: %d" % d)
            dmask = ds.mp_dataset == d
            I = ds.mp_rid[dmask]
            R = ds.mp_mate[dmask]
            count = 0
            total = 0
            variance = 0  # u64 wrap-sum of squared deviations needs the mean
            sizes_chunks = []
            if len(I):
                a = indptr[I + 1] - indptr[I]
                b = indptr[R + 1] - indptr[R]
                ab = a * b
                # blocked cross-product join, ~16M rows per block
                block_starts = [0]
                budget = 1 << 24
                acc = 0
                for p in range(len(I)):
                    if acc + ab[p] > budget and acc > 0:
                        block_starts.append(p)
                        acc = 0
                    acc += int(ab[p])
                block_starts.append(len(I))
                start1 = indptr[I]
                start2 = indptr[R]
                for bi in range(len(block_starts) - 1):
                    lo, hi = block_starts[bi], block_starts[bi + 1]
                    nab = ab[lo:hi]
                    rows = int(nab.sum())
                    if rows == 0:
                        continue
                    P = np.repeat(np.arange(lo, hi), nab)
                    o = np.arange(rows) - np.repeat(
                        np.concatenate(([0], np.cumsum(nab)[:-1])), nab)
                    bP = b[P]
                    k = o // bP
                    l = o - k * bP
                    i1 = start1[P] + k
                    i2 = start2[P] + l
                    diff = locs[i1] - locs[i2]
                    m = (toks[i1] == toks[i2]) & (diff > 0) & (diff < 1000)
                    sz = diff[m]
                    if len(sz):
                        count += len(sz)
                        total += int(sz.sum())
                        sizes_chunks.append(sz)
            if count == 0:
                self.log("No insert-size found for dataset: %d" % d)
                self.mean_of_insert_sizes.append(0)
                self.sd_of_insert_sizes.append(0)
                continue
            mean = total // count
            for sz in sizes_chunks:
                dev = np.uint64(mean) - sz.astype(np.uint64)   # u64 wrap
                variance = _u64(variance + int((dev * dev).sum(
                    dtype=np.uint64)))
            sd = int(math.sqrt(variance // count))
            self.mean_of_insert_sizes.append(mean)
            self.sd_of_insert_sizes.append(sd)
            self.log("Mean set to: %d" % mean)
            self.log("SD set to: %d" % sd)
            self.log("Reads on same edge: %d" % count)
        clock_stop("calculateMeanAndSdOfInsertSize", clk, log=self.log)

    # ------------------------------------------------------- path discovery

    def find_path_between_matepairs(self, r1, r2, orient, dataset_number,
                                    copy_of_path, copy_of_flags, loc=None):
        """Returns False iff the pair lies on one edge (OverlapGraph.cpp:
        1645-1730); fills copy_of_path / copy_of_flags with the supported
        adjacency chain.  `loc` optionally carries the four hoisted
        location containers (ef, er, lf, lr) — the hot caller passes them
        to skip four property derefs per mate pair."""
        ds = self.ds
        copy_of_path.clear()
        copy_of_flags.clear()
        if loc is None:
            loc = (ds.edges_forward, ds.edges_reverse,
                   ds.loc_forward, ds.loc_reverse)
        ef, er, lf, lr = loc
        if orient in (2, 3):
            list1 = ef[r1]
            loc1 = lf[r1]
        else:
            list1 = er[r1]
            loc1 = lr[r1]
        if orient in (0, 2):
            list2 = ef[r2]
            loc2 = lf[r2]
        else:
            list2 = er[r2]
            loc2 = lr[r2]

        if not list1 or not list2:
            return False
        for fe in list1:
            for le in list2:
                if fe is le or fe is le.reverse:
                    return False

        mean = self.get_mean(dataset_number)
        sd = self.get_sd(dataset_number)
        hi = mean + 3 * sd
        for i in range(len(list1)):
            for jj in range(len(list2)):
                first_edge = list1[i]
                last_edge = list2[jj]
                d_first = _u64(first_edge.offset - loc1[i])
                d_last = loc2[jj]
                if _u64(d_first + d_last) < hi:
                    first_path = []
                    flags = []
                    new_paths = self._explore_graph(
                        first_edge, last_edge, d_first, d_last,
                        dataset_number, first_path, flags)
                    if new_paths > 0:
                        if not copy_of_path:
                            copy_of_path.extend(first_path)
                            copy_of_flags.extend(flags[:len(first_path) - 1])
                        else:
                            for k in range(len(copy_of_path) - 1):
                                supported = False
                                for l in range(len(first_path) - 1):
                                    if (copy_of_path[k] is first_path[l]
                                            and copy_of_path[k + 1] is first_path[l + 1]
                                            and flags[l] == 1):
                                        supported = True
                                        break
                                if not supported:
                                    copy_of_flags[k] = 0
        return True

    def _explore_graph(self, first_edge, last_edge, dist_first, dist_last,
                       dataset_number, first_path, flags):
        """Bounded DFS (OverlapGraph.cpp:1781-1870).  The reference keeps the
        DFS stack in static vectors resized per level; here they are explicit
        locals of an iterative-recursive walker with identical semantics."""
        mean = self.get_mean(dataset_number)
        sd = self.get_sd(dataset_number)
        lo = _u64(mean - 3 * sd)
        hi = _u64(mean + 3 * sd)
        state = {"path_found": 0}
        list_of_edges = []
        path_lengths = []

        def rec(edge, dist_on_first, level):
            del list_of_edges[level:]
            del path_lengths[level:]
            if level > 100:
                return
            if level == 0:
                list_of_edges.append(edge)
                path_lengths.append(dist_on_first)
            else:
                if edge is last_edge:
                    total = _u64(dist_last + path_lengths[level - 1])
                    if lo <= total <= hi:
                        list_of_edges.append(edge)
                        path_lengths.append(total)
                        state["path_found"] += 1
                        if state["path_found"] == 1:
                            first_path.extend(list_of_edges)
                            flags.extend([1] * (len(list_of_edges) - 1))
                        else:
                            for i in range(len(first_path) - 1):
                                adjacent = False
                                for jj in range(len(list_of_edges) - 1):
                                    if (first_path[i] is list_of_edges[jj]
                                            and first_path[i + 1]
                                            is list_of_edges[jj + 1]):
                                        adjacent = True
                                        break
                                if not adjacent:
                                    flags[i] = 0
                        return
                    else:
                        list_of_edges.append(edge)
                        path_lengths.append(
                            _u64(dist_on_first + path_lengths[level - 1]))
                else:
                    list_of_edges.append(edge)
                    path_lengths.append(
                        _u64(dist_on_first + path_lengths[level - 1]))
            for next_edge in self.adj[edge.destination]:
                if (match_edge_type(edge, next_edge)
                        and path_lengths[level] < hi):
                    rec(next_edge, next_edge.offset, level + 1)

        rec(first_edge, dist_first, 0)
        return state["path_found"]

    # ------------------------------------------------------ support + merge

    def find_support_by_matepairs_and_merge(self):
        from ..utils.timing import clock_start, clock_stop
        clk = clock_start("findSupportByMatepairsAndMerge", log=self.log,
                          src=__file__)
        ds = self.ds
        if not self.mean_of_insert_sizes:
            # reference returns before CLOCKSTOP here (OverlapGraph.cpp:1898)
            return 0
        copy_of_path = []
        copy_of_flags = []
        no_paths = paths = mp_same_edge = 0
        supports = []
        # identity index over supports: at any point at most one of the two
        # match keys (direct / twin-reversed, OverlapGraph.cpp:1936-1947) can
        # be present — inserting the second would have matched the first via
        # the reversed condition — so a dict lookup reproduces the
        # reference's first-match linear scan exactly while the supports
        # list keeps insertion order for std_sort
        sup_index = {}
        import numpy as np
        means = np.asarray(self.mean_of_insert_sizes, np.int64)
        sel = np.flatnonzero((ds.mp_rid <= ds.mp_mate)
                             & (means[ds.mp_dataset] != 0))
        loc = (ds.edges_forward, ds.edges_reverse,
               ds.loc_forward, ds.loc_reverse)
        for i, r2, mp_orient, mp_ds in zip(
                ds.mp_rid[sel].tolist(), ds.mp_mate[sel].tolist(),
                ds.mp_orient[sel].tolist(), ds.mp_dataset[sel].tolist()):
            if self.find_path_between_matepairs(
                    i, r2, mp_orient, mp_ds,
                    copy_of_path, copy_of_flags, loc):
                if len(copy_of_path) == 0:
                    no_paths += 1
                else:
                    paths += 1
            else:
                mp_same_edge += 1
            if len(copy_of_path) > 1:
                for k in range(len(copy_of_flags)):
                    if copy_of_flags[k] != 1:
                        continue
                    ek, ek1 = copy_of_path[k], copy_of_path[k + 1]
                    ps = sup_index.get((id(ek), id(ek1)))
                    if ps is None:
                        ps = sup_index.get(
                            (id(ek1.reverse), id(ek.reverse)))
                    if ps is not None:
                        ps.support += 1
                    elif (ek.source != ek.destination
                            or ek1.source != ek1.destination):
                        ps = _PairSupport(ek, ek1)
                        supports.append(ps)
                        sup_index[(id(ek), id(ek1))] = ps

        from ..utils.stdsort import std_sort
        std_sort(supports, lambda a, b: a.support > b.support)

        merged = 0
        for i, ps in enumerate(supports):
            if not ps.is_freed and ps.support >= self.cfg.minimum_support:
                merged += 1
                self.log("%4d Merging (%10d,%10d) Length: %8d Flow: %3d and "
                         "(%10d,%10d) Length: %8d Flow: %3d are supported "
                         "%4d times"
                         % (i + 1, ps.edge1.source, ps.edge1.destination,
                            ps.edge1.offset, ps.edge1.flow, ps.edge2.source,
                            ps.edge2.destination, ps.edge2.offset,
                            ps.edge2.flow, ps.support))
                e1f, e1r = ps.edge1, ps.edge1.reverse
                e2f, e2r = ps.edge2, ps.edge2.reverse
                self.merge_edges(ps.edge1, ps.edge2)
                for q in supports[i + 1:]:
                    if q.edge1 in (e1f, e1r, e2f, e2r):
                        q.is_freed = True
                    if q.edge2 in (e1f, e1r, e2f, e2r):
                        q.is_freed = True
        self.log("%d Pairs of Edges merged out of %d supported pairs of edges"
                 % (merged, len(supports)))
        self.log("No paths found between %d matepairs that are on different "
                 "edge." % no_paths)
        self.log("Paths found between %d matepairs that are on different "
                 "edge." % paths)
        self.log("Total matepairs on different edges %d" % (paths + no_paths))
        self.log("Total matepairs on same edge %d" % mp_same_edge)
        self.log("Total matepairs %d" % (paths + no_paths + mp_same_edge))
        clock_stop("findSupportByMatepairsAndMerge", clk, log=self.log)
        return merged
