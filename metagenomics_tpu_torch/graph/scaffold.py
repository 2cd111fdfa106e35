"""Scaffolding and coverage-based node resolution.

Replicates OverlapGraph::scaffolder (OverlapGraph.cpp:2120-2223),
mergeEdgesDisconnected/mergeListDisconnected (:2386-2512), findOverlap
(:2368-2379), resolveNodes (:2612-2698) and getBaseByBaseCoverage
(:2722-2792), including the reference's integer-arithmetic quirks
(UINT64 wrap in coverage variance, the sd2-typo in interval overlap).
"""

import math

from .core import (Edge, clocked, match_edge_type, twin_edge_orientation,
                   is_overlapping_interval)

M64 = (1 << 64) - 1


def _u64(x):
    return x & M64


class _PairSupport:
    __slots__ = ("edge1", "edge2", "support", "distance", "is_freed")

    def __init__(self, edge1, edge2, dist):
        self.edge1 = edge1
        self.edge2 = edge2
        self.support = 1
        self.distance = dist
        self.is_freed = False


class ScaffoldMixin:
    # ------------------------------------------------------------ scaffolder

    @clocked("scaffolder")
    def scaffolder(self):
        ds = self.ds
        supports = []
        # identity index over supports; mirrors the matepair-phase tally:
        # at most one of (e1.rev, e2) / (e2.rev, e1) is ever present
        # (OverlapGraph.cpp:2163-2183), so dict lookup == first-match scan
        sup_index = {}
        import numpy as np
        sel = np.flatnonzero(ds.mp_rid <= ds.mp_mate)
        ef, er = ds.edges_forward, ds.edges_reverse
        lf, lr = ds.loc_forward, ds.loc_reverse
        window = [self.get_mean(d) + 3 * self.get_sd(d)
                  for d in range(len(self.mean_of_insert_sizes))]
        for i, r2, orient, d in zip(
                ds.mp_rid[sel].tolist(), ds.mp_mate[sel].tolist(),
                ds.mp_orient[sel].tolist(), ds.mp_dataset[sel].tolist()):
            if orient in (0, 1):
                list1, loc1 = ef[i], lf[i]
            else:
                list1, loc1 = er[i], lr[i]
            if orient in (0, 2):
                list2, loc2 = ef[r2], lf[r2]
            else:
                list2, loc2 = er[r2], lr[r2]
            if (len(list1) == 1 and len(list2) == 1
                    and loc1[0] + loc2[0] < window[d]):
                dist = loc1[0] + loc2[0]
                e1, e2 = list1[0], list2[0]
                if e1 is e2 or e1 is e2.reverse:
                    continue
                ps = sup_index.get((id(e1.reverse), id(e2)))
                if ps is None:
                    ps = sup_index.get((id(e2.reverse), id(e1)))
                if ps is not None:
                    ps.support += 1
                    ps.distance += dist
                else:
                    ps = _PairSupport(e1.reverse, e2, dist)
                    supports.append(ps)
                    sup_index[(id(e1.reverse), id(e2))] = ps

        from ..utils.stdsort import std_sort
        std_sort(supports, lambda a, b: a.support > b.support)

        merged = 0
        for i, ps in enumerate(supports):
            if not ps.is_freed and ps.support >= self.cfg.minimum_support:
                merged += 1
                ps.distance //= ps.support
                self.log("%4d (%10d,%10d) Length: %8d Flow: %3d and "
                         "(%10d,%10d) Length: %8d Flow: %3d are supported "
                         "%4d times. Average distance: %4d"
                         % (i + 1, ps.edge1.source, ps.edge1.destination,
                            ps.edge1.offset, ps.edge1.flow, ps.edge2.source,
                            ps.edge2.destination, ps.edge2.offset,
                            ps.edge2.flow, ps.support, ps.distance))
                e1f, e1r = ps.edge1, ps.edge1.reverse
                e2f, e2r = ps.edge2, ps.edge2.reverse
                self.merge_edges_disconnected(ps.edge1, ps.edge2, ps.distance)
                for q in supports[i + 1:]:
                    if q.edge1 in (e1f, e1r, e2f, e2r):
                        q.is_freed = True
                    if q.edge2 in (e1f, e1r, e2f, e2r):
                        q.is_freed = True
        return merged

    # ----------------------------------------------------- disconnected merge

    def find_overlap(self, s1: bytes, s2: bytes) -> int:
        """>=10bp suffix(s1)/prefix(s2) overlap (OverlapGraph.cpp:2368-2379)."""
        minimum = min(len(s1), len(s2))
        for i in range(minimum - 1, 9, -1):
            if s1[len(s1) - i:] == s2[:i]:
                return i
        return 0

    def merged_edge_orientation_disconnected(self, e1, e2):
        or1, or2 = e1.orient, e2.orient
        if or1 in (0, 1) and or2 in (0, 2):
            return 0
        if or1 in (0, 1) and or2 in (1, 3):
            return 1
        if or1 in (2, 3) and or2 in (0, 2):
            return 2
        if or1 in (2, 3) and or2 in (1, 3):
            return 3
        raise AssertionError("Unable to merge.")

    def merge_list_disconnected(self, e1, e2, overlap_offset):
        reads = list(e1.list_reads)
        offsets = list(e1.list_offsets)
        orients = list(e1.list_orients)
        s = sum(e1.list_offsets)
        reads.append(e1.destination)
        offsets.append((e1.offset - s) & 0xFFFF)
        orients.append(1 if e1.orient in (1, 3) else 0)
        reads.append(e2.source)
        offsets.append(overlap_offset & 0xFFFF)
        orients.append(1 if e2.orient in (2, 3) else 0)
        reads.extend(e2.list_reads)
        offsets.extend(e2.list_offsets)
        orients.extend(e2.list_orients)
        return reads, offsets, orients

    def merge_edges_disconnected(self, e1, e2, gap_length):
        self._touch(e1.source)
        self._touch(e1.destination)
        self._touch(e2.source)
        self._touch(e2.destination)
        ds = self.ds
        if (e1.destination == e2.source and match_edge_type(e1, e2)):
            self.merge_edges(e1, e2)
            return
        s1 = (ds.get_string_forward(e1.destination) if e1.orient in (1, 3)
              else ds.get_string_reverse(e1.destination))
        s2 = (ds.get_string_forward(e2.source) if e2.orient in (2, 3)
              else ds.get_string_reverse(e2.source))
        overlap_len = self.find_overlap(s1, s2)
        if overlap_len == 0:
            off1 = ds.read_length(e1.destination)
            off2 = ds.read_length(e2.source)
        else:
            off1 = ds.read_length(e1.destination) - overlap_len
            off2 = ds.read_length(e2.source) - overlap_len

        read1, read2 = e1.source, e2.destination
        of = self.merged_edge_orientation_disconnected(e1, e2)
        ob = twin_edge_orientation(of)
        rf, off_f, orf = self.merge_list_disconnected(e1, e2, off1)
        fwd = Edge(self, read1, read2, of, e1.offset + e2.offset + off1,
                   rf, off_f, orf)
        rr, off_r, orr = self.merge_list_disconnected(
            e2.reverse, e1.reverse, off2)
        rev = Edge(self, read2, read1, ob,
                   e1.reverse.offset + e2.reverse.offset + off2,
                   rr, off_r, orr)
        fwd.reverse = rev
        rev.reverse = fwd
        flow = min(e1.flow, e2.flow)
        coverage = min(e1.coverage_depth, e2.coverage_depth)
        fwd.flow = flow
        fwd.coverage_depth = coverage
        rev.flow = flow
        rev.coverage_depth = coverage
        self.insert_edge_obj(fwd)
        self.insert_edge_obj(rev)
        e1.flow -= flow
        e1.reverse.flow = _u64(e1.reverse.flow - flow) & 0xFFFF
        e1.coverage_depth = _u64(e1.coverage_depth - coverage)
        e1.reverse.coverage_depth = _u64(e1.reverse.coverage_depth - coverage)
        e2.flow -= flow
        e2.reverse.flow = _u64(e2.reverse.flow - flow) & 0xFFFF
        e2.coverage_depth = _u64(e2.coverage_depth - coverage)
        e2.reverse.coverage_depth = _u64(e2.reverse.coverage_depth - coverage)
        if e1.flow == 0 or flow == 0:
            self.remove_edge(e1)
        if e2.flow == 0 or flow == 0:
            self.remove_edge(e2)

    # ----------------------------------------------------------- resolution

    def get_base_by_base_coverage(self, edge):
        """Coverage mean/SD from unique reads only (OverlapGraph.cpp:
        2722-2792)."""
        ds = self.ds
        length = edge.offset + ds.read_length(edge.destination)
        cov = [0] * (length + 1)
        off = 0
        for rid, o in zip(edge.list_reads, edge.list_offsets):
            off += o
            freq = int(ds.frequencies[rid])
            for j in range(off, min(off + ds.read_length(rid), length + 1)):
                cov[j] += freq
        off = 0
        for rid, o in zip(edge.list_reads, edge.list_offsets):
            off += o
            if len(ds.edges_forward[rid]) > 1:
                for j in range(off, min(off + ds.read_length(rid), length + 1)):
                    cov[j] = 0
        for j in range(ds.read_length(edge.source)):
            cov[j] = 0
        for j in range(ds.read_length(edge.destination)):
            cov[len(cov) - 1 - j] = 0
        total = count = 0
        for v in cov:
            if v:
                total += v
                count += 1
        mean = sd = 0
        if count:
            mean = total // count
            variance = 0
            for v in cov:
                if v:
                    variance = _u64(variance + _u64(mean - v) * _u64(mean - v))
            sd = int(math.sqrt(variance // count))
        edge.coverage_depth = mean
        edge.sd = sd

    @clocked("resolveNodes")
    def resolve_nodes(self):
        """Split 2-in/2-out nodes by coverage-interval separation
        (OverlapGraph.cpp:2612-2698)."""
        counter = 0
        for i in range(1, len(self.adj)):
            lst = self.adj[i]
            list_in, list_out = [], []
            if len(lst) == 4:
                bad = False
                for e in lst:
                    if e.source == e.destination:
                        list_in, list_out = [], []
                        bad = True
                        break
                    if e.orient in (0, 1):
                        list_in.append(e.reverse)
                    else:
                        list_out.append(e)
                if bad:
                    continue
                if len(list_in) == 2 and len(list_out) == 2:
                    for e in list_in + list_out:
                        self.get_base_by_base_coverage(e)
                    if list_in[0].coverage_depth > list_in[1].coverage_depth:
                        in1, in2 = list_in
                    else:
                        in2, in1 = list_in
                    if list_out[0].coverage_depth > list_out[1].coverage_depth:
                        out1, out2 = list_out
                    else:
                        out2, out1 = list_out
                    flag1 = (is_overlapping_interval(
                                in1.coverage_depth, in1.sd,
                                out1.coverage_depth, out1.sd)
                             and not is_overlapping_interval(
                                in1.coverage_depth, in1.sd,
                                out2.coverage_depth, out2.sd)
                             and not is_overlapping_interval(
                                in2.coverage_depth, in2.sd,
                                out1.coverage_depth, out1.sd))
                    flag2 = (is_overlapping_interval(
                                in2.coverage_depth, in2.sd,
                                out2.coverage_depth, out2.sd)
                             and not is_overlapping_interval(
                                in2.coverage_depth, in2.sd,
                                out1.coverage_depth, out1.sd)
                             and not is_overlapping_interval(
                                in1.coverage_depth, in1.sd,
                                out2.coverage_depth, out2.sd))
                    if flag1:
                        counter += 1
                        self.log("%10d Merging edges (%10d,%10d) Length: "
                                 "%6d Flow: %3d Coverage: %4d SD: %3d and "
                                 "(%10d,%10d) Length: %6d Flow: %3d "
                                 "Coverage: %4d SD: %3d"
                                 % (counter, in1.source, in1.destination,
                                    in1.offset, in1.flow,
                                    in1.coverage_depth, in1.sd,
                                    out1.source, out1.destination,
                                    out1.offset, out1.flow,
                                    out1.coverage_depth, out1.sd))
                        self.merge_edges(in1, out1)
                    if flag2:
                        counter += 1
                        self.log("%10d Merging edges (%10d,%10d) Length: "
                                 "%6d Flow: %3d Coverage: %4d SD: %3d and "
                                 "(%10d,%10d) Length: %6d Flow: %3d "
                                 "Coverage: %4d SD: %3d"
                                 % (counter, in2.source, in2.destination,
                                    in2.offset, in2.flow,
                                    in2.coverage_depth, in2.sd,
                                    out2.source, out2.destination,
                                    out2.offset, out2.flow,
                                    out2.coverage_depth, out2.sd))
                        self.merge_edges(in2, out2)
        self.log("%d edges merged." % counter)
        return counter
