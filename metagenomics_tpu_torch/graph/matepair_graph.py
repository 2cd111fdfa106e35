"""Mate-pair linkage graph ("graph of edges").

TPU-framework equivalent of the reference's work-in-progress MatePairGraph
(MetaGenomics/MatePairGraph.{h,cpp}) — a second-order graph whose nodes are
the overlap graph's composite edges and whose links are mate pairs spanning
two edges.  The reference version is excluded from its own build and calls
an OverlapGraph/Edge API that does not exist in the snapshot
(MatePairGraph.cpp:43,60-61,81,93,241,263); per SURVEY.md §2.1 it is design
intent.  This implementation realizes that intent self-containedly:

* edge IDs: each twin pair gets one signed ID — positive for the edge with
  source read < destination read (serial tie-break for self loops), negative
  for its twin (MatePairGraph.cpp:40-65),
* links: mate pairs whose two reads each map uniquely to one (composite)
  edge, within the insert-size window, tallied per directed edge pair — the
  in-snapshot stand-in for the missing checkForScaffold, mirroring the
  scaffolder's support tally (OverlapGraph.cpp:2120-2195),
* orientation encoding RevRev=0 RevFwd=1 FwdRev=2 FwdFwd=3
  (MatePairGraph.h:19-24) with both endpoints normalized to their positive
  edge,
* transitive marking via the bit algebra
  (orient1&1)==((orient2&2)>>1) && ((orient1&2)|(orient2&1))==orient3
  (MatePairGraph.cpp:170-220),
* markEdgesByMatePairs: edges in the coverage-depth window with exactly one
  non-transitive forward (resp. reverse) link mark that neighbor for flow
  lower bound 1 (MatePairGraph.cpp:228-280); the coverage window constants
  coverageDepthLB/UB are undeclared in the reference — here they are config
  fields (coverage_depth_lb/ub).

The marked-edge set is exposed as `marked_edges`; FlowMixin consults it so
that marked composite edges get a flow lower bound of 1 (the stated purpose,
MatePairGraph.cpp:266-274).
"""

REV_REV, REV_FWD, FWD_REV, FWD_FWD = 0, 1, 2, 3

_ORIENT_NAMES = {0: "RevRev", 1: "RevFwd", 2: "FwdRev", 3: "FwdFwd"}


class MatePairLink:
    __slots__ = ("source", "destination", "orientation", "support",
                 "average_gap_distance", "paired_reads_in_source",
                 "paired_reads_in_destination", "gap_distance",
                 "is_transitive")

    def __init__(self, source, destination, orientation, support,
                 average_gap_distance, paired_src, paired_dst, gaps):
        self.source = source                      # positive (forward) edge
        self.destination = destination            # positive (forward) edge
        self.orientation = orientation
        self.support = support
        self.average_gap_distance = average_gap_distance
        self.paired_reads_in_source = paired_src
        self.paired_reads_in_destination = paired_dst
        self.gap_distance = gaps
        self.is_transitive = False


class MatePairGraph:
    def __init__(self, graph):
        self.graph = graph                        # the OverlapGraph
        self.edge_ids = {}                        # edge -> signed ID
        self.list_of_edges = [None]               # index = positive ID
        self.link_list = []                       # [pos ID] -> [MatePairLink]
        self.marked_edges = set()

    # ------------------------------------------------------------- build

    def _assign_edge_ids(self):
        """Signed IDs per twin pair (MatePairGraph.cpp:47-65); the serial
        tie-break replaces the reference's non-deterministic pointer
        comparison (its own TODO, MatePairGraph.cpp:56-57)."""
        g = self.graph
        next_id = 1
        for i in range(1, len(g.adj)):
            for e in g.adj[i]:
                u, v = e.source, e.destination
                if u < v or (u == v and e.addr < e.reverse.addr):
                    self.edge_ids[e] = next_id
                    self.edge_ids[e.reverse] = -next_id
                    self.list_of_edges.append(e)
                    next_id += 1
        self.graph.log("Total Edges: %d" % (next_id - 1))

    def _directed_supports(self):
        """Mate-pair support between uniquely-placed reads on different
        composite edges — the in-snapshot realization of
        checkForScaffold over getListOfFeasibleEdges.  Tally keyed by the
        directed pair (end of a -> start of b), exactly the scaffolder's
        (list1[0].reverse, list2[0]) convention (OverlapGraph.cpp:2120-2195)."""
        import numpy as np
        g = self.graph
        ds = g.ds
        tally = {}
        order = []
        ef, er = ds.edges_forward, ds.edges_reverse
        lf, lr = ds.loc_forward, ds.loc_reverse
        window = [g.get_mean(d) + 3 * g.get_sd(d)
                  for d in range(len(g.mean_of_insert_sizes))]
        sel = np.flatnonzero(ds.mp_rid <= ds.mp_mate)
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
            if len(list1) != 1 or len(list2) != 1:
                continue
            if loc1[0] + loc2[0] >= window[d]:
                continue
            a, b = list1[0].reverse, list2[0]
            if a is b or a is b.reverse:
                continue
            if not a.list_reads or not b.list_reads:
                continue                      # composite edges only
            key = (id(a), id(b))
            gap = loc1[0] + loc2[0]
            if key not in tally:
                tally[key] = (a, b, [], [], [])
                order.append(key)
            _, _, srcs, dsts, gaps = tally[key]
            srcs.append(i)
            dsts.append(r2)
            gaps.append(gap)
        return [tally[k] for k in order]

    def build(self):
        """buildMatePairGraph (MatePairGraph.cpp:40-153)."""
        self._assign_edge_ids()
        self.link_list = [[] for _ in range(len(self.list_of_edges))]
        for a, b, srcs, dsts, gaps in self._directed_supports():
            sid = self.edge_ids[a]
            did = self.edge_ids[b]
            orientation = ((FWD_REV if sid > 0 else 0)
                           | (REV_FWD if did > 0 else 0))
            src_pos = a if sid > 0 else a.reverse
            dst_pos = b if did > 0 else b.reverse
            link = MatePairLink(src_pos, dst_pos, orientation, len(gaps),
                                sum(gaps) // len(gaps), srcs, dsts, gaps)
            self.link_list[abs(sid)].append(link)
        return self

    # -------------------------------------------------------- refinement

    def mark_transitive_links(self):
        """markTransitiveEdge (MatePairGraph.cpp:170-220): for links e->e1,
        e->e2 and e1->e2 whose orientations compose, e1->e2 is transitive."""
        for links in self.link_list[1:]:
            for j, l1 in enumerate(links):
                d1 = abs(self.edge_ids[l1.destination])
                o1 = l1.orientation
                for k, l2 in enumerate(links):
                    if j == k:
                        continue
                    d2 = abs(self.edge_ids[l2.destination])
                    o2 = l2.orientation
                    for l3 in self.link_list[d1]:
                        if abs(self.edge_ids[l3.destination]) != d2:
                            continue
                        if ((o1 & 1) == ((o2 & 2) >> 1)
                                and ((o1 & 2) | (o2 & 1)) == l3.orientation):
                            l3.is_transitive = True

    def mark_edges_by_mate_pairs(self):
        """markEdgesByMatePairs (MatePairGraph.cpp:228-280): an edge in the
        coverage window with exactly one non-transitive link per direction
        marks that neighbor (and its twin) for flow lower bound 1."""
        self.mark_transitive_links()
        cfg = self.graph.cfg
        lb = cfg.coverage_depth_lb
        ub = cfg.coverage_depth_ub
        for links in self.link_list[1:]:
            if not links:
                continue
            src = links[0].source
            if not (lb <= src.coverage_depth <= ub):
                continue
            fwd_edges = rev_edges = 0
            fwd_link = rev_link = None
            for link in links:
                if link.is_transitive:
                    continue
                if link.orientation & 2:
                    fwd_link = link.destination
                    fwd_edges += 1
                else:
                    rev_link = link.destination
                    rev_edges += 1
            if fwd_edges == 1 and fwd_link not in self.marked_edges:
                self.marked_edges.add(fwd_link)
                self.marked_edges.add(fwd_link.reverse)
                self.graph.log("Marking Edge Forward: (%d,%d)"
                               % (fwd_link.source, fwd_link.destination))
            if rev_edges == 1 and rev_link not in self.marked_edges:
                self.marked_edges.add(rev_link)
                self.marked_edges.add(rev_link.reverse)
                self.graph.log("Marking Edge Reverse: (%d,%d)"
                               % (rev_link.source, rev_link.destination))

    # ------------------------------------------------------------- debug

    def print_linkage_graph(self):
        """printMatePairLinkageGraph (MatePairGraph.cpp:283-315)."""
        log = self.graph.log
        for i, links in enumerate(self.link_list[1:], start=1):
            log("EDGE: %d" % i)
            log("=======================================")
            for link in links:
                log("Edges1: (%d,%d)" % (link.source.source,
                                         link.source.destination))
                log("Edge1 ID: %d" % self.edge_ids[link.source])
                log("Edge1 OverlapOffset: %d" % link.source.offset)
                log("Reads in Edge1: %d" % len(link.source.list_reads))
                log("Edges2: (%d,%d)" % (link.destination.source,
                                         link.destination.destination))
                log("Edge2 ID: %d" % self.edge_ids[link.destination])
                log("Edge2 OverlapOffset: %d" % link.destination.offset)
                log("Reads in Edge2: %d" % len(link.destination.list_reads))
                log("Support: %d" % link.support)
                log("isTransitive: %s" % link.is_transitive)
                log("Average gap distance: %d" % link.average_gap_distance)
                for k, (s, d, gp) in enumerate(zip(
                        link.paired_reads_in_source,
                        link.paired_reads_in_destination,
                        link.gap_distance)):
                    log("MatePair:  %d %d %d %d" % (k + 1, s, d, gp))
                log("Type: %s" % _ORIENT_NAMES[link.orientation])
                log("")
