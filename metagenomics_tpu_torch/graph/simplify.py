"""Graph cleanup passes: contraction, dead ends, similar edges, trees, loops.

Each pass replicates the reference's scan order and mutation timing exactly
(OverlapGraph.cpp:669-694, 931-988, 903-925, 2048-2111, 2545-2605,
2814-2866) — several of them mutate the adjacency lists mid-scan, which is
part of the observable semantics.
"""

from .core import clocked, match_edge_type, _i32


def edit_distance(s1: bytes, s2: bytes) -> int:
    """Levenshtein distance (OverlapGraph.cpp:1736-1773).

    Row-vectorized DP: substitution/deletion are elementwise on the previous
    row; the insertion recurrence cur[j] = min(t[j-1], cur[j-1] + 1) is the
    running minimum of (t[j] - j) since each step adds exactly 1 per index —
    one np.minimum.accumulate per row.  The distance is unique, so any
    evaluation order matches the reference's cell loop."""
    m, n = len(s1), len(s2)
    if m == 0:
        return n
    if n == 0:
        return m
    import numpy as np
    a = np.frombuffer(s1, np.uint8)
    b = np.frombuffer(s2, np.uint8)
    jj = np.arange(1, n + 1, dtype=np.int64)
    prev = np.arange(n + 1, dtype=np.int64)
    head = np.empty(1, np.int64)
    for i in range(m):
        t = np.minimum(prev[:-1] + (b != a[i]), prev[1:] + 1)
        head[0] = i + 1
        u = np.minimum.accumulate(np.concatenate((head, t - jj)))
        prev = u + np.arange(n + 1)
    return int(prev[n])


class SimplifyMixin:
    @clocked("contractCompositePaths")
    def contract_composite_paths(self):
        """Merge the two edges at degree-2 nodes (OverlapGraph.cpp:669-694)."""
        counter = 0
        for index in self._dirty_nodes("contract"):
            lst = self.adj[index]
            if len(lst) == 2:
                e1, e2 = lst[0], lst[1]
                if (self.flow_computed
                        or not self.is_edge_present(e1.destination, e2.destination)):
                    if (match_edge_type(e1.reverse, e2)
                            and e1.source != e1.destination):
                        self.merge_edges(e1.reverse, e2)
                        counter += 1
        self.log("%10d composite Edges merged." % counter)
        return counter

    @clocked("removeDeadEndNodes")
    def remove_dead_end_nodes(self):
        """Remove nodes whose edges are all simple and one-directional
        (OverlapGraph.cpp:931-988)."""
        nodes = []
        edges_removed = 0
        for i in self._dirty_nodes("deadend"):
            lst = self.adj[i]
            if not lst:
                continue
            flag = 0
            in_e = out_e = 0
            for e in lst:
                if (len(e.list_reads) > self.cfg.dead_end_length
                        or e.source == e.destination):
                    flag = 1
                    break
                if e.orient in (0, 1):
                    in_e += 1
                else:
                    out_e += 1
            if flag == 0 and ((in_e > 0 and out_e == 0)
                              or (in_e == 0 and out_e > 0)):
                nodes.append(i)
        for nid in nodes:
            lst = self.adj[nid]
            if lst:
                edges_removed += len(lst)
                for e in list(lst):
                    self.remove_edge(e)
        self.log("Dead-end nodes removed: %d" % len(nodes))
        self.log("Total Edges removed: %d" % edges_removed)
        return len(nodes)

    @clocked("removeAllSimpleEdgesWithoutFlow")
    def remove_all_simple_edges_without_flow(self):
        """Drop flowless simple edges (OverlapGraph.cpp:903-925)."""
        to_remove = []
        for i in self._dirty_nodes("no_flow"):
            for e in self.adj[i]:
                if (e.source < e.destination and not e.list_reads
                        and e.flow == 0):
                    to_remove.append(e)
        for e in to_remove:
            self.remove_edge(e)
        return len(to_remove)

    @clocked("removeSimilarEdges")
    def remove_similar_edges(self):
        """Collapse parallel edges with ~identical strings
        (OverlapGraph.cpp:2545-2605)."""
        keep, drop, dists = [], [], []
        for i in self._dirty_nodes("similar"):
            lst = self.adj[i]
            for jj in range(len(lst)):
                e1 = lst[jj]
                if e1.source < e1.destination:
                    for k in range(jj + 1, len(lst)):
                        e2 = lst[k]
                        if (e1.source == e2.source
                                and e1.destination == e2.destination):
                            # UINT64 diff cast through (int), abs, then
                            # compared against UINT64 offset/20
                            diff = abs(_i32(e1.offset - e2.offset))
                            if diff < e2.offset // 20:
                                s1 = self.get_string_in_edge(e1)
                                s2 = self.get_string_in_edge(e2)
                                ed = edit_distance(s1, s2)
                                if ed < min(e1.offset, e2.offset) // 20:
                                    for l in range(len(keep)):
                                        if drop[l] is e2 or drop[l] is e1:
                                            break
                                    else:
                                        keep.append(e1)
                                        drop.append(e2)
                                        dists.append(ed)
        self.log("%d edges to remove" % len(keep))
        counter = 0
        for e1, e2, ed in zip(keep, drop, dists):
            counter += 1
            self.log("%10d removing edge (%10d,%10d) Lengths : %10d and "
                     "%10d Flows: %3d and %3d Edit Distance: %5d Reads: "
                     "%d and %d"
                     % (counter, e1.source, e1.destination, e1.offset,
                        e2.offset, e1.flow, e2.flow, ed,
                        len(e1.list_reads), len(e2.list_reads)))
            e1.flow += e2.flow
            e1.reverse.flow += e2.reverse.flow
            self.remove_edge(e2)
        self.log("%d edges removed." % counter)
        return len(keep)

    @clocked("reduceTrees")
    def reduce_trees(self):
        """Merge balanced 1-in/N-out (or N-in/1-out) nodes
        (OverlapGraph.cpp:2048-2091).  NOTE: the reference checks the merge
        condition after scanning each edge and merges mid-scan over the
        mutating adjacency list; replicated verbatim."""
        node_merged = 0
        for i in self._dirty_nodes("trees"):
            n_in = n_out = in_flow = out_flow = 0
            list_in, list_out = [], []
            lst = self.adj[i]
            jj = 0
            while jj < len(lst):
                e = lst[jj]
                if (e.flow == 0 or e.flow != e.reverse.flow
                        or e.source == e.destination):
                    break
                if e.orient in (0, 1):
                    n_in += 1
                    in_flow += e.flow
                    list_in.append(e)
                else:
                    n_out += 1
                    out_flow += e.flow
                    list_out.append(e)
                if (in_flow == out_flow
                        and ((n_in == 1 and n_out > 1)
                             or (n_in > 1 and n_out == 1))):
                    node_merged += 1
                    for ein in list_in:
                        for eout in list_out:
                            self.merge_edges(ein.reverse, eout)
                jj += 1
        self.log("%10d trees removed." % node_merged)
        return node_merged

    @clocked("reduceLoops")
    def reduce_loops(self):
        """Splice single-entry single-exit self loops
        (OverlapGraph.cpp:2814-2866)."""
        counter = 0
        for i in self._dirty_nodes("loops"):
            lst = self.adj[i]
            if len(lst) == 4:
                loop_count = incoming = outgoing = 0
                ab = bb = bc = None
                for e in lst:
                    if e.destination == i:
                        loop_count += 1
                        bb = e
                    elif e.orient in (0, 1):
                        incoming += 1
                        ab = e.reverse
                    else:
                        outgoing += 1
                        bc = e
                if loop_count == 2 and incoming == 1 and outgoing == 1:
                    self.log("Loop found at node: %d loop edge length: %d "
                             "flow: %d Other edge lengths: %d and %d"
                             % (i, bb.offset, bb.flow, ab.offset, bc.offset))
                    if bb.orient == 0:
                        counter += 1
                        self.merge_edges(ab, bb.reverse)
                    elif bb.orient == 3:
                        counter += 1
                        self.merge_edges(ab, bb)
                    else:
                        self.log("Unable to reduce loop because of the "
                                 "edge type.")
        self.log(" Loops removed: %d" % counter)
        return counter

    def simplify_graph(self):
        """Fixpoint of the five cleanup passes (OverlapGraph.cpp:2098-2111)."""
        while True:
            counter = self.remove_dead_end_nodes()
            counter += self.contract_composite_paths()
            counter += self.remove_similar_edges()
            counter += self.reduce_trees()
            counter += self.reduce_loops()
            if counter == 0:
                break
