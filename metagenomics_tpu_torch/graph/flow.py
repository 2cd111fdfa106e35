"""Flow phase: bidirected graph -> node-split min-cost-flow instance -> flows.

Reproduces OverlapGraph::calculateFlow (OverlapGraph.cpp:1402-1575)
byte-for-byte on BOTH artifacts: each graph node splits into CS2 nodes
(2i, 2i+1), each bidirected edge becomes three parallel arc pairs whose
bounds/costs come from calculateBoundAndCost (:1614-1638), a super
source/sink pair ties every node in, and a single expensive return arc
forces minimal circulation.  The solve runs in-process through the
trajectory-faithful epsilon-scaling push-relabel (cs2replay.py), whose
printed triples — slot order and selection among alternate optima included
— are byte-identical to CS2's solution file (cs2.h:1861-1882), and the
flows are read back from those triples exactly as the reference parses the
file (OverlapGraph.cpp:1547-1568).  The independent exact SSP solver
(mincostflow.py) remains the cross-check oracle in the tests.
"""

from .core import clocked
from ..cs2replay import CS2Error, solve_cs2


class FlowMixin:
    def calculate_bound_and_cost(self, edge):
        """(OverlapGraph.cpp:1614-1638)."""
        lb = [0, 0, 0]
        ub = [10, 10, 10]
        cost = [500000, 500000, 500000]
        if edge.list_reads:
            # mp_marked_edges: unambiguous mate-pair-linked neighbors of
            # high-coverage edges, forced to carry flow (the stated purpose
            # of MatePairGraph::markEdgesByMatePairs, MatePairGraph.cpp:
            # 266-274); empty unless the mate-pair-graph refinement ran.
            if len(edge.list_reads) > 20 or edge in self.mp_marked_edges:
                lb = [1, 0, 0]
            ub = [1, 1, 8]
            cost = [1, 50000, 100000]
        return lb, ub, cost

    @clocked("calculateFlow")
    def calculate_flow(self, input_path, output_path):
        v = self.number_of_nodes * 2 + 2
        e = self.number_of_edges * 3 + self.number_of_nodes * 4 + 1
        supersource, supersink = 1, v
        lines = []
        arcs = []

        def arc(tail, head, lb, ub, cost):
            lines.append("a %10d %10d %10d %10d %10d\n"
                         % (tail, head, lb, ub, cost))
            arcs.append((tail, head, lb, ub, cost))

        lines.append("p min %10d %10d\n" % (v, e))
        lines.append("n %10d%10s\n" % (supersource, " 0"))
        lines.append("n %10d%10s\n" % (supersink, " 0"))
        arc(supersink, supersource, 1, 1000000, 1000000)

        n_adj = len(self.adj)
        node_map = [0] * (n_adj + 1)
        node_map_rev = [0] * (n_adj + 1)
        current = 1
        for i in range(1, n_adj):
            if self.adj[i]:
                node_map[i] = current
                node_map_rev[current] = i
                arc(supersource, 2 * current, 0, 1000000, 0)
                arc(supersource, 2 * current + 1, 0, 1000000, 0)
                arc(2 * current, supersink, 0, 1000000, 0)
                arc(2 * current + 1, supersink, 0, 1000000, 0)
                current += 1

        for i in range(1, n_adj):
            for edge in self.adj[i]:
                u = node_map[edge.source]
                w = node_map[edge.destination]
                lb, ub, cost = self.calculate_bound_and_cost(edge)
                if u < w or (u == w and edge.addr < edge.reverse.addr):
                    u1, u2, v1, v2 = 2 * u, 2 * u + 1, 2 * w, 2 * w + 1
                    if edge.orient == 0:
                        pairs = ((v1, u1), (u2, v2))
                    elif edge.orient == 1:
                        pairs = ((v2, u1), (u2, v1))
                    elif edge.orient == 2:
                        pairs = ((u1, v2), (v1, u2))
                    else:
                        pairs = ((u1, v1), (v2, u2))
                    for k in range(3):
                        arc(pairs[0][0], pairs[0][1], lb[k], ub[k], cost[k])
                        arc(pairs[1][0], pairs[1][1], lb[k], ub[k], cost[k])

        with open(input_path, "w") as f:
            f.write("".join(lines))

        if getattr(self.cfg, "clean_flow", False):
            # license-clean mode: exact SSP solve of the same instance;
            # nonzero flows printed in instance arc order (our own
            # deterministic format — byte-parity with a CS2 run is
            # explicitly not a goal here, see LICENSES.md)
            from ..errors import FlowInfeasibleError
            from ..mincostflow import solve_min_cost_flow
            self.log("Calling clean min-cost-flow solver")
            try:
                flows = solve_min_cost_flow(v, arcs)
            except ValueError:
                raise FlowInfeasibleError(2)
            triples = [(a[0], a[1], fl)
                       for a, fl in zip(arcs, flows) if fl != 0]
            self.log("Min-cost-flow solve finished")
        else:
            self.log("Calling CS2")
            try:
                triples, _ = solve_cs2(v, arcs)
            except CS2Error as exc:
                # infeasible circulation (e.g. an empty graph leaves the
                # lb=1 return arc with no residual path).  CS2 prints
                # "Error <n>" to stderr and exits with that code
                # (cs2.h:346); raise the typed error — the CLI renders it
                # (ADVICE r4: library embedders can catch it).
                from ..errors import FlowInfeasibleError
                raise FlowInfeasibleError(exc.code)
            self.log("CS2 finished")

        with open(output_path, "w") as f:
            for tail, head, fl in triples:
                f.write("%d %d %d\n" % (tail, head, fl))

        # read the flows back from the printed triples, like the reference's
        # file parse (OverlapGraph.cpp:1547-1568)
        for tail, head, fl in triples:
            if (tail != supersink and tail != supersource
                    and head != supersource and head != supersink and fl != 0):
                my_source = node_map_rev[tail // 2]
                my_dest = node_map_rev[head // 2]
                self.find_edge(my_source, my_dest).flow += fl
        self.flow_computed = True
        # flows changed on every edge and flow_computed flips contract's
        # multi-edge guard: invalidate the dirty-pass cursors so every
        # pass's next sweep is a full scan
        self._pass_cursor.clear()
        self._events = []
        # heap-model consolidation barrier (see GraphCore._alloc_addr): the
        # reference frees its >= 64 KiB flow scratch here — the CS2 cost
        # arrays (delete [] costs, OverlapGraph.cpp:1770) and the node-list
        # vectors (:1570-1571) — which runs glibc malloc_consolidate and
        # drains the Edge-size fastbin.  The tcache survives.
        self._addr_fast.clear()
