"""Clean-room exact minimum-cost flow with lower bounds.

Replaces the bundled CS2 solver the reference links against
(MetaGenomics/CS2/cs2.h — license-restricted, "evaluation only"), solving the
same instances: a circulation problem over the node-split graph built by
OverlapGraph::calculateFlow (OverlapGraph.cpp:1402-1575).

Algorithm: lower bounds are folded into node imbalances (arc(u,v,lb,ub,c)
becomes arc(u,v,0,ub-lb,c) with b[v]+=lb, b[u]-=lb — the same transformation
CS2's DIMACS parser applies, parser_cs2.h:307-308), then the resulting b-flow
is computed by successive shortest augmenting paths with Johnson potentials
(Dijkstra on reduced costs).  Costs are nonnegative integers, so the result
is an exact optimum.

The contracted assembly graphs this runs on are usually tiny (tens to a few
thousand nodes).  Whenever the native C++ twin is available
(native.solve_min_cost_flow_native / mg_mincostflow), solve_min_cost_flow
dispatches to it unconditionally — it replicates this module's tie-breaking
exactly and therefore returns the identical flow vector
(tests/test_flow_native.py); this Python implementation is the reference
semantics and the fallback when the shared library cannot be built.
"""

import heapq
import os

INF = float("inf")


def solve_min_cost_flow(n, arcs):
    """arcs: list of (tail, head, lb, ub, cost) with 1-based node ids.
    Returns list of per-arc flow values (same order as input).

    Raises ValueError if the instance is infeasible.
    """
    if not os.environ.get("MGTPU_NO_NATIVE"):
        from . import native
        flows = native.solve_min_cost_flow_native(n, arcs)
        if flows is not None:
            return flows
    return solve_min_cost_flow_py(n, arcs)


def solve_min_cost_flow_py(n, arcs):
    """Pure-Python reference solver (same contract as solve_min_cost_flow)."""
    m = len(arcs)
    # residual graph: forward arc 2k, backward arc 2k+1
    head = [0] * (2 * m)
    cap = [0] * (2 * m)
    cost = [0] * (2 * m)
    out = [[] for _ in range(n + 1)]
    b = [0] * (n + 1)
    for k, (u, v, lb, ub, c) in enumerate(arcs):
        head[2 * k] = v
        cap[2 * k] = ub - lb
        cost[2 * k] = c
        head[2 * k + 1] = u
        cap[2 * k + 1] = 0
        cost[2 * k + 1] = -c
        out[u].append(2 * k)
        out[v].append(2 * k + 1)
        b[u] -= lb
        b[v] += lb

    pot = [0] * (n + 1)
    excess_nodes = [u for u in range(1, n + 1) if b[u] > 0]

    while True:
        s = next((u for u in excess_nodes if b[u] > 0), None)
        if s is None:
            break
        # Dijkstra over reduced costs from s.
        dist = [INF] * (n + 1)
        dist[s] = 0
        prev_arc = [-1] * (n + 1)
        pq = [(0, s)]
        visited = [False] * (n + 1)
        while pq:
            d, u = heapq.heappop(pq)
            if visited[u]:
                continue
            visited[u] = True
            for a in out[u]:
                if cap[a] > 0:
                    v = head[a]
                    nd = d + cost[a] + pot[u] - pot[v]
                    if nd < dist[v]:
                        dist[v] = nd
                        prev_arc[v] = a
                        heapq.heappush(pq, (nd, v))
        # find reachable deficit node with smallest distance (ties: lowest id)
        t = None
        best = INF
        for u in range(1, n + 1):
            if b[u] < 0 and dist[u] < best:
                best = dist[u]
                t = u
        if t is None:
            raise ValueError("infeasible min-cost flow instance")
        for u in range(1, n + 1):
            if dist[u] < INF:
                pot[u] += dist[u]
            else:
                pot[u] += best
        # bottleneck along path
        delta = b[s]
        if -b[t] < delta:
            delta = -b[t]
        u = t
        while u != s:
            a = prev_arc[u]
            if cap[a] < delta:
                delta = cap[a]
            u = head[a ^ 1]
        u = t
        while u != s:
            a = prev_arc[u]
            cap[a] -= delta
            cap[a ^ 1] += delta
            u = head[a ^ 1]
        b[s] -= delta
        b[t] += delta

    return [arcs[k][2] + cap[2 * k + 1] for k in range(m)]
