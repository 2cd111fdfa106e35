"""Core edge structure and graph surgery primitives.

Faithful re-expression of the reference's graph layer
(MetaGenomics/Edge.{h,cpp}, OverlapGraph.cpp) over plain Python structures.
Operation ORDER is semantics here: adjacency lists append on insert and
swap-with-last on remove (OverlapGraph.cpp:863-896), twin selection compares
heap ADDRESSES (the reference compares Edge pointers, :460/:1237; we carry a
simulated glibc-malloc address per edge — see GraphCore._alloc_addr), and
every sort is the same sort the reference performs.  These details determine
the byte content of the .unitig / contigs / gdl artifacts.
"""

import math


def _i32(v: int) -> int:
    """C++ (int) cast of a UINT64 expression: truncate to 32-bit signed."""
    v &= 0xFFFFFFFF
    return v - (1 << 32) if v >= (1 << 31) else v


def match_edge_type(e1, e2) -> bool:
    """e1(u,v), e2(v,w): incoming+outgoing at v (OverlapGraph.cpp:19-26)."""
    if e1.orient in (1, 3) and e2.orient in (2, 3):
        return True
    if e1.orient in (0, 2) and e2.orient in (0, 1):
        return True
    return False


def merged_edge_orientation(e1, e2) -> int:
    """Orientation composition for connected merges (OverlapGraph.cpp:803-828)."""
    table = {(0, 0): 0, (0, 1): 1, (1, 2): 0, (1, 3): 1,
             (2, 0): 2, (2, 1): 3, (3, 2): 2, (3, 3): 3}
    key = (e1.orient, e2.orient)
    if key not in table:
        raise AssertionError("Unable to merge.")
    return table[key]


def twin_edge_orientation(orient: int) -> int:
    """Twin orientation: 0<->3, 1 and 2 self (OverlapGraph.cpp:841-855)."""
    return {0: 3, 1: 1, 2: 2, 3: 0}[orient]


def is_overlapping_interval(mean1, sd1, mean2, sd2) -> bool:
    """Coverage-interval overlap with the reference's exact integer quirks
    (OverlapGraph.cpp:48-55): UINT64 arithmetic truncated through (int),
    and end1 computed with sd2 (sic)."""
    start1 = _i32(mean1 - 2 * sd1)
    end1 = _i32(mean1 + 2 * sd2)
    start2 = _i32(mean2 - 2 * sd2)
    end2 = _i32(mean2 + 2 * sd2)
    return ((start2 <= start1 <= end2) or (start2 <= end1 <= end2)
            or (start1 <= start2 <= end1) or (start1 <= end2 <= end1))


def clocked(name):
    """Decorator: wrap a graph pass in its reference CLOCK block."""
    import functools

    def deco(fn):
        @functools.wraps(fn)
        def wrapper(self, *args, **kwargs):
            with self._clock(name):
                return fn(self, *args, **kwargs)
        return wrapper
    return deco


class Edge:
    """A bidirected edge (u -> v) with its interior read manifest."""

    __slots__ = ("source", "destination", "orient", "offset",
                 "list_reads", "list_offsets", "list_orients",
                 "reverse", "flow", "coverage_depth", "sd",
                 "transitive_flag", "serial", "addr", "cached_str")

    def __init__(self, graph, source, destination, orient, offset,
                 list_reads=None, list_offsets=None, list_orients=None,
                 serial=None, addr=None):
        self.source = source
        self.destination = destination
        self.orient = orient
        self.offset = offset
        self.list_reads = list_reads if list_reads is not None else []
        self.list_offsets = list_offsets if list_offsets is not None else []
        self.list_orients = list_orients if list_orients is not None else []
        self.reverse = None
        self.flow = 0
        self.coverage_depth = 0
        self.sd = 0
        self.transitive_flag = False
        self.serial = graph._next_serial() if serial is None else serial
        # simulated heap address (see GraphCore._alloc_addr): reproduces the
        # reference's `new Edge` address ordering under glibc tcache-LIFO
        # chunk reuse, so pointer-comparison tie-breaks (`edge <
        # edge->getReverseEdge()`, OverlapGraph.cpp:460/:1237) are exact
        self.addr = graph._alloc_addr() if addr is None else addr
        self.cached_str = None

    def __repr__(self):  # debug aid only
        return "Edge(%d,%d,o%d,off%d,%dr,f%d)" % (
            self.source, self.destination, self.orient, self.offset,
            len(self.list_reads), self.flow)


class GraphCore:
    def __init__(self, dataset, config, log=print):
        self.ds = dataset
        self.cfg = config
        self.log = log
        u = dataset.number_of_unique_reads
        self.adj = [[] for _ in range(u + 1)]
        self.number_of_nodes = 0
        self.number_of_edges = 0
        self.flow_computed = False
        self.mean_of_insert_sizes = []
        self.sd_of_insert_sizes = []
        self.estimated_genome_size = 0
        self.mp_marked_edges = set()   # filled by MatePairGraph refinement
        self._serial = 0
        # edge "heap" model: the reference compares Edge POINTERS to pick
        # which twin of a self-loop to emit (OverlapGraph.cpp:460/:1237,
        # :1470, MatePairGraph.cpp:56-57).  glibc malloc serves fixed-size
        # Edge chunks from a per-size tcache in LIFO order, so the relative
        # addresses of a twin pair allocated after frees can invert (the
        # forward edge can land ABOVE its twin).  We model this with a LIFO
        # free-address stack: allocation pops the most recent free, frees
        # push in the reference's `delete` order (twin first in removeEdge,
        # OverlapGraph.cpp:863-896; twins then edges in
        # removeTransitiveEdges, :623-661).
        # Allocator assumptions baked into the model (ADVICE r4: recorded
        # so future mismatches are diagnosable) — validated against the
        # golden reference binary (golden/README_binaries.md) built on
        # glibc 2.3x defaults:
        #   * sizeof(Edge) == 88 -> 96-byte malloc size class (chunk
        #     header 8/16 + 16-byte alignment), shared with 81..96-char
        #     std::string buffers;
        #   * TCACHE_FILL_COUNT == 7 (tcache_count default);
        #   * tcache miss refills from the fastbin head, reversing chunk
        #     order (malloc.c tcache refill loop);
        #   * malloc_consolidate (triggered by >= 64 KiB frees, e.g. the
        #     flow phase's scratch) drains fastbins but not the tcache.
        # A reference built with a different allocator, tcache depth, or
        # Edge layout would make different pointer tie-breaks; twin
        # selection is allocator-environment-specific by construction.
        self._addr_free = []      # tcache: bounded LIFO (7 entries)
        self._addr_fast = []      # fastbin spillover: unbounded LIFO
        self._addr_next = 0
        self._addr_track = True   # off during construction (build.py)
        # dirty-node tracking for the simplify fixpoint: activated lazily at
        # the first pass scan; _touch records every node whose incident
        # structure/flow changed, and each pass rescans only those (plus one
        # initial full sweep).  Pass outcomes are functions of the node's
        # incident edges, so skipping untouched nodes cannot change results
        # — the golden suites pin this byte-for-byte.
        self._events = None
        self._pass_cursor = {}

    def _next_serial(self):
        self._serial += 1
        return self._serial

    def _alloc_addr(self):
        """glibc malloc order for an Edge-sized chunk: tcache (LIFO, depth
        7) first; on tcache miss take the fastbin head and REFILL the
        tcache with up to 7 more fastbin chunks (which reverses their
        order — glibc malloc.c tcache refill loop); else fresh memory
        (monotonically increasing addresses)."""
        if self._addr_free:
            return self._addr_free.pop()
        if self._addr_fast:
            victim = self._addr_fast.pop()
            free, fast = self._addr_free, self._addr_fast
            while fast and len(free) < 7:
                free.append(fast.pop())
            return victim
        self._addr_next += 1
        return self._addr_next

    def _free_addr(self, addr):
        """glibc free: into tcache while it has room (7), else fastbin.
        No-op while tracking is off (construction — see build.py)."""
        if not self._addr_track:
            return
        if len(self._addr_free) < 7:
            self._addr_free.append(addr)
        else:
            self._addr_fast.append(addr)

    def _clock(self, name):
        """Reference CLOCKSTART/CLOCKSTOP block around a pass
        (Common.h:52-53 format, via utils.timing.phase_clock)."""
        from ..utils.timing import phase_clock
        return phase_clock(name, log=self.log, src=__file__)

    def _touch(self, node):
        ev = self._events
        if ev is not None:
            ev.append(node)

    def _dirty_nodes(self, key):
        """Ascending node ids pass `key` must scan this sweep: all nodes on
        its first sweep, afterwards only nodes touched since its previous
        sweep — PLUS, in both cases, nodes touched DURING the sweep that
        lie ahead of the scan position (the reference's full ascending
        rescan reaches those later in the same sweep; deferring them to the
        next sweep could reorder merges and shift per-iteration counters —
        ADVICE r4).  Nodes touched at or behind the scan position land in
        the next sweep, exactly when the reference's next rescan sees them.
        The nonempty check happens at ARRIVAL time, like the reference's
        live `adj[i]` reads, not at sweep start."""
        from heapq import heappop, heappush
        if self._events is None:
            self._events = []
        ev = self._events
        cur = self._pass_cursor.get(key)
        mark = len(ev)
        self._pass_cursor[key] = mark
        adj = self.adj
        # C-speed prefilters keep the Python yield loop short; a node that
        # is empty at sweep start and gains an edge mid-sweep is caught
        # through the event drain below (every insertion touches its node)
        if cur is None:
            base = [i for i in range(1, len(adj)) if adj[i]]
        else:
            base = sorted(set(ev[cur:mark]))
        extras = []                       # min-heap of mid-sweep arrivals
        pos = mark
        last = 0
        bi = 0
        nb = len(base)
        while True:
            while True:                   # drain events since last yield
                try:
                    x = ev[pos]
                except IndexError:
                    break
                pos += 1
                if x > last:
                    heappush(extras, x)
            if bi < nb and (not extras or base[bi] <= extras[0]):
                i = base[bi]
                bi += 1
            elif extras:
                i = heappop(extras)
            else:
                return
            while extras and extras[0] == i:
                heappop(extras)
            if i <= last:
                continue
            last = i
            if adj[i]:
                yield i

    # ------------------------------------------------------------ primitives

    def insert_edge_obj(self, edge):
        """OverlapGraph::insertEdge(Edge*) (OverlapGraph.cpp:390-400)."""
        lst = self.adj[edge.source]
        if not lst:
            self.number_of_nodes += 1
        lst.append(edge)
        self.number_of_edges += 1
        self._touch(edge.source)
        self.update_read_locations(edge)

    def insert_edge(self, read1, read2, orient, offset):
        """Create twin pair and insert both (OverlapGraph.cpp:407-419)."""
        e1 = Edge(self, read1, read2, orient, offset)
        rev_offset = self.ds.read_length(read2) + offset - self.ds.read_length(read1)
        e2 = Edge(self, read2, read1, twin_edge_orientation(orient), rev_offset)
        e1.reverse = e2
        e2.reverse = e1
        self.insert_edge_obj(e1)
        self.insert_edge_obj(e2)
        return e1

    def remove_edge(self, edge):
        """Remove twin first then edge, swap-with-last semantics
        (OverlapGraph.cpp:863-896)."""
        self.remove_read_locations(edge)
        self.remove_read_locations(edge.reverse)
        self._touch(edge.source)
        self._touch(edge.destination)
        twin = edge.reverse
        for lst, target in ((self.adj[edge.destination], twin),
                            (self.adj[edge.source], edge)):
            for i in range(len(lst)):
                if lst[i] is target:
                    # reference `delete`s the twin first, then the edge
                    # (OverlapGraph.cpp:873/:886) — free addrs in that order
                    self._free_addr(target.addr)
                    lst[i] = lst[-1]
                    lst.pop()
                    if not lst:
                        self.number_of_nodes -= 1
                    self.number_of_edges -= 1
                    break

    def find_edge(self, source, destination):
        """First edge source->destination (OverlapGraph.cpp:1583-1592)."""
        for e in self.adj[source]:
            if e.destination == destination:
                return e
        raise AssertionError("Unable to find edge %d -> %d" % (source, destination))

    def is_edge_present(self, source, destination):
        return any(e.destination == destination for e in self.adj[source])

    # -------------------------------------------------- read location index

    def update_read_locations(self, edge):
        """Maintain the read -> (edge, offset) inverted index
        (OverlapGraph.cpp:1048-1071)."""
        ds = self.ds
        ef, er = ds.edges_forward, ds.edges_reverse   # hoist: property
        lf, lr = ds.loc_forward, ds.loc_reverse       # deref once per call
        distance = 0
        for rid, off, orient in zip(edge.list_reads, edge.list_offsets,
                                    edge.list_orients):
            distance += off
            if orient == 1:
                ef[rid].append(edge)
                lf[rid].append(distance)
            else:
                er[rid].append(edge)
                lr[rid].append(distance)

    def remove_read_locations(self, edge):
        """Swap-with-last removal from the inverted index
        (OverlapGraph.cpp:1079-1115); the index-advance-after-swap quirk is
        bug-compatible with the reference."""
        ds = self.ds
        ef, er = ds.edges_forward, ds.edges_reverse
        lf, lr = ds.loc_forward, ds.loc_reverse
        for rid in edge.list_reads:
            for edges, locs in ((ef[rid], lf[rid]), (er[rid], lr[rid])):
                j = 0
                n = len(edges)
                while j < n:
                    if edges[j] is edge:
                        n -= 1
                        edges[j] = edges[n]
                        locs[j] = locs[n]
                        del edges[n]
                        del locs[n]
                    j += 1

    # ------------------------------------------------------------- merging

    def merge_list(self, e1, e2):
        """Concatenate read manifests across a shared node
        (OverlapGraph.cpp:760-785)."""
        reads = list(e1.list_reads)
        offsets = list(e1.list_offsets)
        orients = list(e1.list_orients)
        s = sum(e1.list_offsets)
        reads.append(e1.destination)
        # the manifest offset vector is UINT16 in the reference (Edge.h:31)
        offsets.append((e1.offset - s) & 0xFFFF)
        orients.append(1 if e1.orient in (1, 3) else 0)
        reads.extend(e2.list_reads)
        offsets.extend(e2.list_offsets)
        orients.extend(e2.list_orients)
        return reads, offsets, orients

    def merge_edges(self, e1, e2):
        """Merge e1(u,v)+e2(v,w) into a composite (OverlapGraph.cpp:702-753)."""
        # surviving originals keep reduced flows; their endpoints must be
        # rescanned by the dirty-tracked passes
        self._touch(e1.source)
        self._touch(e1.destination)
        self._touch(e2.source)
        self._touch(e2.destination)
        read1, read2 = e1.source, e2.destination
        of = merged_edge_orientation(e1, e2)
        ob = twin_edge_orientation(of)
        rf, off_f, orf = self.merge_list(e1, e2)
        fwd = Edge(self, read1, read2, of, e1.offset + e2.offset, rf, off_f, orf)
        rr, off_r, orr_list = self.merge_list(e2.reverse, e1.reverse)
        rev = Edge(self, read2, read1, ob,
                   e2.reverse.offset + e1.reverse.offset, rr, off_r, orr_list)
        fwd.reverse = rev
        rev.reverse = fwd
        flow = min(e1.flow, e2.flow)
        fwd.flow = flow
        rev.flow = flow
        self.insert_edge_obj(fwd)
        self.insert_edge_obj(rev)
        e1.flow = e1.flow - flow
        e1.reverse.flow = e1.flow
        e2.flow = e2.flow - flow
        e2.reverse.flow = e2.flow
        if e1.flow == 0 or flow == 0:
            self.remove_edge(e1)
        if e2.flow == 0 or flow == 0:
            self.remove_edge(e2)
        return fwd

    # ------------------------------------------------------------- sorting

    def sort_edges(self):
        """Sort each adjacency by destination id (OverlapGraph.cpp:2799-2808).
        std::sort semantics: tie order (parallel edges) must match libstdc++
        introsort, not input order."""
        from ..utils.stdsort import std_sort
        for lst in self.adj:
            if lst:
                std_sort(lst, lambda a, b: a.destination < b.destination)

    # ----------------------------------------------------- string recovery

    def get_string_in_edge(self, edge) -> bytes:
        """Reconstruct the sequence spelled by an edge
        (OverlapGraph.cpp:2009-2041); 'N' marks scaffold gaps.  The string
        is a function of immutable edge state (endpoints, orientation,
        manifest) — merges create NEW Edge objects — so it is memoized on
        the edge across the four printGraph stages and removeSimilarEdges.

        The read manifest is decoded in blocked batches (one LUT gather per
        block instead of one per read) — identical splice semantics to the
        reference's per-read substr walk."""
        cached = edge.cached_str
        if cached is not None:
            return cached
        ds = self.ds
        reads = edge.list_reads
        if not reads:
            read1 = (ds.get_string_forward(edge.source)
                     if edge.orient in (2, 3)
                     else ds.get_string_reverse(edge.source))
            read2 = (ds.get_string_forward(edge.destination)
                     if edge.orient in (1, 3)
                     else ds.get_string_reverse(edge.destination))
            sub_len = len(read2) + edge.offset - len(read1)
            s = read1 + (read2[len(read2) - sub_len:] if sub_len > 0
                         else b"")
            edge.cached_str = s
            return s
        import numpy as np
        from ..ops import packing
        n = len(reads) + 2
        rids = np.empty(n, np.int64)
        rids[0] = edge.source
        rids[1:-1] = reads
        rids[-1] = edge.destination
        fwd = np.empty(n, bool)
        fwd[0] = edge.orient in (2, 3)
        fwd[1:-1] = np.asarray(edge.list_orients, np.int64) == 1
        fwd[-1] = edge.orient in (1, 3)
        lens_a = ds.lengths[rids]
        offs_a = np.asarray(edge.list_offsets, np.int64)
        # per-row emitted piece: row t contributes its tail
        # [rt_len - sub_len, rt_len) plus an optional 'N' gap marker BEFORE
        # it (offset == previous read length, OverlapGraph.cpp:2021-2022)
        sub = np.empty(n, np.int64)
        sub[0] = lens_a[0]
        sub[1:-1] = lens_a[1:-1] + offs_a - lens_a[:-2]
        sub[-1] = edge.reverse.list_offsets[0]
        sub_pos = np.maximum(sub, 0)
        gap = np.zeros(n, np.int64)
        gap[1:-1] = offs_a == lens_a[:-2]
        piece = gap + sub_pos                  # output bytes per row
        out_end = np.cumsum(piece)
        total = int(out_end[-1])
        out = np.empty(total, np.uint8)
        out_start = out_end - piece            # includes the gap slot
        gap_rows = np.flatnonzero(gap)
        if len(gap_rows):
            out[out_start[gap_rows]] = ord("N")
        B = 1 << 15
        lmax = ds.codes_fwd.shape[1]
        for s in range(0, n, B):
            e = min(s + B, n)
            block = rids[s:e]
            f = fwd[s:e]
            mat = np.empty((e - s, lmax), np.uint8)
            if f.any():
                mat[f] = ds.codes_fwd[block[f]]
            nf = ~f
            if nf.any():
                mat[nf] = ds.codes_rev[block[nf]]
            amat = packing.codes_to_ascii_all(mat).reshape(-1)
            # expand this block's tail pieces into one flat gather
            pl = sub_pos[s:e]
            src0 = (np.arange(e - s, dtype=np.int64) * lmax
                    + lens_a[s:e] - pl)
            dst0 = out_start[s:e] + gap[s:e]
            m = int(pl.sum())
            if m:
                step = np.ones(m, np.int64)
                heads = np.cumsum(np.concatenate(([0], pl[:-1])))
                nz = pl > 0
                step[heads[nz]] = np.concatenate(
                    ([src0[nz][0]], np.diff(src0[nz]) - pl[nz][:-1] + 1))
                src_idx = np.cumsum(step)
                dstep = np.ones(m, np.int64)
                dstep[heads[nz]] = np.concatenate(
                    ([dst0[nz][0]], np.diff(dst0[nz]) - pl[nz][:-1] + 1))
                dst_idx = np.cumsum(dstep)
                out[dst_idx] = amat[src_idx]
        s = out.tobytes()
        edge.cached_str = s
        return s

    # ---------------------------------------------------------- artifacts

    _GDL_HEADER = (
        "graph: {\nlayoutalgorithm :forcedir\nfdmax:704\ntempmax:254\n"
        "tempmin:0\ntemptreshold:3\ntempscheme:3\ntempfactor:1.08\n"
        "randomfactor:100\ngravity:0.0\nrepulsion:161\nattraction:43\n"
        "ignore_singles:yes\nnode.fontname:\"helvB10\"\n"
        "edge.fontname:\"helvB10\"\nnode.shape:box\nnode.width:80\n"
        "node.height:20\nnode.borderwidth:1\nnode.bordercolor:31\n")

    _GDL_EDGE_STYLES = {
        0: "thickness: %d arrowstyle: none backarrowstyle: solid color: red",
        1: "thickness: %d backarrowstyle:solid arrowstyle:solid color: green",
        2: "thickness: %d arrowstyle: none color: blue",
        3: "thickness: %d arrowstyle:solid color: red",
    }

    @clocked("printGraph")
    def print_graph(self, graph_path, contig_path):
        """Emit the aiSee GDL graph and the contig FASTA
        (OverlapGraph.cpp:428-520)."""
        ds = self.ds
        contig_edges = []
        highest_degree = 0
        highest_degree_node = 0
        gdl = [self._GDL_HEADER]
        for i in range(1, ds.number_of_unique_reads + 1):
            if self.adj[i]:
                gdl.append('node: { title:"%d" label: "%d" }\n' % (i, i))
        for i in range(1, ds.number_of_unique_reads + 1):
            lst = self.adj[i]
            if not lst:
                continue
            if len(lst) > highest_degree:
                highest_degree = len(lst)
                highest_degree_node = i
            for e in lst:
                if (e.source < e.destination
                        or (e.source == e.destination
                            and e.addr < e.reverse.addr)):
                    contig_edges.append(e)
                    thickness = 1 if not e.list_reads else 3
                    style = self._GDL_EDGE_STYLES[e.orient] % thickness
                    gdl.append(
                        'edge: { source:"%d" target:"%d" %s label: '
                        '"(%d,%dx,%d,%d)" }\n'
                        % (e.source, e.destination, style, e.flow,
                           e.coverage_depth, e.offset, len(e.list_reads)))
        gdl.append("}")
        with open(graph_path, "w") as f:
            f.write("".join(gdl))
        self.log("Aisee graph written.")

        # std::sort ascending by offset, then emitted in reverse iteration
        # order (OverlapGraph.cpp:478-479).  Tied offsets must follow
        # libstdc++ introsort order, hence the behavioral std::sort clone.
        from ..utils.stdsort import std_sort
        std_sort(contig_edges, lambda a, b: a.offset < b.offset)
        contig_edges.reverse()
        total = 0
        import numpy as np
        with open(contig_path, "wb") as f:
            for idx, e in enumerate(contig_edges):
                s = self.get_string_in_edge(e)
                f.write(b">contig_%d Flow: %10d Edge  (%10d, %10d) "
                        b"String Length: %10d Coverage: %10d\n"
                        % (idx + 1, e.flow, e.source, e.destination,
                           len(s), e.coverage_depth))
                total += len(s)
                # 100bp lines in one vectorized newline insertion (the
                # reference emits a line even for a 0-length final chunk
                # only when start < len, i.e. never an empty trailing line,
                # but a 0-length contig still prints one empty line)
                if len(s) == 0:
                    f.write(b"\n")
                    continue
                nlines = (len(s) + 99) // 100
                buf = np.full((nlines, 101), ord("\n"), np.uint8)
                rows = np.frombuffer(s, np.uint8)
                full = len(s) // 100
                buf[:full, :100] = rows[:full * 100].reshape(-1, 100)
                rem = len(s) - full * 100
                if rem:
                    buf[full, :rem] = rows[full * 100:]
                    buf[full, rem] = ord("\n")
                    out = buf.reshape(-1)[:full * 101 + rem + 1]
                else:
                    out = buf.reshape(-1)
                f.write(out.tobytes())
        self.log("Total contig length: %d BP" % total)
        self.log("Number of Nodes in the graph: %d" % self.number_of_nodes)
        self.log("Number of Edges in the graph: %d" % (self.number_of_edges // 2))
        # highest-degree node statistics (OverlapGraph.cpp:500-514)
        if highest_degree > 0:
            sim_e = com_e = in_e = out_e = 0
            for e in self.adj[highest_degree_node]:
                if not e.list_reads:
                    sim_e += 1
                else:
                    com_e += 1
                if e.orient in (0, 1):
                    in_e += 1
                else:
                    out_e += 1
            self.log("Highest Degree Read %d has %d neighbors."
                     % (highest_degree_node, highest_degree))
            self.log("In Edges: %d Out Edges: %d Simple Edges: %d "
                     "Composite Edges: %d" % (in_e, out_e, sim_e, com_e))
            self.log("String: %s"
                     % self.ds.read_strs[highest_degree_node].decode())

    @clocked("saveGraphToFile")
    def save_graph_to_file(self, path):
        """Flat numeric unitig checkpoint (OverlapGraph.cpp:1219-1261)."""
        out = []
        for i in range(1, len(self.adj)):
            for e in self.adj[i]:
                if (e.source < e.destination
                        or (e.source == e.destination
                            and e.addr < e.reverse.addr)):
                    out.extend((e.source, e.destination, e.orient, e.offset,
                                len(e.list_reads)))
                    for rid, off, orient in zip(e.list_reads, e.list_offsets,
                                                e.list_orients):
                        out.extend((rid, off, orient))
        # chunked formatting: one join over the full manifest stream would
        # transiently hold ~50B per number at metagenome scale
        with open(path, "w") as f:
            B = 1 << 18
            for s in range(0, len(out), B):
                f.write("\n".join(map(str, out[s:s + B])))
                f.write("\n")

    @clocked("readGraphFromFile")
    def read_graph_from_file(self, path):
        """Rebuild the graph from a unitig checkpoint, deriving each twin
        edge arithmetically (OverlapGraph.cpp:1270-1367)."""
        ds = self.ds
        with open(path) as f:
            nums = [int(tok) for tok in f.read().split()]
        # The reference's >> loop appends one spurious 0 after the final
        # failed extraction and then iterates while i < size-1, which
        # consumes exactly the real records; equivalently we consume nums.
        i = 0
        n = len(nums)
        while i < n:
            if i + 5 > n:
                break
            source, destination, orientation, offset, nreads = nums[i:i + 5]
            i += 5
            lr = nums[i:i + 3 * nreads:3]
            lo = nums[i + 1:i + 1 + 3 * nreads:3]
            lor = nums[i + 2:i + 2 + 3 * nreads:3]
            i += 3 * nreads
            interior = sum(lo)
            fwd = Edge(self, source, destination, orientation, offset,
                       list(lr), list(lo), list(lor))
            # reverse manifest derived arithmetically
            rr, ro, rorient = [], [], []
            size = len(lr)
            for j in range(size):
                rr.append(lr[size - j - 1])
                if j == 0:
                    length1 = ds.read_length(destination)
                    off_fwd = offset - interior
                else:
                    length1 = ds.read_length(lr[size - j])
                    off_fwd = lo[size - j]
                length2 = ds.read_length(lr[size - j - 1])
                ro.append((length1 + off_fwd - length2) & 0xFFFF)
                rorient.append(0 if lor[size - j - 1] else 1)
            rev_offset = offset + ds.read_length(destination) - ds.read_length(source)
            rev = Edge(self, destination, source,
                       twin_edge_orientation(orientation), rev_offset,
                       rr, ro, rorient)
            fwd.reverse = rev
            rev.reverse = fwd
            self.insert_edge_obj(fwd)
            self.insert_edge_obj(rev)
