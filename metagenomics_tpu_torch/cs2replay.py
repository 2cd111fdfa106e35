"""Trajectory-faithful port of the reference's CS2 4.6 min-cost-flow solver.

PROVENANCE — read this before touching the file.  This module is a
routine-by-routine Python port of the CS2 4.6 solver bundled with the
reference (MetaGenomics/CS2/cs2.h, parser_cs2.h): the epsilon-scaling
schedule (SCALE_DEFAULT 12), refine/discharge/relabel control flow,
bucket-based price updates (up_node_scan/price_update), the price_refine
WHITE/GREY/BLACK DFS, the price_in/price_out arc-suspension EXCHANGE
mechanics (including the TIME_FOR_PRICE_IN stepping), the parser's
grouped-by-tail arc slot ordering, and the solution print walk all mirror
cs2.h's implementation, down to internal names (n_bad_pricein, flag_updt,
excq_first, ...) that come from cs2.h rather than from Goldberg's 1997
paper.  The data layout differs (parallel Python lists instead of C
structs) but this is a derivation of cs2.h, NOT a clean-room
implementation, and earlier revisions of this docstring that claimed
otherwise were wrong.

WHY a port exists at all: the assembler's byte-parity goal covers
`_flow.output`, whose line order and choice among equal-cost optima are
trajectory artifacts of CS2's exact operation sequence.  Goldberg's paper
underspecifies those mechanics (heuristic scheduling, arc suspension,
print order), so byte parity is only achievable by mirroring the
implementation.  This module is therefore confined to the PARITY surface:
reproducing what the reference binary emits.

LICENSE: cs2.h is distributed under an evaluation-only notice
("COPYRIGHT C 1995 IG Systems, Inc. ... for evaluation only",
MetaGenomics/CS2/cs2.h:3-4).  As a derived work, this module inherits that
risk; see LICENSES.md for the project's posture.  The license-clean exact
solver lives in mincostflow.py (+ native mg_mincostflow): it solves the
identical instances optimally, cross-checks every replay solve in the
tests, and is the production path whenever byte parity with a reference
run is not demanded (CLI `--clean-flow`, config.clean_flow).

The reference talks to CS2 through DIMACS files
(OverlapGraph.cpp:1527-1547); here the instance arrives in memory as
(tail, head, low, cap, cost) tuples and the printed triples are returned
as strings.
"""

import math

# scaling / heuristic parameters (Goldberg 1997 table 1 values, as shipped)
UPDT_FREQ = 0.4
UPDT_FREQ_S = 30
SCALE_DEFAULT = 12.0
PRICE_OUT_START = 1
CUT_OFF_POWER = 0.44
CUT_OFF_COEF = 1.5
CUT_OFF_POWER2 = 0.75
CUT_OFF_COEF2 = 1
CUT_OFF_GAP = 0.8
CUT_OFF_MIN = 12
CUT_OFF_INCREASE = 4
TIME_FOR_PRICE_IN1 = 2
TIME_FOR_PRICE_IN2 = 4
TIME_FOR_PRICE_IN3 = 6

MAX_32 = 0x7FFFFFFF
PRICE_MAX = 0x7FFFFFFFFFFFFFFF

WHITE, GREY, BLACK = 0, 1, 2

UNFEASIBLE = 2
PRICE_OFL = 6


class CS2Error(Exception):
    """Solver abnormal finish; .code is the CS2 exit code (2/6)."""

    def __init__(self, code):
        super().__init__("Error %d" % code)
        self.code = code


class _CS2:
    """One solve.  Nodes are indexed by DIMACS id (node ids must start at
    1, as the assembler's instances do); id n+1 is the sentinel row.  Arc
    slots are indexed 0..2m-1 plus a sentinel slot 2m."""

    def __init__(self, n_nodes, arcs):
        n = n_nodes
        m2 = 2 * len(arcs)
        self.n = n
        self.m2 = m2
        self.SENT = n + 1          # sentinel node row
        self.DNODE = n + 2         # bucket-list sentinel
        self.DUMMY = n + 3         # dummy queue node
        self.NIL = -1
        nn = n + 4
        # node fields
        self.first = [0] * nn
        self.current = [0] * nn
        self.suspended = [0] * nn
        self.excess = [0] * nn
        self.price = [0] * nn
        self.q_next = [self.SENT] * nn
        self.b_next = [self.NIL] * nn
        self.b_prev = [self.NIL] * nn
        self.rank = [0] * nn
        self.inp = [WHITE] * nn
        # arc slots (sentinel slot m2 kept zeroed)
        self.r_cap = [0] * (m2 + 1)
        self.cost = [0] * (m2 + 1)
        self.head = [0] * (m2 + 1)
        self.sister = [0] * (m2 + 1)
        self.cap = [0] * (m2 + 1)
        self._parse(arcs)
        # solver state
        self.excq_first = self.NIL
        self.excq_last = self.NIL
        self.total_excess = 0
        self.n_src = 0
        self.n_rel = 0
        self.n_ref = 0
        self.n_bad_pricein = 0
        self.n_bad_relabel = 0
        self.flag_price = 0
        self.flag_updt = 0
        self.snc_max = 0
        self.time_for_price_in = 0
        self.max_cost = max((abs(c) for _, _, _, cap, c in arcs if cap > 0),
                            default=0)

    # ------------------------------------------------------------- parsing

    def _parse(self, arcs):
        """In-memory twin of the DIMACS parser: slot layout (forward at 2k,
        sister at 2k+1), lower bounds folded into node excess, then the
        linear-time grouped-by-tail arc ordering whose cycle-chasing swaps
        define the initial slot permutation."""
        n = self.n
        arc_first = [0] * (n + 2)
        arc_tail = [0] * self.m2
        for k, (tail, head, low, acap, cost) in enumerate(arcs):
            if not (1 <= tail <= n and 1 <= head <= n and 0 <= low <= acap):
                raise ValueError("bad arc (%d,%d,%d,%d,%d)"
                                 % (tail, head, low, acap, cost))
            s = 2 * k
            arc_first[tail + 1] += 1
            arc_first[head + 1] += 1
            arc_tail[s] = tail
            arc_tail[s + 1] = head
            self.head[s] = head
            self.r_cap[s] = acap - low
            self.cap[s] = acap
            self.cost[s] = cost
            self.sister[s] = s + 1
            self.head[s + 1] = tail
            self.r_cap[s + 1] = 0
            self.cap[s + 1] = 0
            self.cost[s + 1] = -cost
            self.sister[s + 1] = s
            self.excess[tail] -= low
            self.excess[head] += low

        self.first[1] = 0
        for i in range(2, n + 2):
            arc_first[i] += arc_first[i - 1]
            self.first[i] = arc_first[i]
        # in-place counting sort with cycle-chasing record swaps
        for i in range(1, n):
            last = self.first[i + 1]
            for pos in range(arc_first[i], last):
                tail = arc_tail[pos]
                while tail != i:
                    new = arc_first[tail]
                    self._parser_swap(pos, new)
                    arc_tail[pos] = arc_tail[new]
                    arc_tail[new] = tail
                    arc_first[tail] += 1
                    tail = arc_tail[pos]

    def _parser_swap(self, a, b):
        """Swap the arc records at slots a and b (head/r_cap/cost/cap) and
        relink sister pointers, as both the parser's ordering pass and the
        solver's EXCHANGE do."""
        if a == b:
            return
        h, s_ = self.head, self.sister
        rc, co, cp = self.r_cap, self.cost, self.cap
        sa = s_[a]
        sb = s_[b]
        h[a], h[b] = h[b], h[a]
        rc[a], rc[b] = rc[b], rc[a]
        co[a], co[b] = co[b], co[a]
        cp[a], cp[b] = cp[b], cp[a]
        if a != sb:
            s_[b] = sa
            s_[a] = sb
            s_[sa] = b
            s_[sb] = a

    # ------------------------------------------------------------ helpers

    def _increase_flow(self, i, j, a, df):
        self.excess[i] -= df
        self.excess[j] += df
        self.r_cap[a] -= df
        self.r_cap[self.sister[a]] += df

    # excess queue (FIFO; q_next == SENT means "not queued")
    def _excq_reset(self):
        i = self.excq_first
        while i != self.NIL:
            nxt = self.q_next[i]
            self.q_next[i] = self.SENT
            i = nxt
        self.excq_first = self.NIL

    def _excq_insert(self, i):
        if self.excq_first != self.NIL:
            self.q_next[self.excq_last] = i
        else:
            self.excq_first = i
        self.q_next[i] = self.NIL
        self.excq_last = i

    def _excq_pop(self):
        i = self.excq_first
        self.excq_first = self.q_next[i]
        self.q_next[i] = self.SENT
        return i

    # buckets (LIFO intrusive lists; DNODE is the terminator)
    def _bucket_insert(self, i, b):
        f = self.bucket_first[b]
        self.b_next[i] = f
        self.b_prev[f] = i
        self.bucket_first[b] = i

    def _bucket_get(self, b):
        i = self.bucket_first[b]
        self.bucket_first[b] = self.b_next[i]
        return i

    def _bucket_remove(self, i, b):
        if i == self.bucket_first[b]:
            self.bucket_first[b] = self.b_next[i]
        else:
            self.b_next[self.b_prev[i]] = self.b_next[i]
            self.b_prev[self.b_next[i]] = self.b_prev[i]

    def _update_cut_off(self):
        if self.n_bad_pricein + self.n_bad_relabel == 0:
            self.cut_off_factor = max(
                CUT_OFF_COEF2 * math.pow(float(self.n), CUT_OFF_POWER2),
                CUT_OFF_MIN)
        else:
            self.cut_off_factor *= CUT_OFF_INCREASE
        self.cut_off = self.cut_off_factor * self.epsilon
        self.cut_on = self.cut_off * CUT_OFF_GAP

    # -------------------------------------------------------------- init

    def _cs_init(self, f_sc):
        n = self.n
        for i in range(1, n + 1):
            self.price[i] = 0
            self.suspended[i] = self.first[i]
            self.q_next[i] = self.SENT
        self.first[self.SENT] = self.suspended[self.SENT] = self.m2
        # saturate negative-cost arcs (none in the assembler's instances,
        # kept for fidelity)
        for i in range(1, n + 1):
            a = self.first[i]
            a_stop = self.suspended[i + 1]
            while a != a_stop:
                if self.cost[a] < 0:
                    df = self.r_cap[a]
                    if df > 0:
                        self._increase_flow(i, self.head[a], a, df)
                a += 1
        self.f_scale = float(f_sc)
        self.dn = n + 1
        for a in range(self.m2):
            self.cost[a] *= self.dn
        mmc = self.max_cost * self.dn
        self.linf = int(self.dn * math.ceil(self.f_scale) + 2)
        self.bucket_first = [self.DNODE] * self.linf
        self.epsilon = mmc if mmc >= 1 else 1
        self.price_min = -PRICE_MAX
        self.cut_off_factor = max(
            CUT_OFF_COEF * math.pow(float(n), CUT_OFF_POWER), CUT_OFF_MIN)
        self.n_ref = 0
        self.flag_price = 0
        self.excq_first = self.NIL

    def _update_epsilon(self):
        if self.epsilon <= 1:
            return 1
        self.epsilon = int(math.ceil(float(self.epsilon) / self.f_scale))
        self.cut_off = self.cut_off_factor * self.epsilon
        self.cut_on = self.cut_off * CUT_OFF_GAP
        return 0

    # ------------------------------------------------------- price update

    def _up_node_scan(self, i):
        price, cost, r_cap = self.price, self.cost, self.r_cap
        i_rank = self.rank[i]
        a = self.first[i]
        a_stop = self.suspended[i + 1]
        while a != a_stop:
            ra = self.sister[a]
            if r_cap[ra] > 0:
                j = self.head[a]
                j_rank = self.rank[j]
                if j_rank > i_rank:
                    rc = price[j] + cost[ra] - price[i]
                    if rc < 0:
                        j_new_rank = i_rank
                    else:
                        dr = rc // self.epsilon
                        j_new_rank = (i_rank + dr + 1 if dr < self.linf
                                      else self.linf)
                    if j_rank > j_new_rank:
                        self.rank[j] = j_new_rank
                        self.current[j] = ra
                        if j_rank < self.linf:
                            self._bucket_remove(j, j_rank)
                        self._bucket_insert(j, j_new_rank)
            a += 1
        self.price[i] -= i_rank * self.epsilon
        self.rank[i] = -1

    def _price_update(self):
        n = self.n
        for i in range(1, n + 1):
            if self.excess[i] < 0:
                self._bucket_insert(i, 0)
                self.rank[i] = 0
            else:
                self.rank[i] = self.linf
        remain = self.total_excess
        if remain <= 0:
            return
        b = 0
        while b < self.linf:
            brk = False
            while self.bucket_first[b] != self.DNODE:
                i = self._bucket_get(b)
                self._up_node_scan(i)
                if self.excess[i] > 0:
                    remain -= self.excess[i]
                    if remain <= 0:
                        brk = True
                        break
            if brk or remain <= 0:
                break
            b += 1
        if remain > 0:
            self.flag_updt = 1
        dp = b * self.epsilon
        for i in range(1, n + 1):
            if self.rank[i] >= 0:
                if self.rank[i] < self.linf:
                    self._bucket_remove(i, self.rank[i])
                if self.price[i] > self.price_min:
                    self.price[i] -= dp

    # ----------------------------------------------------------- relabel

    def _relabel(self, i):
        price, cost, r_cap, head = self.price, self.cost, self.r_cap, self.head
        p_max = self.price_min
        i_price = price[i]
        a_max = self.NIL
        cur = self.current[i]
        a = cur + 1
        a_stop = self.suspended[i + 1]
        while a != a_stop:
            if r_cap[a] > 0:
                dp = price[head[a]] - cost[a]
                if dp > p_max:
                    if i_price < dp:
                        self.current[i] = a
                        return 1
                    p_max = dp
                    a_max = a
            a += 1
        a = self.first[i]
        a_stop = cur + 1
        while a != a_stop:
            if r_cap[a] > 0:
                dp = price[head[a]] - cost[a]
                if dp > p_max:
                    if i_price < dp:
                        self.current[i] = a
                        return 1
                    p_max = dp
                    a_max = a
            a += 1
        if p_max != self.price_min:
            price[i] = p_max - self.epsilon
            self.current[i] = a_max
        else:
            if self.suspended[i] == self.first[i]:
                if self.excess[i] == 0:
                    price[i] = self.price_min
                else:
                    raise CS2Error(UNFEASIBLE if self.n_ref == 1
                                   else PRICE_OFL)
            else:
                self.flag_price = 1
        self.n_rel += 1
        return 0

    # --------------------------------------------------------- discharge

    def _discharge(self, i):
        excess, r_cap, head = self.excess, self.r_cap, self.head
        a = self.current[i]
        j = head[a]
        if not (r_cap[a] > 0
                and self.price[i] + self.cost[a] < self.price[j]):
            self._relabel(i)
            a = self.current[i]
            j = head[a]
        while True:
            j_exc = excess[j]
            if j_exc >= 0:
                df = min(excess[i], r_cap[a])
                if j_exc == 0:
                    self.n_src += 1
                self._increase_flow(i, j, a, df)
                if self.q_next[j] == self.SENT:
                    self._excq_insert(j)
            else:
                df = min(excess[i], r_cap[a])
                self._increase_flow(i, j, a, df)
                if excess[j] >= 0:
                    if excess[j] > 0:
                        self.n_src += 1
                        self._relabel(j)
                        self._excq_insert(j)
                    self.total_excess += j_exc
                else:
                    self.total_excess -= df
            if excess[i] <= 0:
                self.n_src -= 1
            if excess[i] <= 0 or self.flag_price:
                break
            self._relabel(i)
            a = self.current[i]
            j = head[a]
        self.current[i] = a

    # ---------------------------------------------------------- price_in

    def _price_in(self):
        n = self.n
        price, cost, r_cap, head = self.price, self.cost, self.r_cap, self.head
        bad_found = False
        n_in_bad = 0
        restart = True
        while restart:
            restart = False
            for i in range(1, n + 1):
                a = self.first[i] - 1
                a_lo = self.suspended[i] - 1
                while a != a_lo:
                    rc = price[i] + cost[a] - price[head[a]]
                    if rc < 0 and r_cap[a] > 0:
                        if not bad_found:
                            bad_found = True
                            self._update_cut_off()
                            restart = True
                            break
                        df = r_cap[a]
                        self._increase_flow(i, head[a], a, df)
                        ra = self.sister[a]
                        j = head[a]
                        self.first[i] -= 1
                        self._parser_swap(a, self.first[i])
                        if ra < self.first[j]:
                            self.first[j] -= 1
                            self._parser_swap(ra, self.first[j])
                        n_in_bad += 1
                    elif -self.cut_on < rc < self.cut_on:
                        self.first[i] -= 1
                        self._parser_swap(a, self.first[i])
                    a -= 1
                if restart:
                    break
        if n_in_bad != 0:
            self.n_bad_pricein += 1
            self.total_excess = 0
            self.n_src = 0
            self._excq_reset()
            for i in range(1, n + 1):
                self.current[i] = self.first[i]
                i_exc = self.excess[i]
                if i_exc > 0:
                    self.total_excess += i_exc
                    self.n_src += 1
                    self._excq_insert(i)
            self._excq_insert(self.DUMMY)
        if self.time_for_price_in == TIME_FOR_PRICE_IN2:
            self.time_for_price_in = TIME_FOR_PRICE_IN3
        if self.time_for_price_in == TIME_FOR_PRICE_IN1:
            self.time_for_price_in = TIME_FOR_PRICE_IN2
        return n_in_bad

    # ------------------------------------------------------------ refine

    def _refine(self):
        n = self.n
        self.n_ref += 1
        self.n_rel = 0
        pr_in_int = 0
        self.total_excess = 0
        self.n_src = 0
        self._excq_reset()
        self.time_for_price_in = TIME_FOR_PRICE_IN1
        for i in range(1, n + 1):
            self.current[i] = self.first[i]
            i_exc = self.excess[i]
            if i_exc > 0:
                self.total_excess += i_exc
                self.n_src += 1
                self._excq_insert(i)
        if self.total_excess <= 0:
            return
        while True:
            if self.excq_first == self.NIL:
                if self.n_ref > PRICE_OUT_START:
                    pr_in_int = 0
                    self._price_in()
                if self.excq_first == self.NIL:
                    break
            i = self._excq_pop()
            if self.excess[i] > 0:
                self._discharge(i)
                if (self.n_rel > n * UPDT_FREQ + self.n_src * UPDT_FREQ_S
                        or self.flag_price):
                    if self.excess[i] > 0:
                        self._excq_insert(i)
                    if self.flag_price and self.n_ref > PRICE_OUT_START:
                        pr_in_int = 0
                        self._price_in()
                        self.flag_price = 0
                    self._price_update()
                    while self.flag_updt:
                        if self.n_ref == 1:
                            raise CS2Error(UNFEASIBLE)
                        self.flag_updt = 0
                        self._update_cut_off()
                        self.n_bad_relabel += 1
                        pr_in_int = 0
                        self._price_in()
                        self._price_update()
                    self.n_rel = 0
                    if self.n_ref > PRICE_OUT_START:
                        pr_in_int += 1
                        if pr_in_int > self.time_for_price_in:
                            pr_in_int = 0
                            self._price_in()

    # ------------------------------------------------------ price_refine

    def _price_refine(self):
        n = self.n
        price, cost, r_cap, head = self.price, self.cost, self.r_cap, self.head
        cc = 1
        snc = 0
        self.snc_max = 0   # MAX_CYCLES_CANCELLED=0 unless n_ref >= 100
        while True:
            nnc = 0
            for i in range(1, n + 1):
                self.rank[i] = 0
                self.inp[i] = WHITE
                self.current[i] = self.first[i]
            self._excq_reset()   # stack shares the excess-queue links
            for root in range(1, n + 1):
                if self.inp[root] == BLACK:
                    continue
                i = root
                self.b_next[i] = self.NIL
                while True:
                    self.inp[i] = GREY
                    a = self.current[i]
                    a_stop = self.suspended[i + 1]
                    while a != a_stop:
                        if r_cap[a] > 0:
                            j = head[a]
                            if price[i] + cost[a] - price[j] < 0:
                                if self.inp[j] == WHITE:
                                    # step forward; the outer loop re-greys
                                    # the new node and rescans from its
                                    # current arc
                                    self.current[i] = a
                                    self.b_next[j] = i
                                    i = j
                                    a = self.current[j]
                                    a_stop = self.suspended[j + 1]
                                    break
                                if self.inp[j] == GREY:
                                    cc = 0
                                    nnc += 1
                                    self.current[i] = a
                                    is_ = ir = i
                                    df = MAX_32
                                    while True:
                                        ar = self.current[ir]
                                        if r_cap[ar] <= df:
                                            df = r_cap[ar]
                                            is_ = ir
                                        if ir == j:
                                            break
                                        ir = self.b_next[ir]
                                    ir = i
                                    while True:
                                        ar = self.current[ir]
                                        self._increase_flow(
                                            ir, head[ar], ar, df)
                                        if ir == j:
                                            break
                                        ir = self.b_next[ir]
                                    if is_ != i:
                                        ir = i
                                        while ir != is_:
                                            self.inp[ir] = WHITE
                                            ir = self.b_next[ir]
                                        i = is_
                                        a = self.current[is_] + 1
                                        a_stop = self.suspended[i + 1]
                                        break
                        a += 1
                    if a == a_stop:
                        self.inp[i] = BLACK
                        j = self.b_next[i]
                        # stack push
                        self.q_next[i] = self.excq_first
                        self.excq_first = i
                        if j == self.NIL:
                            break
                        i = j
                        self.current[i] += 1
            snc += nnc
            if snc < self.snc_max:
                cc = 1
            if cc == 0:
                break
            # longest-path ranks with eps precision
            bmax = 0
            while self.excq_first != self.NIL:
                i = self._excq_pop()
                i_rank = self.rank[i]
                a = self.first[i]
                a_stop = self.suspended[i + 1]
                while a != a_stop:
                    if r_cap[a] > 0:
                        j = head[a]
                        rc = price[i] + cost[a] - price[j]
                        if rc < 0:
                            dr = int((float(-rc) - 0.5) / self.epsilon)
                            j_rank = dr + i_rank
                            if j_rank < self.linf:
                                if j_rank > self.rank[j]:
                                    self.rank[j] = j_rank
                    a += 1
                if i_rank > 0:
                    if i_rank > bmax:
                        bmax = i_rank
                    self._bucket_insert(i, i_rank)
            if bmax == 0:
                break
            b = bmax
            while b != 0:
                i_rank = b
                dp = i_rank * self.epsilon
                while self.bucket_first[b] != self.DNODE:
                    i = self._bucket_get(b)
                    a = self.first[i]
                    a_stop = self.suspended[i + 1]
                    while a != a_stop:
                        if r_cap[a] > 0:
                            j = head[a]
                            j_rank = self.rank[j]
                            if j_rank < i_rank:
                                rc = price[i] + cost[a] - price[j]
                                if rc < 0:
                                    j_new_rank = i_rank
                                else:
                                    dr = rc // self.epsilon
                                    j_new_rank = (i_rank - (dr + 1)
                                                  if dr < self.linf else 0)
                                if j_rank < j_new_rank:
                                    if cc == 1:
                                        self.rank[j] = j_new_rank
                                        if j_rank > 0:
                                            self._bucket_remove(j, j_rank)
                                        self._bucket_insert(j, j_new_rank)
                                    else:
                                        df = r_cap[a]
                                        self._increase_flow(i, j, a, df)
                        a += 1
                    price[i] -= dp
                b -= 1
            if cc == 0:
                break
        if cc == 0:
            # saturate non-eps-optimal arcs
            for i in range(1, n + 1):
                a = self.first[i]
                a_stop = self.suspended[i + 1]
                while a != a_stop:
                    if (price[i] + cost[a] - price[head[a]]
                            < -self.epsilon):
                        df = r_cap[a]
                        if df > 0:
                            self._increase_flow(i, head[a], a, df)
                    a += 1
        return cc

    # ---------------------------------------------------------- price_out

    def _price_out(self):
        n = self.n
        price, cost, r_cap, head = self.price, self.cost, self.r_cap, self.head
        n_cut_off = -self.cut_off
        for i in range(1, n + 1):
            a = self.first[i]
            a_stop = self.suspended[i + 1]
            while a != a_stop:
                rc = price[i] + cost[a] - price[head[a]]
                if ((rc > self.cut_off and r_cap[self.sister[a]] <= 0)
                        or (rc < n_cut_off and r_cap[a] <= 0)):
                    b = self.first[i]
                    self.first[i] += 1
                    self._parser_swap(a, b)
                a += 1

    # -------------------------------------------------------------- main

    def solve(self, f_sc=SCALE_DEFAULT):
        self._cs_init(int(f_sc))
        cc = 0
        self._update_epsilon()
        while True:   # scaling loop
            self._refine()
            if self.n_ref >= PRICE_OUT_START:
                self._price_out()
            if self._update_epsilon():
                break
            while True:
                if not self._price_refine():
                    break
                if self.n_ref >= PRICE_OUT_START:
                    if self._price_in():
                        break
                    cc = self._update_epsilon()
                    if cc:
                        break
            if cc != 0:
                break
        # finishup: un-scale costs (exact multiples of dn; prices unused)
        for a in range(self.m2):
            c = self.cost[a]
            self.cost[a] = -((-c) // self.dn) if c < 0 else c // self.dn
        obj = 0
        for a in range(self.m2):
            if self.cap[a] > 0:
                fl = self.cap[a] - self.r_cap[a]
                if fl != 0:
                    obj += self.cost[a] * fl
        return obj

    def print_solution(self):
        """The printed triples: walk nodes in id order, every slot in the
        node's (suspended..next.suspended) range with positive original
        capacity — i.e. the forward arcs, in the final permuted slot
        order."""
        out = []
        for i in range(1, self.n + 1):
            a = self.suspended[i]
            a_stop = self.suspended[i + 1]
            while a != a_stop:
                if self.cap[a] > 0:
                    out.append((i, self.head[a], self.cap[a] - self.r_cap[a]))
                a += 1
        return out


def solve_cs2(n_nodes, arcs, f_sc=SCALE_DEFAULT):
    """Solve the min-cost circulation and return (triples, objective):
    `triples` is the exact (tail, head, flow) sequence of the reference
    solver's solution file; raises CS2Error(2) on infeasible instances."""
    s = _CS2(n_nodes, arcs)
    obj = s.solve(f_sc)
    return s.print_solution(), obj
