// mg_native.cpp — native graph-construction engine for metagenomics_tpu.
//
// Replays the overlap-graph construction (BFS edge insertion with
// interleaved Myers transitive reduction, then the contraction/dead-end
// fixpoint) over precomputed, device-verified candidate arrays.  The
// operation order replicates metagenomics_tpu/graph/{core,build,simplify}.py
// exactly — adjacency append/swap-remove order, stable sorts, serial
// numbering, UINT16 manifest offsets — so the resulting graph state
// (including per-read location-list order) is bit-identical to the Python
// reference path.  Python remains the oracle; this is the fast path.
//
// Build: g++ -O2 -shared -fPIC -o libmg_native.so mg_native.cpp
// Interface: plain C ABI consumed via ctypes (no pybind11 dependency).

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <algorithm>
#include <array>
#include <chrono>
#include <deque>
#include <functional>
#include <memory>
#include <queue>
#include <thread>
#include <unordered_map>
#include <vector>

static double now_s() {
    return std::chrono::duration<double>(
        std::chrono::steady_clock::now().time_since_epoch()).count();
}

static bool profile_enabled() {
    static int v = -1;
    if (v < 0) v = getenv("MGTPU_NATIVE_PROFILE") ? 1 : 0;
    return v != 0;
}

#define PROF(name, t0) \
    if (profile_enabled()) \
        fprintf(stderr, "[mg_native] %-12s %.3fs\n", name, now_s() - (t0));

namespace {

struct Man {            // one interior-read manifest entry (8B, memcpy-able)
    int32_t rid;
    uint16_t off;
    uint8_t orient;
    uint8_t _pad;
};

struct Edge {
    int32_t source;         // read ids fit 31 bits (reference UINT64 ids are
    int32_t destination;    // dense 1..numberOfUniqueReads)
    int32_t orient;
    int64_t offset;
    // interior-read manifest.  Storage may be REVERSED (man_rev) so chain
    // contraction can always move the larger side's vector and append the
    // smaller side — O(min) per merge instead of O(sum), which turns
    // long-chain contraction from quadratic to ~linear on low-coverage
    // data.  man_sum caches the sum of the STORED uint16 offsets (order-
    // independent), replacing the per-merge O(len) walk.  Readers outside
    // the fixpoint see normalized storage (finalize_locations flips).
    std::vector<Man> man;
    bool man_rev = false;
    int64_t man_sum = 0;
    Edge *twin = nullptr;
    int64_t serial = 0;
    bool transitive = false;
};

// Adjacency entry: the Edge pointer plus cached immutable fields.  The BFS
// and the Myers triangle loops (mark_transitive) are bound by cache misses
// on Edge dereferences; dest/orient never change after edge creation, so
// caching them inline turns those scans into contiguous reads.
struct AdjE {
    Edge *e;
    int32_t dest;
    uint16_t off;     // cached construction offset (fits the reference's
                      // UINT16 overlapOffset); ONLY read by the
                      // construction-time offset sort — merged composite
                      // offsets may exceed 16 bits but are never sorted
                      // through this field
    int8_t orient;

    AdjE() : e(nullptr), dest(0), off(0), orient(0) {}
    explicit AdjE(Edge *ed)
        : e(ed), dest((int32_t)ed->destination),
          off((uint16_t)ed->offset), orient((int8_t)ed->orient) {}
};

// Per-read row storage (adjacency + read->edge location index).  Owned by
// one graph and SHARED by the per-thread construction graphs: worker
// buckets partition the read ids, so threads touch disjoint rows and the
// outer vectors are never resized — no (n+1)-row allocation per thread.
struct Rows {
    std::vector<std::vector<AdjE>> adj;
    std::vector<std::vector<Edge *>> locf_e, locr_e;
    std::vector<std::vector<int64_t>> locf_d, locr_d;

    explicit Rows(int64_t n)
        : adj(n + 1), locf_e(n + 1), locr_e(n + 1),
          locf_d(n + 1), locr_d(n + 1) {}
};

struct Graph {
    int64_t n_reads;
    const int64_t *lengths;
    int64_t dead_end_length;
    std::unique_ptr<Rows> own_rows;        // null when rows are shared
    std::vector<std::vector<AdjE>> &adj;
    // read -> (edge, location) index, forward/reverse
    std::vector<std::vector<Edge *>> &locf_e, &locr_e;
    std::vector<std::vector<int64_t>> &locf_d, &locr_d;
    int64_t n_nodes = 0;
    int64_t n_edges = 0;
    int64_t serial = 0;
    // log-parity bookkeeping: node/edge counts at BFS end (before the
    // contraction fixpoint) and per-fixpoint-iteration counters
    // {merged, dead_nodes, dead_edges} — summed across thread subsets they
    // reproduce the reference's global per-iteration log counters
    int64_t bfs_nodes = 0;
    int64_t bfs_edges = 0;
    int64_t last_dead_edges = 0;
    std::vector<int64_t> it_merged, it_dead_nodes, it_dead_edges;
    // BFS progress heartbeats (reference: counter%100000 prints,
    // OverlapGraph.cpp:200-201).  Threads record per-component deltas and
    // local snapshots at precomputed global-boundary offsets; the merge
    // step composes them into global (counter, nodes, edges) triples in
    // bfs_heartbeats (assembled on the primary graph only).
    std::vector<std::array<int64_t, 3>> comp_deltas;   // root, dn, de
    std::vector<std::array<int64_t, 3>> local_snaps;   // counter, ln, le
    std::vector<std::array<int64_t, 3>> bfs_heartbeats;
    std::vector<std::array<int64_t, 2>> cont_heartbeats;  // boundary, count
    std::deque<Edge> pool;   // arena: stable addresses, freed with the graph
    std::vector<Edge *> free_list;  // removed edges, reused by new_edge

    explicit Graph(int64_t n, const int64_t *lens, int64_t del)
        : n_reads(n), lengths(lens), dead_end_length(del),
          own_rows(new Rows(n)),
          adj(own_rows->adj), locf_e(own_rows->locf_e),
          locr_e(own_rows->locr_e), locf_d(own_rows->locf_d),
          locr_d(own_rows->locr_d) {}

    Graph(int64_t n, const int64_t *lens, int64_t del, Rows *shared)
        : n_reads(n), lengths(lens), dead_end_length(del),
          adj(shared->adj), locf_e(shared->locf_e), locr_e(shared->locr_e),
          locf_d(shared->locf_d), locr_d(shared->locr_d) {}

    Edge *new_edge(int64_t s, int64_t d, int32_t o, int64_t off) {
        // (ids are int32 internally; the ABI stays int64)
        Edge *e;
        if (!free_list.empty()) {
            e = free_list.back();
            free_list.pop_back();
            e->man.clear();
        } else {
            pool.emplace_back();
            e = &pool.back();
        }
        e->source = (int32_t)s;
        e->destination = (int32_t)d;
        e->orient = o;
        e->offset = off;
        e->serial = ++serial;
        e->twin = nullptr;
        e->transitive = false;
        e->man_rev = false;
        e->man_sum = 0;
        return e;
    }

    // Most edges are transitive and die during the BFS; reuse keeps the
    // working set at the live-edge count instead of the 10x larger
    // total-allocation count.  Only called once both twin entries are
    // unlinked from the adjacency lists.
    void free_edge_pair(Edge *e) {
        free_list.push_back(e);
        free_list.push_back(e->twin);
    }

    void finalize_locations(const int64_t *nodes, size_t nn) {
        for (size_t ni = 0; ni < nn; ni++) {
            int64_t i = nodes[ni];
            for (const AdjE &a : adj[i]) {
                Edge *e = a.e;
                // normalize reversed manifest storage (merge_list) before
                // anything outside the fixpoint reads it; idempotent, and
                // each edge belongs to exactly one bucket's node set
                if (e->man_rev) {
                    std::reverse(e->man.begin(), e->man.end());
                    e->man_rev = false;
                }
                int64_t dist = 0;
                for (size_t k = 0; k < e->man.size(); k++) {
                    dist += e->man[k].off;
                    int64_t rid = e->man[k].rid;
                    if (e->man[k].orient == 1) {
                        locf_e[rid].push_back(e);
                        locf_d[rid].push_back(dist);
                    } else {
                        locr_e[rid].push_back(e);
                        locr_d[rid].push_back(dist);
                    }
                }
            }
        }
    }

    void insert_edge_obj(Edge *e) {
        auto &lst = adj[e->source];
        if (lst.empty()) n_nodes++;
        lst.push_back(AdjE(e));
        n_edges++;
        // NOTE: read-location upkeep is deferred to finalize_locations():
        // during construction every read is interior to at most one live
        // edge-pair, so the final lists are singletons independent of the
        // push/swap-remove history the reference performs
        // (OverlapGraph.cpp:1048-1115).
    }

    void insert_edge(int64_t r1, int64_t r2, int32_t orient, int64_t offset) {
        Edge *e1 = new_edge(r1, r2, orient, offset);
        int64_t rev_off = lengths[r2] + offset - lengths[r1];
        Edge *e2 = new_edge(r2, r1, twin_orient(orient), rev_off);
        e1->twin = e2;
        e2->twin = e1;
        insert_edge_obj(e1);
        insert_edge_obj(e2);
    }

    static int32_t twin_orient(int32_t o) {
        switch (o) {
            case 0: return 3;
            case 1: return 1;
            case 2: return 2;
            default: return 0;
        }
    }

    static bool match_edge_type(const Edge *e1, const Edge *e2) {
        if ((e1->orient == 1 || e1->orient == 3)
            && (e2->orient == 2 || e2->orient == 3)) return true;
        if ((e1->orient == 0 || e1->orient == 2)
            && (e2->orient == 0 || e2->orient == 1)) return true;
        return false;
    }

    static int32_t merged_orient(const Edge *e1, const Edge *e2) {
        int32_t a = e1->orient, b = e2->orient;
        if (a == 0 && b == 0) return 0;
        if (a == 0 && b == 1) return 1;
        if (a == 1 && b == 2) return 0;
        if (a == 1 && b == 3) return 1;
        if (a == 2 && b == 0) return 2;
        if (a == 2 && b == 1) return 3;
        if (a == 3 && b == 2) return 2;
        return 3;  // (3,3)
    }

    void remove_edge(Edge *e) {
        Edge *targets[2] = {e->twin, e};
        int64_t nodes[2] = {e->destination, e->source};
        int unlinked = 0;
        for (int k = 0; k < 2; k++) {
            auto &lst = adj[nodes[k]];
            for (size_t i = 0; i < lst.size(); i++) {
                if (lst[i].e == targets[k]) {
                    lst[i] = lst.back();
                    lst.pop_back();
                    if (lst.empty()) n_nodes--;
                    n_edges--;
                    unlinked++;
                    break;
                }
            }
        }
        if (unlinked == 2) free_edge_pair(e);
    }

    static void extend_back(std::vector<Man> &v, const std::vector<Man> &s,
                            bool reversed_iter) {
        if (!reversed_iter) v.insert(v.end(), s.begin(), s.end());
        else v.insert(v.end(), s.rbegin(), s.rend());
    }

    // Assemble out.man = [man(e1), common, man(e2)] (logical order),
    // CONSUMING e1/e2's manifests: the larger side's vector is moved and
    // the smaller appended, using reversed storage when the big side is
    // the suffix.  Occasional O(big) normalization flips happen only when
    // an accumulated edge alternates prefix/suffix roles.
    void merge_list(Edge *e1, Edge *e2, Edge *out) {
        Man common;
        common.rid = (int32_t)e1->destination;
        common.off = (uint16_t)((e1->offset - e1->man_sum) & 0xFFFF);
        common.orient = (e1->orient == 1 || e1->orient == 3) ? 1 : 0;
        common._pad = 0;
        out->man_sum = e1->man_sum + common.off + e2->man_sum;
        size_t n1 = e1->man.size(), n2 = e2->man.size();
        if (n1 >= n2) {
            if (e1->man_rev) {
                std::reverse(e1->man.begin(), e1->man.end());
                e1->man_rev = false;
            }
            out->man = std::move(e1->man);
            out->man_rev = false;
            out->man.reserve(n1 + n2 + 1);
            out->man.push_back(common);
            extend_back(out->man, e2->man, e2->man_rev);
        } else {
            if (!e2->man_rev) {
                std::reverse(e2->man.begin(), e2->man.end());
                e2->man_rev = true;
            }
            out->man = std::move(e2->man);
            out->man_rev = true;
            out->man.reserve(n1 + n2 + 1);
            out->man.push_back(common);
            // logical prepend of e1 = storage append in logical-reverse
            extend_back(out->man, e1->man, !e1->man_rev);
        }
        e1->man.clear();
        e2->man.clear();
        e1->man_rev = e2->man_rev = false;
        e1->man_sum = e2->man_sum = 0;
    }

    // Construction-phase mergeEdges: flows are all zero pre-flow, so both
    // source edges are always removed (matches Python merge_edges semantics
    // with flow==0).
    void merge_edges(Edge *e1, Edge *e2) {
        int64_t r1 = e1->source, r2 = e2->destination;
        int32_t of = merged_orient(e1, e2);
        Edge *fwd = new_edge(r1, r2, of, e1->offset + e2->offset);
        merge_list(e1, e2, fwd);
        Edge *rev = new_edge(r2, r1, twin_orient(of),
                             e2->twin->offset + e1->twin->offset);
        merge_list(e2->twin, e1->twin, rev);
        fwd->twin = rev;
        rev->twin = fwd;
        insert_edge_obj(fwd);
        insert_edge_obj(rev);
        remove_edge(e1);
        remove_edge(e2);
    }

    bool is_edge_present(int64_t s, int64_t d) const {
        for (const AdjE &a : adj[s])
            if (a.dest == d) return true;
        return false;
    }

    int64_t contract_composite_paths(const int64_t *nodes, size_t nn) {
        int64_t counter = 0;
        for (size_t ni = 0; ni < nn; ni++) {
            int64_t i = nodes[ni];
            if (adj[i].size() == 2) {
                Edge *e1 = adj[i][0].e;
                Edge *e2 = adj[i][1].e;
                if (!is_edge_present(e1->destination, e2->destination)) {
                    if (match_edge_type(e1->twin, e2)
                        && e1->source != e1->destination) {
                        merge_edges(e1->twin, e2);
                        counter++;
                    }
                }
            }
        }
        return counter;
    }

    int64_t remove_dead_end_nodes(const int64_t *node_ids, size_t nn) {
        std::vector<int64_t> nodes;
        for (size_t ni = 0; ni < nn; ni++) {
            int64_t i = node_ids[ni];
            auto &lst = adj[i];
            if (lst.empty()) continue;
            bool flag = false;
            int64_t in_e = 0, out_e = 0;
            for (const AdjE &a : lst) {
                if ((int64_t)a.e->man.size() > dead_end_length
                    || a.e->source == a.dest) {
                    flag = true;
                    break;
                }
                if (a.orient == 0 || a.orient == 1) in_e++;
                else out_e++;
            }
            if (!flag && ((in_e > 0 && out_e == 0)
                          || (in_e == 0 && out_e > 0)))
                nodes.push_back(i);
        }
        last_dead_edges = 0;
        for (int64_t nid : nodes) {
            if (!adj[nid].empty()) {
                // edgesRemoved counts the list size at removal time
                // (OverlapGraph.cpp:935)
                last_dead_edges += (int64_t)adj[nid].size();
                std::vector<AdjE> edges(adj[nid].begin(), adj[nid].end());
                for (const AdjE &a : edges) remove_edge(a.e);
            }
        }
        return (int64_t)nodes.size();
    }

    void mark_transitive(int64_t rn, int8_t *mark) {
        const std::vector<AdjE> &lst = adj[rn];
        for (const AdjE &a : lst) mark[a.dest] = 1;  // INPLAY
        for (const AdjE &a : lst) {
            int32_t r2 = a.dest;
            if (mark[r2] == 1) {
                // t1-side predicate hoisted: in-edges pair with {0,1},
                // out-edges with {2,3} (OverlapGraph.cpp:593-596)
                bool t1_in = (a.orient == 0 || a.orient == 2);
                for (const AdjE &b : adj[r2]) {
                    if (mark[b.dest] == 1) {
                        bool t2_in = (b.orient == 0 || b.orient == 1);
                        if (t1_in == t2_in) mark[b.dest] = 2;  // ELIMINATED
                    }
                }
            }
        }
        for (const AdjE &a : lst) {
            if (mark[a.dest] == 2) {
                a.e->transitive = true;
                a.e->twin->transitive = true;
            }
        }
        for (const AdjE &a : lst) mark[a.dest] = 0;
        mark[rn] = 0;
    }

    void remove_transitive(int64_t rn) {
        auto &lst = adj[rn];
        size_t index = 0;
        while (index < lst.size()) {
            if (lst[index].e->transitive) {
                Edge *twin = lst[index].e->twin;
                auto &tl = adj[twin->source];
                for (size_t i1 = 0; i1 < tl.size(); i1++) {
                    if (tl[i1].e == twin) {
                        tl[i1] = tl.back();
                        tl.pop_back();
                        if (tl.empty()) n_nodes--;
                        n_edges--;
                        break;
                    }
                }
            }
            index++;
        }
        size_t jj = 0;
        for (size_t i = 0; i < lst.size(); i++) {
            if (!lst[i].e->transitive) {
                lst[jj++] = lst[i];
            } else {
                // twin already unlinked in the loop above; both objects are
                // now unreferenced and can be recycled
                free_edge_pair(lst[i].e);
                n_edges--;
            }
        }
        lst.resize(jj);
        // drop the pre-reduction capacity: rows peak at the raw overlap
        // degree (~coverage) but keep only the irreducible edges, so the
        // capacity overhang across all rows is ~coverage x the final
        // adjacency bytes
        if (lst.capacity() > lst.size() * 2 + 4)
            lst.shrink_to_fit();
        if (lst.empty()) n_nodes--;
    }
};

struct Result {
    Graph *g;
    std::vector<Graph *> extra;   // thread-local graphs (own edge pools)
    // flattened edge table in emission order
    std::vector<Edge *> order;
    std::vector<int64_t> man_start;
    int64_t total_manifest = 0;
    std::vector<int64_t> supers;   // contained-read assignment (mg_assemble)
};

// ---------------------------------------------------------------------------
// Full overlap-detection engine (exact 128-bit l-mer keys), the host
// equivalent of the reference's HashTable + probe loops
// (MetaGenomics/HashTable.cpp:50-221, OverlapGraph.cpp:225-290, 529-565).
// For l <= 64 the key covers the whole seed, so verification only compares
// the extension, exactly like the reference's checkOverlap (:354-383).  For
// l > 64 the 128-bit key covers only the LAST 64 seed bases; verification
// then also memcmps the first l-64 seed bases, mirroring the reference's
// full-string recheck per hash slot (HashTable.cpp:207-219).
// ---------------------------------------------------------------------------

typedef unsigned __int128 key_t128;

struct IndexEntry {
    key_t128 key;
    int32_t rid;
    int8_t orient;
};

struct EdgeCand {
    int32_t r1;
    int32_t r2;
    int8_t eo;
    int16_t eoff;
};

struct ContHit {
    int32_t r1;
    int32_t r2;
};

struct OverlapScratch {
    std::vector<EdgeCand> cands;
    std::vector<ContHit> cont;
};

static inline uint64_t mix_key(key_t128 k) {
    return (uint64_t)k * 0x9E3779B97F4A7C15ULL
         ^ (uint64_t)(k >> 64) * 0xC2B2AE3D27D4EB4FULL;
}

// scan one read range, emitting edge candidates + containment hits in
// (read asc, j asc, bucket order) — the reference's discovery order
static void scan_reads(
    int64_t r_begin, int64_t r_end, const int64_t *lengths,
    const uint8_t *codes_fwd, const uint8_t *codes_rev, int64_t lmax,
    int64_t l, bool mixed, const IndexEntry *idx, size_t n_idx,
    const uint64_t *bloom, const uint32_t *range_tab, int range_shift,
    OverlapScratch *out) {
    const key_t128 mask =
        (l * 2 >= 128) ? ~(key_t128)0 : (((key_t128)1 << (2 * l)) - 1);
    // per-read survivor buffer: the probe chain (bloom word -> range bucket
    // -> index entries) is three dependent random accesses; staging the
    // bloom survivors per read and prefetching the next stage's lines turns
    // serial miss latency into overlapped misses
    struct Probe {
        int32_t j;
        key_t128 key;
        uint32_t lo, hi;
    };
    std::vector<Probe> pass;
    for (int64_t i = r_begin; i < r_end; i++) {
        int64_t len1 = lengths[i];
        if (len1 <= l) continue;
        const uint8_t *s1 = codes_fwd + i * lmax;
        // stage 1: rolling exact key over s1[j .. j+l), bloom test, prefetch
        // the range-table line for survivors
        pass.clear();
        key_t128 key = 0;
        for (int64_t k = 0; k < l; k++) key = (key << 2) | (s1[k] & 3);
        for (int64_t j = 1; j < len1 - l; j++) {
            key = ((key << 2) | (s1[j + l - 1] & 3)) & mask;
            uint64_t h = mix_key(key);
            uint64_t bit = h & ((1ULL << 24) - 1);
            if (!(bloom[bit >> 6] >> (bit & 63) & 1)) continue;
            __builtin_prefetch(&range_tab[(uint64_t)(key >> range_shift)]);
            pass.push_back({(int32_t)j, key, 0, 0});
        }
        // stage 2: range lookups, prefetch the first index line per bucket
        for (Probe &pr : pass) {
            uint64_t p = (uint64_t)(pr.key >> range_shift);
            pr.lo = range_tab[p];
            pr.hi = range_tab[p + 1];
            if (pr.lo < pr.hi) __builtin_prefetch(&idx[pr.lo]);
        }
        // stage 3: binary search within the (tiny) bucket + verification
        for (const Probe &pr : pass) {
            int64_t j = pr.j;
            key_t128 pkey = pr.key;
            size_t lo = pr.lo, hi = pr.hi;
            while (lo < hi) {
                size_t mid = (lo + hi) >> 1;
                if (idx[mid].key < pkey) lo = mid + 1;
                else hi = mid;
            }
            for (size_t e = lo; e < n_idx && idx[e].key == pkey; e++) {
                int32_t r2 = idx[e].rid;
                int8_t orient = idx[e].orient;
                int64_t len2 = lengths[r2];
                const uint8_t *s2 = (orient <= 1 ? codes_fwd : codes_rev)
                                    + (int64_t)r2 * lmax;
                bool is_pre = (orient == 0 || orient == 2);
                if (l > 64) {
                    // the key covers only the last 64 seed bases; re-check
                    // the uncovered prefix of the seed against s2's seed
                    // (prefix candidates: s2[0..l), suffix: s2[len2-l..len2))
                    const uint8_t *seed2 = is_pre ? s2 : s2 + (len2 - l);
                    if (memcmp(s1 + j, seed2, (size_t)(l - 64)) != 0)
                        continue;
                }
                // edge verification (checkOverlap, extension only)
                bool edge_ok;
                if (is_pre) {
                    edge_ok = (len1 - j < len2)
                        && memcmp(s1 + j + l, s2 + l,
                                  (size_t)(len1 - j - l)) == 0;
                } else {
                    edge_ok = (len2 - l >= j)
                        && memcmp(s1, s2 + (len2 - l - j), (size_t)j) == 0;
                }
                if (edge_ok) {
                    EdgeCand c;
                    c.r1 = (int32_t)i;
                    c.r2 = r2;
                    if (orient == 0) { c.eo = 3; c.eoff = (int16_t)j; }
                    else if (orient == 1) { c.eo = 0; c.eoff = (int16_t)(len1 - l - j); }
                    else if (orient == 2) { c.eo = 2; c.eoff = (int16_t)j; }
                    else { c.eo = 1; c.eoff = (int16_t)(len1 - l - j); }
                    out->cands.push_back(c);
                }
                if (mixed && len1 > len2) {
                    // containment (checkOverlapForContainedRead)
                    int64_t m2 = len2 - l;
                    bool cont_ok;
                    if (is_pre) {
                        cont_ok = (len1 - j - l >= m2)
                            && memcmp(s1 + j + l, s2 + l, (size_t)m2) == 0;
                    } else {
                        cont_ok = (j >= m2)
                            && memcmp(s1 + j - m2, s2, (size_t)m2) == 0;
                    }
                    if (cont_ok)
                        out->cont.push_back({(int32_t)i, r2});
                }
            }
        }
    }
}

}  // namespace

namespace {


// BFS + transitive reduction + contraction fixpoint over a node subset
// (ascending read ids).  The subset must be closed under connectivity of the
// candidate graph, so per-subset processing equals the reference's global
// processing restricted to those components.
// root (= component min node id) -> [(local dequeue offset, global counter)]
typedef std::unordered_map<int64_t, std::vector<std::array<int64_t, 2>>>
    BfsTargets;

void run_construction(Graph *g, const int64_t *nodes, size_t nn,
                      const int64_t *cand_start, const int32_t *cand_dest,
                      const int8_t *cand_orient, const int32_t *cand_offset,
                      int8_t *explored, int8_t *mark,
                      const BfsTargets *bfs_targets = nullptr) {
    double t0 = now_s();
    // env-gated sub-phase accounting (MGTPU_NATIVE_PROFILE=2): where the
    // BFS wall goes — insertion+sort vs Myers marking vs removal
    const bool prof2 = profile_enabled() && getenv("MGTPU_NATIVE_PROFILE")
                       && getenv("MGTPU_NATIVE_PROFILE")[0] == '2';
    double a_ins = 0, a_mark = 0, a_rem = 0;
    std::vector<int64_t> queue;
    auto insert_all = [&](int64_t rn) {
        double s = prof2 ? now_s() : 0;
        {
            // pre-size the adjacency row: its own candidates plus a
            // similar count of twin entries arriving from neighbors —
            // skips ~5 doubling reallocations per row
            auto &lst0 = g->adj[rn];
            int64_t own = cand_start[rn + 1] - cand_start[rn];
            if ((int64_t)lst0.capacity() < 2 * own)
                lst0.reserve(2 * own);
        }
        for (int64_t k = cand_start[rn]; k < cand_start[rn + 1]; k++) {
            int64_t dest = cand_dest[k];
            if (explored[dest] != 0) continue;
            g->insert_edge(rn, dest, cand_orient[k], cand_offset[k]);
        }
        auto &lst = g->adj[rn];
        // plain std::sort to match the reference's introsort tie order for
        // equal offsets (OverlapGraph.cpp:563)
        if (!lst.empty())
            std::sort(lst.begin(), lst.end(),
                      [](const AdjE &a, const AdjE &b) {
                          return a.off < b.off;   // cached: no Edge deref
                      });
        if (prof2) a_ins += now_s() - s;
    };
    auto mark_tr = [&](int64_t rn) {
        double s = prof2 ? now_s() : 0;
        g->mark_transitive(rn, mark);
        if (prof2) a_mark += now_s() - s;
    };
    auto remove_tr = [&](int64_t rn) {
        double s = prof2 ? now_s() : 0;
        g->remove_transitive(rn);
        if (prof2) a_rem += now_s() - s;
    };

    for (size_t ni = 0; ni < nn; ni++) {
        int64_t i = nodes[ni];
        if (explored[i] != 0) continue;
        queue.clear();
        queue.push_back(i);
        size_t start = 0;
        // heartbeat bookkeeping: queue runs start at their component's
        // minimum node id, so `i` keys the precomputed boundary targets
        const std::vector<std::array<int64_t, 2>> *tg = nullptr;
        size_t tg_i = 0;
        int64_t run_n0 = g->n_nodes, run_e0 = g->n_edges, local_cnt = 0;
        if (bfs_targets) {
            auto it = bfs_targets->find(i);
            if (it != bfs_targets->end()) tg = &it->second;
        }
        while (start < queue.size()) {
            int64_t read1 = queue[start++];
            local_cnt++;
            if (explored[read1] == 0) {
                insert_all(read1);
                explored[read1] = 1;
            }
            if (!g->adj[read1].empty()) {
                if (explored[read1] == 1) {
                    for (size_t i1 = 0; i1 < g->adj[read1].size(); i1++) {
                        int64_t read2 = g->adj[read1][i1].dest;
                        if (explored[read2] == 0) {
                            queue.push_back(read2);
                            insert_all(read2);
                            explored[read2] = 1;
                        }
                    }
                    mark_tr(read1);
                    explored[read1] = 2;
                }
                if (explored[read1] == 2) {
                    for (size_t i1 = 0; i1 < g->adj[read1].size(); i1++) {
                        int64_t read2 = g->adj[read1][i1].dest;
                        if (explored[read2] == 1) {
                            for (size_t i2 = 0; i2 < g->adj[read2].size();
                                 i2++) {
                                int64_t read3 = g->adj[read2][i2].dest;
                                if (explored[read3] == 0) {
                                    queue.push_back(read3);
                                    insert_all(read3);
                                    explored[read3] = 1;
                                }
                            }
                            mark_tr(read2);
                            explored[read2] = 2;
                        }
                    }
                    remove_tr(read1);
                }
            }
            if (tg && tg_i < tg->size() && local_cnt == (*tg)[tg_i][0]) {
                // snapshot AFTER processing this dequeue, like the
                // reference's end-of-loop counter check
                g->local_snaps.push_back({(*tg)[tg_i][1],
                                          g->n_nodes - run_n0,
                                          g->n_edges - run_e0});
                tg_i++;
            }
        }
        if (bfs_targets && (g->n_nodes != run_n0 || g->n_edges != run_e0))
            g->comp_deltas.push_back({i, g->n_nodes - run_n0,
                                      g->n_edges - run_e0});
    }

    if (prof2)
        fprintf(stderr, "[mg_native]   bfs-sub ins=%.3f mark=%.3f rem=%.3f\n",
                a_ins, a_mark, a_rem);
    PROF("  bfs", t0); t0 = now_s();
    g->bfs_nodes = g->n_nodes;
    g->bfs_edges = g->n_edges;
    while (true) {
        int64_t merged = g->contract_composite_paths(nodes, nn);
        int64_t dead = g->remove_dead_end_nodes(nodes, nn);
        g->it_merged.push_back(merged);
        g->it_dead_nodes.push_back(dead);
        g->it_dead_edges.push_back(g->last_dead_edges);
        if (merged + dead == 0) break;
    }
    PROF("  contract", t0); t0 = now_s();
    g->finalize_locations(nodes, nn);
    PROF("  finloc", t0);
}

// Precompute the BFS heartbeat boundaries (counter multiples of 100000,
// OverlapGraph.cpp:200-201) against the component structure, and compose
// the recorded per-component deltas/snapshots into global triples.  The
// global dequeue sequence is the components in ascending min-node order,
// each contributing exactly its node count.
struct BfsPlan {
    BfsTargets targets;
    std::vector<int64_t> roots_in_order;
    std::vector<std::array<int64_t, 3>> boundaries;  // counter, root, local
};

static void build_bfs_plan(int64_t n_reads,
                           const std::function<int32_t(int32_t)> &find,
                           BfsPlan &plan) {
    if (n_reads < 100000) return;
    std::vector<int64_t> comp_size(n_reads + 1, 0);
    for (int64_t i = 1; i <= n_reads; i++) comp_size[find((int32_t)i)]++;
    std::vector<int8_t> seen(n_reads + 1, 0);
    std::vector<int64_t> sizes;
    for (int64_t i = 1; i <= n_reads; i++) {
        int32_t c = find((int32_t)i);
        if (!seen[c]) {
            seen[c] = 1;
            plan.roots_in_order.push_back(i);
            sizes.push_back(comp_size[c]);
        }
    }
    size_t ci = 0;
    int64_t pref = 0;
    for (int64_t b = 100000; b <= n_reads; b += 100000) {
        while (pref + sizes[ci] < b) {
            pref += sizes[ci];
            ci++;
        }
        plan.boundaries.push_back({b, plan.roots_in_order[ci], b - pref});
        if (sizes[ci] > 1)
            plan.targets[plan.roots_in_order[ci]].push_back({b - pref, b});
    }
}

static void compose_bfs_heartbeats(const BfsPlan &plan,
                                   const std::vector<Graph *> &graphs,
                                   Graph *g0) {
    if (plan.boundaries.empty()) return;
    std::unordered_map<int64_t, std::array<int64_t, 2>> delta_by_root;
    std::unordered_map<int64_t, std::array<int64_t, 2>> snap_by_counter;
    for (Graph *g : graphs) {
        if (!g) continue;
        for (auto &d : g->comp_deltas)
            delta_by_root[d[0]] = {{d[1], d[2]}};
        for (auto &s : g->local_snaps)
            snap_by_counter[s[0]] = {{s[1], s[2]}};
    }
    int64_t pn = 0, pe = 0;
    size_t bi = 0;
    for (int64_t root : plan.roots_in_order) {
        while (bi < plan.boundaries.size()
               && plan.boundaries[bi][1] == root) {
            int64_t counter = plan.boundaries[bi][0];
            int64_t ln = 0, le = 0;
            auto it = snap_by_counter.find(counter);
            if (it != snap_by_counter.end()) {
                ln = it->second[0];
                le = it->second[1];
            }
            g0->bfs_heartbeats.push_back({counter, pn + ln, pe + le});
            bi++;
        }
        if (bi >= plan.boundaries.size()) break;
        auto dt = delta_by_root.find(root);
        if (dt != delta_by_root.end()) {
            pn += dt->second[0];
            pe += dt->second[1];
        }
    }
}

Result *finish_result(Graph *g) {
    Result *res = new Result();
    res->g = g;
    for (int64_t i = 1; i <= g->n_reads; i++)
        for (const AdjE &a : g->adj[i]) {
            res->man_start.push_back(res->total_manifest);
            res->total_manifest += (int64_t)a.e->man.size();
            res->order.push_back(a.e);
        }
    return res;
}

Result *build_core(int64_t n_reads, const int64_t *lengths,
                   const int64_t *cand_start, const int32_t *cand_dest,
                   const int8_t *cand_orient, const int32_t *cand_offset,
                   int64_t dead_end_length) {
    Graph *g = new Graph(n_reads, lengths, dead_end_length);
    std::vector<int8_t> explored(n_reads + 1, 0);
    std::vector<int8_t> mark(n_reads + 1, 0);
    std::vector<int64_t> all_nodes(n_reads);
    for (int64_t i = 0; i < n_reads; i++) all_nodes[i] = i + 1;
    BfsPlan plan;
    if (n_reads >= 100000) {
        std::vector<int32_t> uf(n_reads + 1);
        for (int64_t i = 0; i <= n_reads; i++) uf[i] = (int32_t)i;
        std::function<int32_t(int32_t)> find = [&](int32_t x) {
            while (uf[x] != x) { uf[x] = uf[uf[x]]; x = uf[x]; }
            return x;
        };
        for (int64_t r1 = 1; r1 <= n_reads; r1++)
            for (int64_t k = cand_start[r1]; k < cand_start[r1 + 1]; k++) {
                int32_t a = find((int32_t)r1),
                        b = find((int32_t)cand_dest[k]);
                if (a != b) uf[b] = a;
            }
        build_bfs_plan(n_reads, find, plan);
    }
    run_construction(g, all_nodes.data(), all_nodes.size(), cand_start,
                     cand_dest, cand_orient, cand_offset, explored.data(),
                     mark.data(), plan.boundaries.empty() ? nullptr
                                                         : &plan.targets);
    compose_bfs_heartbeats(plan, {g}, g);
    return finish_result(g);
}

// Threaded BFS construction over a filtered per-read candidate stream:
// connected components, load-balanced component buckets, per-bucket
// construction on disjoint graph rows, row merge.  Shared by the full
// native engine (mg_assemble) and the device-pipeline replay
// (mg_build_stream).
Result *construct_threaded(int64_t n_reads, const int64_t *lengths,
                                int64_t dead_end_length, int nt,
                                const std::vector<int64_t> &cstart,
                                const std::vector<int32_t> &cdest,
                                const std::vector<int8_t> &corient,
                                const std::vector<int32_t> &coffset) {
    double t0 = now_s();
    std::vector<int32_t> uf(n_reads + 1);
    for (int64_t i = 0; i <= n_reads; i++) uf[i] = (int32_t)i;
    std::function<int32_t(int32_t)> find = [&](int32_t x) {
        while (uf[x] != x) { uf[x] = uf[uf[x]]; x = uf[x]; }
        return x;
    };
    for (int64_t r1 = 1; r1 <= n_reads; r1++)
        for (int64_t k = cstart[r1]; k < cstart[r1 + 1]; k++) {
            int32_t a = find((int32_t)r1), b = find((int32_t)cdest[k]);
            if (a != b) uf[b] = a;
        }
    BfsPlan plan;
    build_bfs_plan(n_reads, find, plan);
    // bucket components across threads, balancing candidate counts
    std::vector<int64_t> comp_load(n_reads + 1, 0);
    for (int64_t r1 = 1; r1 <= n_reads; r1++)
        comp_load[find((int32_t)r1)] += (cstart[r1 + 1] - cstart[r1]) + 1;
    std::vector<int32_t> roots;
    for (int64_t i = 1; i <= n_reads; i++)
        if (find((int32_t)i) == i && comp_load[i] > 1) roots.push_back((int32_t)i);
    std::sort(roots.begin(), roots.end(), [&](int32_t a, int32_t b) {
        return comp_load[a] > comp_load[b];
    });
    std::vector<int32_t> bucket_of(n_reads + 1, 0);
    std::vector<int64_t> bucket_load(nt, 0);
    for (int32_t root : roots) {
        int best = 0;
        for (int t = 1; t < nt; t++)
            if (bucket_load[t] < bucket_load[best]) best = t;
        bucket_load[best] += comp_load[root];
        bucket_of[root] = (int32_t)best;
    }
    std::vector<std::vector<int64_t>> bucket_nodes(nt);
    for (int64_t i = 1; i <= n_reads; i++)
        bucket_nodes[bucket_of[find((int32_t)i)]].push_back(i);
    PROF("components", t0); t0 = now_s();

    // --- per-bucket construction: ONE shared row store (buckets partition
    // the read ids, so threads write disjoint rows), per-thread edge pools
    std::vector<Graph *> graphs(nt, nullptr);
    {
        std::vector<std::thread> workers;
        graphs[0] = new Graph(n_reads, lengths, dead_end_length);
        for (int t = 1; t < nt; t++) {
            graphs[t] = new Graph(n_reads, lengths, dead_end_length,
                                  graphs[0]->own_rows.get());
            graphs[t]->serial = (int64_t)t << 40;
        }
        auto work = [&](int t) {
            std::vector<int8_t> explored(n_reads + 1, 0);
            std::vector<int8_t> mark(n_reads + 1, 0);
            run_construction(graphs[t], bucket_nodes[t].data(),
                             bucket_nodes[t].size(), cstart.data(),
                             cdest.data(), corient.data(), coffset.data(),
                             explored.data(), mark.data(),
                             plan.boundaries.empty() ? nullptr
                                                     : &plan.targets);
        };
        if (nt == 1) work(0);
        else {
            for (int t = 0; t < nt; t++) workers.emplace_back(work, t);
            for (auto &th : workers) th.join();
        }
    }
    // fold per-thread counters into bucket 0's graph (rows already shared)
    Graph *g0 = graphs[0];
    for (int t = 1; t < nt; t++) {
        Graph *gt = graphs[t];
        g0->n_nodes += gt->n_nodes;
        g0->n_edges += gt->n_edges;
        g0->bfs_nodes += gt->bfs_nodes;
        g0->bfs_edges += gt->bfs_edges;
        // per-iteration fixpoint logs sum elementwise (components are
        // disjoint, so the global iteration-k counters are the subset sums)
        if (gt->it_merged.size() > g0->it_merged.size()) {
            g0->it_merged.resize(gt->it_merged.size(), 0);
            g0->it_dead_nodes.resize(gt->it_merged.size(), 0);
            g0->it_dead_edges.resize(gt->it_merged.size(), 0);
        }
        for (size_t k = 0; k < gt->it_merged.size(); k++) {
            g0->it_merged[k] += gt->it_merged[k];
            g0->it_dead_nodes[k] += gt->it_dead_nodes[k];
            g0->it_dead_edges[k] += gt->it_dead_edges[k];
        }
        if (gt->serial > g0->serial) g0->serial = gt->serial;
    }
    compose_bfs_heartbeats(plan, graphs, g0);
    PROF("build", t0); t0 = now_s();
    Result *res = finish_result(g0);
    for (int t = 1; t < nt; t++) res->extra.push_back(graphs[t]);
    PROF("finish", t0);
    return res;
}


// Record accessors for the two canonical stream encodings: the
// (r2, meta) pair arrays of mg_build_stream, and the device pipeline's
// packed uint32 words [r2 | flags:4 | offset:off_bits].
struct CanonPairs {
    const int32_t *r2s;
    const uint16_t *metas;
    inline int64_t r2(int64_t k) const { return r2s[k]; }
    inline int64_t eo(int64_t k) const { return metas[k] & 3; }
    inline int64_t off(int64_t k) const { return metas[k] >> 4; }
};
struct CanonWords {
    const uint32_t *words;
    int ob;
    inline int64_t r2(int64_t k) const { return words[k] >> (4 + ob); }
    inline int64_t eo(int64_t k) const { return (words[k] >> ob) & 3; }
    inline int64_t off(int64_t k) const {
        return words[k] & ((1u << ob) - 1);
    }
};

template <class Rec>
static void *canon_core(int64_t n_reads, const int64_t *lengths,
                        const int64_t *counts, const Rec &rec,
                        int64_t hash_len, int64_t dead_end_length, int nt) {
    double t0 = now_s();
    const int64_t l = hash_len;

    // pass 1: per-read direct / mirror candidate counts
    std::vector<int64_t> dcount(n_reads + 2, 0), mcount(n_reads + 2, 0);
    {
        int64_t k = 0;
        for (int64_t r1 = 1; r1 <= n_reads; r1++) {
            dcount[r1] = counts[r1];
            for (int64_t e = k + counts[r1]; k < e; k++) {
                const int64_t r2 = rec.r2(k);
                if (r2 != r1) mcount[r2]++;
            }
        }
    }
    std::vector<int64_t> cstart(n_reads + 2, 0);
    for (int64_t r = 1; r <= n_reads + 1; r++)
        cstart[r] = cstart[r - 1] + dcount[r - 1] + mcount[r - 1];
    const int64_t total = cstart[n_reads + 1];

    // pass 2: fill (sort key, offset) — key packs the discovery order
    // (j, partner, hash orientation) into one uint64 (j:12|dest:31|or:2),
    // so a plain uint64 compare is the lexicographic order.  Direct
    // entries land at [cstart[r], cstart[r]+dcount[r]) ALREADY in
    // discovery order (the canonical stream is an order-preserving
    // subsequence of each read's probe sequence); mirrors land after and
    // are sorted, then the two sorted runs merge in place.  The two fill
    // sides write disjoint slot ranges, so they run as two threads.
    struct CanonEnt {
        uint64_t key;
        int32_t off;
    };
    std::vector<CanonEnt> ents(total);
    auto pack = [](int64_t j, int64_t dest, int64_t orient, int64_t off) {
        CanonEnt e;
        e.key = ((uint64_t)j << 33) | ((uint64_t)dest << 2)
                | (uint64_t)orient;
        e.off = (int32_t)off;
        return e;
    };
    auto fill_direct = [&]() {
        int64_t k = 0;
        for (int64_t r1 = 1; r1 <= n_reads; r1++) {
            const int64_t len1 = lengths[r1];
            CanonEnt *dst = ents.data() + cstart[r1];
            for (int64_t e = k + counts[r1]; k < e; k++) {
                const int64_t eo = rec.eo(k);
                const int64_t off = rec.off(k);
                const int64_t j1 = (eo >= 2) ? off : len1 - l - off;
                *dst++ = pack(j1, rec.r2(k), eo, off);
            }
        }
    };
    auto fill_mirror = [&]() {
        std::vector<int64_t> cur(n_reads + 1);
        for (int64_t r = 1; r <= n_reads; r++)
            cur[r] = cstart[r] + dcount[r];
        int64_t k = 0;
        for (int64_t r1 = 1; r1 <= n_reads; r1++) {
            const int64_t len1 = lengths[r1];
            for (int64_t e = k + counts[r1]; k < e; k++) {
                const int64_t r2 = rec.r2(k);
                if (r2 == r1) continue;       // self overlap: the mirror is
                                              // its own stream record
                const int64_t eo = rec.eo(k);
                const int64_t off = rec.off(k);
                const int64_t len2 = lengths[r2];
                const int64_t teo = (eo == 0) ? 3 : (eo == 3) ? 0 : eo;
                const int64_t off2 = len2 + off - len1;
                const int64_t j2 = (teo >= 2) ? off2 : len2 - l - off2;
                ents[cur[r2]++] = pack(j2, r1, teo, off2);
            }
        }
    };
    if (nt >= 2 && total > 1 << 16) {
        std::thread th(fill_direct);
        fill_mirror();
        th.join();
    } else {
        fill_direct();
        fill_mirror();
    }

    // pass 3: restore each read's discovery order (sort mirrors, merge)
    // and split into the construction arrays — both threaded by read range
    std::vector<int32_t> cdest(total);
    std::vector<int8_t> corient(total);
    std::vector<int32_t> coffset(total);
    {
        auto cmp = [](const CanonEnt &a, const CanonEnt &b) {
            return a.key < b.key;
        };
        auto finish_range = [&](int64_t r_lo, int64_t r_hi) {
            for (int64_t r = r_lo; r < r_hi; r++) {
                auto base = ents.begin() + cstart[r];
                auto mid = base + dcount[r];
                auto end = ents.begin() + cstart[r + 1];
                if (mid != end) {
                    std::sort(mid, end, cmp);
                    std::inplace_merge(base, mid, end, cmp);
                }
                for (int64_t k = cstart[r]; k < cstart[r + 1]; k++) {
                    cdest[k] = (int32_t)((ents[k].key >> 2) & 0x7FFFFFFF);
                    corient[k] = (int8_t)(ents[k].key & 3);
                    coffset[k] = ents[k].off;
                }
            }
        };
        if (nt >= 2 && total > 1 << 16) {
            int64_t mid = 1;
            while (mid <= n_reads && cstart[mid] < total / 2) mid++;
            std::thread th(finish_range, 1, mid);
            finish_range(mid, n_reads + 1);
            th.join();
        } else {
            finish_range(1, n_reads + 1);
        }
    }
    ents.clear();
    ents.shrink_to_fit();
    PROF("canon-recon", t0);
    return construct_threaded(n_reads, lengths, dead_end_length, nt,
                              cstart, cdest, corient, coffset);
}


}  // namespace

extern "C" {

void *mg_build(int64_t n_reads, const int64_t *lengths,
               const uint8_t *contained, int64_t n_cand,
               const int64_t *cand_start, const int64_t *cand_dest,
               const int8_t *cand_orient, const int64_t *cand_offset,
               int64_t dead_end_length) {
    (void)contained;   // candidates are pre-filtered; kept for API clarity
    std::vector<int32_t> dest32(n_cand), off32(n_cand);
    for (int64_t i = 0; i < n_cand; i++) {
        dest32[i] = (int32_t)cand_dest[i];
        off32[i] = (int32_t)cand_offset[i];
    }
    return build_core(n_reads, lengths, cand_start, dest32.data(),
                      cand_orient, off32.data(), dead_end_length);
}

// Full assembly-construction engine: l-mer index, probe scan with exact
// 128-bit keys, containment marking, BFS construction, contraction fixpoint.
// Covers the span insertDataset + buildOverlapGraphFromHashTable of the
// reference (HashTable.cpp:50, OverlapGraph.cpp:107).
void *mg_assemble(int64_t n_reads, const int64_t *lengths,
                  const uint8_t *codes_fwd, const uint8_t *codes_rev,
                  int64_t lmax, int64_t hash_len, int64_t mixed,
                  int64_t dead_end_length, int64_t n_threads) {
    const int64_t l = hash_len;
    double t0 = now_s();
    // --- index: 4 exact keys per read in (rid, orient) order -------------
    std::vector<IndexEntry> idx;
    idx.reserve(4 * n_reads);
    for (int64_t i = 1; i <= n_reads; i++) {
        int64_t len = lengths[i];
        const uint8_t *f = codes_fwd + i * lmax;
        const uint8_t *r = codes_rev + i * lmax;
        key_t128 kpf = 0, ksf = 0, kpr = 0, ksr = 0;
        for (int64_t k = 0; k < l; k++) {
            kpf = (kpf << 2) | (f[k] & 3);
            ksf = (ksf << 2) | (f[len - l + k] & 3);
            kpr = (kpr << 2) | (r[k] & 3);
            ksr = (ksr << 2) | (r[len - l + k] & 3);
        }
        idx.push_back({kpf, (int32_t)i, 0});
        idx.push_back({ksf, (int32_t)i, 1});
        idx.push_back({kpr, (int32_t)i, 2});
        idx.push_back({ksr, (int32_t)i, 3});
    }
    {
        // partition by the top key bit (stable), sort halves concurrently —
        // equal keys share the top bit, so per-half stable sorts keep the
        // reference's (rid, orient) tie order
        auto cmp = [](const IndexEntry &a, const IndexEntry &b) {
            return a.key < b.key;
        };
        if (n_threads >= 2 && idx.size() > 1u << 16) {
            // top *stored* key bit: keys truncate to 128 bits for l > 64
            const int kb = (2 * (int)l >= 128) ? 128 : 2 * (int)l;
            const key_t128 top = (key_t128)1 << (kb - 1);
            std::vector<IndexEntry> lo, hi;
            lo.reserve(idx.size());
            hi.reserve(idx.size());
            for (const IndexEntry &e : idx)
                ((e.key & top) ? hi : lo).push_back(e);
            std::thread th([&] {
                std::stable_sort(lo.begin(), lo.end(), cmp);
            });
            std::stable_sort(hi.begin(), hi.end(), cmp);
            th.join();
            std::copy(hi.begin(), hi.end(),
                      std::copy(lo.begin(), lo.end(), idx.begin()));
        } else {
            std::stable_sort(idx.begin(), idx.end(), cmp);
        }
    }
    PROF("index", t0); t0 = now_s();
    // bloom bitmap over mixed hashes (2^24 bits = 2MB, cache-resident)
    std::vector<uint64_t> bloom((1ULL << 24) / 64, 0);
    for (const IndexEntry &e : idx) {
        uint64_t bit = mix_key(e.key) & ((1ULL << 24) - 1);
        bloom[bit >> 6] |= 1ULL << (bit & 63);
    }
    // range table over the top bits of the key: narrows the binary search
    // to a handful of entries
    // shifts are over the *stored* (<=128-bit) key width, not 2*l
    const int key_bits = (2 * (int)l >= 128) ? 128 : 2 * (int)l;
    const int TBITS = (key_bits >= 20) ? 20 : key_bits;
    const int range_shift = key_bits - TBITS;
    std::vector<uint32_t> range_tab((1ULL << TBITS) + 1, 0);
    for (const IndexEntry &e : idx)
        range_tab[(uint64_t)(e.key >> range_shift) + 1]++;
    for (size_t p = 1; p < range_tab.size(); p++)
        range_tab[p] += range_tab[p - 1];

    PROF("bloom", t0); t0 = now_s();
    // --- probe scan (threaded over contiguous read ranges) ----------------
    int nt = (int)n_threads;
    if (nt < 1) nt = 1;
    std::vector<OverlapScratch> scratch(nt);
    if (nt == 1) {
        scan_reads(1, n_reads + 1, lengths, codes_fwd, codes_rev, lmax, l,
                   mixed != 0, idx.data(), idx.size(), bloom.data(),
                   range_tab.data(), range_shift, &scratch[0]);
    } else {
        std::vector<std::thread> threads;
        int64_t per = (n_reads + nt - 1) / nt;
        for (int t = 0; t < nt; t++) {
            int64_t b = 1 + t * per;
            int64_t e = std::min(n_reads + 1, b + per);
            if (b >= e) continue;
            threads.emplace_back(scan_reads, b, e, lengths, codes_fwd,
                                 codes_rev, lmax, l, mixed != 0, idx.data(),
                                 idx.size(), bloom.data(), range_tab.data(),
                                 range_shift, &scratch[t]);
        }
        for (auto &th : threads) th.join();
    }

    PROF("scan", t0); t0 = now_s();
    // --- contained-read replay (OverlapGraph.cpp:225-290) -----------------
    // heartbeat reconstruction: the reference prints the running
    // first-assignment counter every 1e6 probing reads (:273-274); hits
    // arrive in (r1 asc) order across the contiguous thread ranges, so
    // checkpoints are exact.  Stored as (boundary read, counter) pairs in
    // cont_heartbeats on the result graph.
    std::vector<int64_t> supers(n_reads + 1, 0);
    std::vector<std::array<int64_t, 2>> cont_hb;
    if (mixed) {
        int64_t counter = 0;
        int64_t next_b = 1000000;
        for (const auto &sc : scratch) {
            for (const ContHit &hit : sc.cont) {
                while (next_b <= n_reads && hit.r1 > next_b) {
                    cont_hb.push_back({next_b, counter});
                    next_b += 1000000;
                }
                if (supers[hit.r2] == 0) {
                    supers[hit.r2] = hit.r1;
                    counter++;
                } else if (lengths[hit.r1] > lengths[supers[hit.r2]])
                    supers[hit.r2] = hit.r1;
            }
        }
        while (next_b <= n_reads) {
            cont_hb.push_back({next_b, counter});
            next_b += 1000000;
        }
    }

    // --- super filter + per-read candidate ranges --------------------------
    std::vector<int64_t> cstart(n_reads + 2, 0);
    std::vector<int32_t> cdest;
    std::vector<int8_t> corient;
    std::vector<int32_t> coffset;
    size_t total = 0;
    for (const auto &sc : scratch) total += sc.cands.size();
    cdest.reserve(total);
    corient.reserve(total);
    coffset.reserve(total);
    {
        int64_t cur = 1;
        for (auto &sc : scratch) {
            for (const EdgeCand &c : sc.cands) {
                if (supers[c.r1] != 0 || supers[c.r2] != 0) continue;
                while (cur <= c.r1) cstart[cur++] = (int64_t)cdest.size();
                cdest.push_back(c.r2);
                corient.push_back(c.eo);
                coffset.push_back(c.eoff);
            }
            // consumed — release before construction so the raw candidate
            // buffers don't sit under the graph's peak
            std::vector<EdgeCand>().swap(sc.cands);
            std::vector<ContHit>().swap(sc.cont);
        }
        while (cur <= n_reads + 1) cstart[cur++] = (int64_t)cdest.size();
    }

    if (profile_enabled())
        fprintf(stderr, "[mg_native] cands=%zu kept=%zu idx=%zu\n",
                total, cdest.size(), idx.size());
    PROF("filter", t0); t0 = now_s();

    Result *res = construct_threaded(n_reads, lengths, dead_end_length, nt,
                                     cstart, cdest, corient, coffset);
    res->supers = std::move(supers);
    res->g->cont_heartbeats = std::move(cont_hb);
    return res;
}

// Stream replay of the device overlap pipeline's survivor stream
// (ops/device_overlap.py): per-read survivor counts + (r2, meta) pairs in
// reference discovery order.  meta: bits 0-1 edge orientation, bit 2
// edge_ok, bit 3 cont_ok, bits 4-15 overlap offset.  Performs the
// contained-read replay (OverlapGraph.cpp:225-290), the super-read filter
// (:548) and the threaded BFS construction.
void *mg_build_stream(int64_t n_reads, const int64_t *lengths,
                      const int64_t *counts, const int32_t *r2s,
                      const uint16_t *metas, int64_t n_items, int64_t mixed,
                      int64_t dead_end_length, int64_t n_threads) {
    double t0 = now_s();
    int nt = (int)n_threads;
    if (nt < 1) nt = 1;
    std::vector<int64_t> supers(n_reads + 1, 0);
    std::vector<std::array<int64_t, 2>> cont_hb;
    if (mixed) {
        int64_t ofs = 0;
        int64_t counter = 0;
        for (int64_t r1 = 1; r1 <= n_reads; r1++) {
            for (int64_t k = ofs; k < ofs + counts[r1]; k++) {
                if (!(metas[k] & 8)) continue;       // cont_ok bit
                int32_t r2 = r2s[k];
                // device kernel already enforced len[r1] > len[r2]
                if (supers[r2] == 0) {
                    supers[r2] = r1;
                    counter++;
                } else if (lengths[r1] > lengths[supers[r2]])
                    supers[r2] = r1;
            }
            ofs += counts[r1];
            if (r1 % 1000000 == 0) cont_hb.push_back({r1, counter});
        }
        (void)n_items;
    }
    std::vector<int64_t> cstart(n_reads + 2, 0);
    std::vector<int32_t> cdest;
    std::vector<int8_t> corient;
    std::vector<int32_t> coffset;
    cdest.reserve((size_t)n_items);
    corient.reserve((size_t)n_items);
    coffset.reserve((size_t)n_items);
    {
        int64_t ofs = 0;
        for (int64_t r1 = 1; r1 <= n_reads; r1++) {
            cstart[r1] = (int64_t)cdest.size();
            if (supers[r1] == 0) {
                for (int64_t k = ofs; k < ofs + counts[r1]; k++) {
                    if (!(metas[k] & 4)) continue;   // edge_ok bit
                    int32_t r2 = r2s[k];
                    if (supers[r2] != 0) continue;
                    cdest.push_back(r2);
                    corient.push_back((int8_t)(metas[k] & 3));
                    coffset.push_back((int32_t)(metas[k] >> 4));
                }
            }
            ofs += counts[r1];
        }
        cstart[n_reads + 1] = (int64_t)cdest.size();
    }
    PROF("stream-filter", t0);
    Result *res = construct_threaded(n_reads, lengths, dead_end_length, nt,
                                     cstart, cdest, corient, coffset);
    res->supers = std::move(supers);
    res->g->cont_heartbeats = std::move(cont_hb);
    return res;
}

// Canonical-dedup replay of the device survivor stream.  Every physical
// overlap crosses the device->host link ONCE, as the occurrence discovered
// from its smaller endpoint (self overlaps r1 == r2 keep both of their
// occurrences); containment has already been resolved on device, so every
// record is a kept edge.  The mirror occurrence — what the reference's
// probe loop at the LARGER endpoint produced (OverlapGraph.cpp:529-565) —
// is reconstructed arithmetically from the twin-edge algebra
// (OverlapGraph.cpp:407-419: twin orientation 0<->3 / 1,2 fixed,
// twin offset = len2 + offset - len1), and each read's candidate list is
// restored to the reference's discovery order by sorting on
// (probe position j, partner id, hash orientation): the probe loop is j
// ascending (OverlapGraph.cpp:534) and a hash bucket's entries are in
// (read id, orientation) insertion order (HashTable.cpp:88-104).  The
// derivation j = offset (prefix cases eo 2,3) / len - l - offset (suffix
// cases eo 0,1) inverts the offset rules of OverlapGraph.cpp:550-557.
// meta layout matches mg_build_stream: bits 0-1 edge orientation,
// bits 4-15 overlap offset (flag bits 2-3 are ignored here).
void *mg_build_stream_canon(int64_t n_reads, const int64_t *lengths,
                            const int64_t *counts, const int32_t *r2s,
                            const uint16_t *metas, int64_t n_items,
                            int64_t hash_len, int64_t dead_end_length,
                            int64_t n_threads) {
    (void)n_items;
    int nt = (int)n_threads;
    if (nt < 1) nt = 1;
    CanonPairs rec{r2s, metas};
    return canon_core(n_reads, lengths, counts, rec, hash_len,
                      dead_end_length, nt);
}

// Same replay over the device pipeline's packed uint32 words
// [r2 | flags:4 | offset:off_bits] — skips the host-side unpack entirely.
void *mg_build_stream_canon_words(int64_t n_reads, const int64_t *lengths,
                                  const int64_t *counts,
                                  const uint32_t *words, int64_t n_items,
                                  int64_t off_bits, int64_t hash_len,
                                  int64_t dead_end_length,
                                  int64_t n_threads) {
    (void)n_items;
    int nt = (int)n_threads;
    if (nt < 1) nt = 1;
    CanonWords rec{words, (int)off_bits};
    return canon_core(n_reads, lengths, counts, rec, hash_len,
                      dead_end_length, nt);
}

// CPU-side canonical scan for the HYBRID engine: build the full 4-key
// index (all reads — overlaps cross the shard boundary), probe-scan ONLY
// reads [r_lo, r_hi), and emit the canonical (r1 <= r2) verified edge
// candidates as packed uint32 words in the device pipeline's layout
// [r2 | eo|edge_ok<<2 :4 | offset:off_bits].  Because canonical records
// are keyed by their SMALLER endpoint, a CPU scan of [1, a) and a device
// scan of [a, n] partition the overlap set exactly: concatenating the two
// word streams (CPU first) reproduces the full canonical stream for
// mg_build_stream_canon_words.  In mixed mode the scan also returns the
// shard's containment hits in discovery order; the host resolves supers
// GLOBALLY across both shards and masks the edge streams symmetrically
// (graph/build.py _resolve_supers).
struct ScanCanonResult {
    std::vector<int64_t> counts;
    std::vector<uint32_t> words;
    std::vector<int32_t> cont_r1, cont_r2;   // mixed mode: containment
                                             // hits in discovery order
};

void *mg_scan_canon(int64_t n_reads, const int64_t *lengths,
                    const uint8_t *codes_fwd, const uint8_t *codes_rev,
                    int64_t lmax, int64_t hash_len, int64_t r_lo,
                    int64_t r_hi, int64_t off_bits, int64_t mixed,
                    int64_t n_threads) {
    const int64_t l = hash_len;
    // --- index over ALL reads (same construction as mg_assemble) --------
    std::vector<IndexEntry> idx;
    idx.reserve(4 * n_reads);
    for (int64_t i = 1; i <= n_reads; i++) {
        int64_t len = lengths[i];
        const uint8_t *f = codes_fwd + i * lmax;
        const uint8_t *r = codes_rev + i * lmax;
        key_t128 kpf = 0, ksf = 0, kpr = 0, ksr = 0;
        for (int64_t k = 0; k < l; k++) {
            kpf = (kpf << 2) | (f[k] & 3);
            ksf = (ksf << 2) | (f[len - l + k] & 3);
            kpr = (kpr << 2) | (r[k] & 3);
            ksr = (ksr << 2) | (r[len - l + k] & 3);
        }
        idx.push_back({kpf, (int32_t)i, 0});
        idx.push_back({ksf, (int32_t)i, 1});
        idx.push_back({kpr, (int32_t)i, 2});
        idx.push_back({ksr, (int32_t)i, 3});
    }
    int nt = (int)n_threads;
    if (nt < 1) nt = 1;
    {
        // same top-bit bisected parallel stable sort as mg_assemble:
        // equal keys share the top bit, so per-half stable sorts keep the
        // reference's (rid, orient) tie order
        auto cmp = [](const IndexEntry &a, const IndexEntry &b) {
            return a.key < b.key;
        };
        if (nt >= 2 && idx.size() > 1u << 16) {
            const int kb = (2 * (int)l >= 128) ? 128 : 2 * (int)l;
            const key_t128 top = (key_t128)1 << (kb - 1);
            std::vector<IndexEntry> lo, hi;
            lo.reserve(idx.size());
            hi.reserve(idx.size());
            for (const IndexEntry &e : idx)
                ((e.key & top) ? hi : lo).push_back(e);
            std::thread th([&] {
                std::stable_sort(lo.begin(), lo.end(), cmp);
            });
            std::stable_sort(hi.begin(), hi.end(), cmp);
            th.join();
            std::copy(hi.begin(), hi.end(),
                      std::copy(lo.begin(), lo.end(), idx.begin()));
        } else {
            std::stable_sort(idx.begin(), idx.end(), cmp);
        }
    }
    std::vector<uint64_t> bloom((1ULL << 24) / 64, 0);
    for (const IndexEntry &e : idx) {
        uint64_t bit = mix_key(e.key) & ((1ULL << 24) - 1);
        bloom[bit >> 6] |= 1ULL << (bit & 63);
    }
    const int key_bits = (2 * (int)l >= 128) ? 128 : 2 * (int)l;
    const int TBITS = (key_bits >= 20) ? 20 : key_bits;
    const int range_shift = key_bits - TBITS;
    std::vector<uint32_t> range_tab((1ULL << TBITS) + 1, 0);
    for (const IndexEntry &e : idx)
        range_tab[(uint64_t)(e.key >> range_shift) + 1]++;
    for (size_t p = 1; p < range_tab.size(); p++)
        range_tab[p] += range_tab[p - 1];

    // --- scan [r_lo, r_hi) ----------------------------------------------
    std::vector<OverlapScratch> scratch(nt);
    const bool mix = mixed != 0;
    if (nt == 1) {
        scan_reads(r_lo, r_hi, lengths, codes_fwd, codes_rev, lmax, l,
                   mix, idx.data(), idx.size(), bloom.data(),
                   range_tab.data(), range_shift, &scratch[0]);
    } else {
        std::vector<std::thread> threads;
        int64_t per = (r_hi - r_lo + nt - 1) / nt;
        for (int t = 0; t < nt; t++) {
            int64_t b = r_lo + t * per;
            int64_t e = std::min(r_hi, b + per);
            if (b >= e) continue;
            threads.emplace_back(scan_reads, b, e, lengths, codes_fwd,
                                 codes_rev, lmax, l, mix, idx.data(),
                                 idx.size(), bloom.data(), range_tab.data(),
                                 range_shift, &scratch[t]);
        }
        for (auto &th : threads) th.join();
    }

    // --- canonical filter + word packing --------------------------------
    ScanCanonResult *res = new ScanCanonResult;
    res->counts.assign(n_reads + 1, 0);
    size_t total = 0;
    for (const auto &sc : scratch)
        for (const EdgeCand &c : sc.cands)
            if (c.r1 <= c.r2) total++;
    res->words.reserve(total);
    const uint32_t ob = (uint32_t)off_bits;
    // edge records are canonical but NOT filtered by containment here:
    // in mixed mode supers are resolved globally across shards on the
    // host, which then masks both shards' edge streams symmetrically
    for (const auto &sc : scratch)
        for (const EdgeCand &c : sc.cands) {
            if (c.r1 > c.r2) continue;
            res->counts[c.r1]++;
            res->words.push_back(((uint32_t)c.r2 << (4 + ob))
                                 | (((uint32_t)c.eo | 4u) << ob)
                                 | (uint32_t)c.eoff);
        }
    if (mix) {
        size_t nc = 0;
        for (const auto &sc : scratch) nc += sc.cont.size();
        res->cont_r1.reserve(nc);
        res->cont_r2.reserve(nc);
        for (const auto &sc : scratch)
            for (const ContHit &h : sc.cont) {
                res->cont_r1.push_back(h.r1);
                res->cont_r2.push_back(h.r2);
            }
    }
    return res;
}

int64_t mg_scan_canon_len(void *h) {
    return (int64_t)((ScanCanonResult *)h)->words.size();
}

int64_t mg_scan_canon_cont_len(void *h) {
    return (int64_t)((ScanCanonResult *)h)->cont_r1.size();
}

void mg_scan_canon_fetch(void *h, int64_t *counts, uint32_t *words) {
    ScanCanonResult *r = (ScanCanonResult *)h;
    memcpy(counts, r->counts.data(), r->counts.size() * sizeof(int64_t));
    memcpy(words, r->words.data(), r->words.size() * sizeof(uint32_t));
}

void mg_scan_canon_cont(void *h, int32_t *r1, int32_t *r2) {
    ScanCanonResult *r = (ScanCanonResult *)h;
    memcpy(r1, r->cont_r1.data(), r->cont_r1.size() * sizeof(int32_t));
    memcpy(r2, r->cont_r2.data(), r->cont_r2.size() * sizeof(int32_t));
}

void mg_scan_canon_free(void *h) { delete (ScanCanonResult *)h; }

void mg_supers(void *h, int64_t *out) {
    Result *r = (Result *)h;
    if (!r->supers.empty())
        memcpy(out, r->supers.data(), r->supers.size() * sizeof(int64_t));
}

int64_t mg_num_edges(void *h) { return (int64_t)((Result *)h)->order.size(); }
int64_t mg_num_nodes(void *h) { return ((Result *)h)->g->n_nodes; }
int64_t mg_graph_num_edges(void *h) { return ((Result *)h)->g->n_edges; }
int64_t mg_manifest_len(void *h) { return ((Result *)h)->total_manifest; }
int64_t mg_serial_counter(void *h) { return ((Result *)h)->g->serial; }
int64_t mg_bfs_nodes(void *h) { return ((Result *)h)->g->bfs_nodes; }
int64_t mg_bfs_edges(void *h) { return ((Result *)h)->g->bfs_edges; }
int64_t mg_cont_heartbeats_len(void *h) {
    return (int64_t)((Result *)h)->g->cont_heartbeats.size();
}
void mg_cont_heartbeats(void *h, int64_t *boundary, int64_t *count) {
    Graph *g = ((Result *)h)->g;
    for (size_t k = 0; k < g->cont_heartbeats.size(); k++) {
        boundary[k] = g->cont_heartbeats[k][0];
        count[k] = g->cont_heartbeats[k][1];
    }
}
int64_t mg_bfs_heartbeats_len(void *h) {
    return (int64_t)((Result *)h)->g->bfs_heartbeats.size();
}
void mg_bfs_heartbeats(void *h, int64_t *counter, int64_t *nodes,
                       int64_t *edges) {
    Graph *g = ((Result *)h)->g;
    for (size_t k = 0; k < g->bfs_heartbeats.size(); k++) {
        counter[k] = g->bfs_heartbeats[k][0];
        nodes[k] = g->bfs_heartbeats[k][1];
        edges[k] = g->bfs_heartbeats[k][2];
    }
}
int64_t mg_iter_log_len(void *h) {
    return (int64_t)((Result *)h)->g->it_merged.size();
}
void mg_iter_log(void *h, int64_t *merged, int64_t *dead_nodes,
                 int64_t *dead_edges) {
    Graph *g = ((Result *)h)->g;
    for (size_t k = 0; k < g->it_merged.size(); k++) {
        merged[k] = g->it_merged[k];
        dead_nodes[k] = g->it_dead_nodes[k];
        dead_edges[k] = g->it_dead_edges[k];
    }
}

void mg_edges(void *h, int64_t *src, int64_t *dst, int64_t *orient,
              int64_t *offset, int64_t *serial, int64_t *twin_pos,
              int64_t *man_start, int64_t *man_len) {
    Result *r = (Result *)h;
    // map pointer -> position
    std::vector<std::pair<Edge *, int64_t>> pos;
    pos.reserve(r->order.size());
    for (size_t i = 0; i < r->order.size(); i++)
        pos.push_back({r->order[i], (int64_t)i});
    std::sort(pos.begin(), pos.end());
    auto find_pos = [&](Edge *e) {
        auto it = std::lower_bound(
            pos.begin(), pos.end(), std::make_pair(e, (int64_t)-1));
        return it->second;
    };
    for (size_t i = 0; i < r->order.size(); i++) {
        Edge *e = r->order[i];
        src[i] = e->source;
        dst[i] = e->destination;
        orient[i] = e->orient;
        offset[i] = e->offset;
        serial[i] = e->serial;
        twin_pos[i] = find_pos(e->twin);
        man_start[i] = r->man_start[i];
        man_len[i] = (int64_t)e->man.size();
    }
}

void mg_manifest(void *h, int64_t *reads, int64_t *offsets, uint8_t *orients) {
    Result *r = (Result *)h;
    int64_t p = 0;
    for (Edge *e : r->order) {
        for (size_t i = 0; i < e->man.size(); i++, p++) {
            reads[p] = e->man[i].rid;
            offsets[p] = e->man[i].off;
            orients[p] = e->man[i].orient;
        }
    }
}

// final read-location lists (order matters downstream): flattened per read,
// forward then reverse, as (edge_pos, distance) pairs.
int64_t mg_loc_total(void *h) {
    Result *r = (Result *)h;
    int64_t t = 0;
    for (int64_t i = 0; i <= r->g->n_reads; i++)
        t += (int64_t)(r->g->locf_e[i].size() + r->g->locr_e[i].size());
    return t;
}

void mg_locations(void *h, int64_t *counts_f, int64_t *counts_r,
                  int64_t *edge_pos, int64_t *dist) {
    Result *r = (Result *)h;
    std::vector<std::pair<Edge *, int64_t>> pos;
    pos.reserve(r->order.size());
    for (size_t i = 0; i < r->order.size(); i++)
        pos.push_back({r->order[i], (int64_t)i});
    std::sort(pos.begin(), pos.end());
    auto find_pos = [&](Edge *e) {
        auto it = std::lower_bound(
            pos.begin(), pos.end(), std::make_pair(e, (int64_t)-1));
        return it->second;
    };
    int64_t p = 0;
    for (int64_t i = 0; i <= r->g->n_reads; i++) {
        counts_f[i] = (int64_t)r->g->locf_e[i].size();
        counts_r[i] = (int64_t)r->g->locr_e[i].size();
        for (size_t k = 0; k < r->g->locf_e[i].size(); k++, p++) {
            edge_pos[p] = find_pos(r->g->locf_e[i][k]);
            dist[p] = r->g->locf_d[i][k];
        }
        for (size_t k = 0; k < r->g->locr_e[i].size(); k++, p++) {
            edge_pos[p] = find_pos(r->g->locr_e[i][k]);
            dist[p] = r->g->locr_d[i][k];
        }
    }
}

// Reference hash-table statistics simulation (HashTable.cpp:50-80,
// 135-195): linear-probing insertion of the 4 l-mer keys per read in
// (read asc, orient 0..3) order over a table of `table_size` buckets,
// counting probe collisions and tracking the longest bucket.  Produces the
// insertDataset log counters without building the actual string table.
// out[0]=collisions, out[1]=longest bucket size, out[2]=its first read id,
// out[3]=its first orientation.  checkpoints[i] = collision count after
// (i+1)*1e6 reads (log heartbeats); pass n_checkpoints = n_reads/1e6.
void mg_hashstats(int64_t n_reads, const int64_t *lengths,
                  const uint8_t *codes_fwd, const uint8_t *codes_rev,
                  int64_t lmax, int64_t hash_len, int64_t table_size,
                  int64_t *out, int64_t *checkpoints,
                  int64_t n_checkpoints) {
    const int64_t l = hash_len;
    const uint64_t p = (uint64_t)table_size;
    // per bucket: first entry (read, orient) and size; 0 size = empty
    std::vector<int32_t> rep_rid(p, 0);
    std::vector<int8_t> rep_orient(p, 0);
    std::vector<int32_t> bsize(p, 0);
    // rank code -> reference hash bit code ((ascii>>1)&3): A0 C1 G3 T2
    static const uint64_t BC[4] = {0, 1, 3, 2};
    int64_t collisions = 0;
    auto key_ptr = [&](int64_t rid, int orient) -> const uint8_t * {
        const uint8_t *row = (orient <= 1 ? codes_fwd : codes_rev)
                             + rid * lmax;
        return (orient % 2 == 0) ? row : row + (lengths[rid] - l);
    };
    for (int64_t i = 1; i <= n_reads; i++) {
        for (int orient = 0; orient < 4; orient++) {
            const uint8_t *s = key_ptr(i, orient);
            uint64_t sum1 = 1, sum2 = 1;
            int64_t lim = l < 32 ? l : 32;
            for (int64_t k = 0; k < lim; k++)
                sum1 = (sum1 << 2) | BC[s[k] & 3];
            for (int64_t k = 32; k < l; k++)
                sum2 = (sum2 << 2) | BC[s[k] & 3];
            uint64_t idx = ((sum1 % p) * (sum2 % p)) % p;
            while (bsize[idx] != 0) {
                const uint8_t *t = key_ptr(rep_rid[idx], rep_orient[idx]);
                if (memcmp(s, t, (size_t)l) == 0) break;
                collisions++;
                idx = (idx == p - 1) ? 0 : idx + 1;
            }
            if (bsize[idx] == 0) {
                rep_rid[idx] = (int32_t)i;
                rep_orient[idx] = (int8_t)orient;
            }
            bsize[idx]++;
        }
        if (i % 1000000 == 0 && i / 1000000 <= n_checkpoints)
            checkpoints[i / 1000000 - 1] = collisions;
    }
    int32_t longest = 0;
    int64_t lr = 0, lo = 0;
    for (uint64_t b = 0; b < p; b++) {
        if (bsize[b] > longest) {
            longest = bsize[b];
            lr = rep_rid[b];
            lo = rep_orient[b];
        }
    }
    out[0] = collisions;
    out[1] = longest;
    out[2] = lr;
    out[3] = lo;
}

void mg_free(void *h) {
    Result *r = (Result *)h;
    delete r->g;   // edge pools owned by the graphs
    for (Graph *g : r->extra) delete g;
    delete r;
}

// Exact min-cost flow with lower bounds: the native twin of
// mincostflow.solve_min_cost_flow (successive shortest augmenting paths
// with Johnson potentials over reduced costs).  Tie-breaking matches the
// Python solver exactly — heap entries ordered by (distance, node id),
// strict relaxations, deficit node chosen by (distance, lowest id) — so
// both produce the SAME optimal flow vector among alternate optima.
// Clean-room replacement for the reference's bundled CS2
// (MetaGenomics/CS2/cs2.h, license-restricted).  Returns 0 (optimal) or
// -1 (infeasible); flows are written per input arc.
int64_t mg_mincostflow(int64_t n, int64_t m, const int64_t *tail,
                       const int64_t *head_in, const int64_t *lb,
                       const int64_t *ub, const int64_t *cost_in,
                       int64_t *flow_out) {
    const int64_t INF = INT64_MAX / 4;
    std::vector<int32_t> head(2 * m);
    std::vector<int64_t> cap(2 * m), cost(2 * m);
    std::vector<std::vector<int32_t>> out(n + 1);
    std::vector<int64_t> b(n + 1, 0);
    for (int64_t k = 0; k < m; k++) {
        head[2 * k] = (int32_t)head_in[k];
        cap[2 * k] = ub[k] - lb[k];
        cost[2 * k] = cost_in[k];
        head[2 * k + 1] = (int32_t)tail[k];
        cap[2 * k + 1] = 0;
        cost[2 * k + 1] = -cost_in[k];
        out[tail[k]].push_back((int32_t)(2 * k));
        out[head_in[k]].push_back((int32_t)(2 * k + 1));
        b[tail[k]] -= lb[k];
        b[head_in[k]] += lb[k];
    }
    std::vector<int64_t> pot(n + 1, 0), dist(n + 1);
    std::vector<int32_t> prev_arc(n + 1);
    std::vector<uint8_t> visited(n + 1);
    typedef std::pair<int64_t, int32_t> QE;
    for (;;) {
        int64_t s = 0;
        for (int64_t u = 1; u <= n; u++)
            if (b[u] > 0) { s = u; break; }
        if (s == 0) break;
        std::fill(dist.begin(), dist.end(), INF);
        std::fill(prev_arc.begin(), prev_arc.end(), -1);
        std::fill(visited.begin(), visited.end(), 0);
        dist[s] = 0;
        std::priority_queue<QE, std::vector<QE>, std::greater<QE>> pq;
        pq.push({0, (int32_t)s});
        while (!pq.empty()) {
            QE top = pq.top(); pq.pop();
            int32_t u = top.second;
            if (visited[u]) continue;
            visited[u] = 1;
            for (int32_t a : out[u])
                if (cap[a] > 0) {
                    int32_t v = head[a];
                    int64_t nd = top.first + cost[a] + pot[u] - pot[v];
                    if (nd < dist[v]) {
                        dist[v] = nd;
                        prev_arc[v] = a;
                        pq.push({nd, v});
                    }
                }
        }
        int64_t t = 0, best = INF;
        for (int64_t u = 1; u <= n; u++)
            if (b[u] < 0 && dist[u] < best) { best = dist[u]; t = u; }
        if (t == 0) return -1;
        for (int64_t u = 1; u <= n; u++)
            pot[u] += (dist[u] < INF) ? dist[u] : best;
        int64_t delta = b[s];
        if (-b[t] < delta) delta = -b[t];
        for (int64_t u = t; u != s; u = head[prev_arc[u] ^ 1])
            if (cap[prev_arc[u]] < delta) delta = cap[prev_arc[u]];
        for (int64_t u = t; u != s; u = head[prev_arc[u] ^ 1]) {
            cap[prev_arc[u]] -= delta;
            cap[prev_arc[u] ^ 1] += delta;
        }
        b[s] -= delta;
        b[t] += delta;
    }
    for (int64_t k = 0; k < m; k++)
        flow_out[k] = lb[k] + cap[2 * k + 1];
    return 0;
}

}  // extern "C"
