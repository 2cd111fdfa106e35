// Expand, verify, keep and compact one chunk of the overlap pipeline's
// candidate slots, written by hand for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the JAX package's _emit2
// (metagenomics_tpu/ops/device_overlap.py:445) is a chain of XLA ops, and
// the port's plain version (ops/device_overlap.py _emit2_torch) is the
// same chain in torch.  This kernel gives, bit for bit, what the plain
// version gives in the slots a caller reads: the first n_keep survivors
// (int64-held 32-bit words, or the (r2 int32, meta int32) pair when
// off_bits < 0) in slot order, the per-read survivor counts and n_keep.
// The buffer past n_keep is left unspecified (every caller slices or
// masks it: _fetch_words, stream's pair path, _cont_canon's k < n_keep).
//
// A chunk of nh hit queries owns sum(counts) slots: slot k belongs to the
// first bucket b with cum[b] > k (cum the inclusive sum of the counts) and
// names index entry rleft[b] + k - (cum[b] - counts[b]).  For each slot
// k < total the kernel takes r1 (the query's read), j (its window start),
// r2 and the orientation from the entry, runs the length tests of the
// edge test (checkOverlap, OverlapGraph.cpp:354-383) and, where asked,
// of the containment test (checkOverlapForContainedRead, :302-340), then
// compares the packed 2-bit words of the two rows straight from packed2,
// and builds the survivor [r2 | fe:4 | eoff:off_bits] or (r2, meta).
//
// What bounds it: bytes.  Its least traffic is the hits' (id, start,
// count), the 4n entry words, both strands' packed words, the lengths,
// the survivors and the counts at 4 bytes a value (bench.py stage_bytes:
// 12 h + 4 (4n + 2 n1 w + n1) + 4 survivors + 4 n1), 18-29 MB at the
// benchmark's cells: 5-9 us at 3.35 TB/s.  The torch chain it replaces
// spent milliseconds in about a hundred int64 passes over cap slots, two
// [cap, wp] int64 row gathers and a stable sort of a 0/1 key.  This
// design:
//
//  - one pass, no intermediate: a block takes a tile of 1024 consecutive
//    slots (a ticket from an atomic counter gives the tile, so a tile's
//    predecessors were all started before it), expands, verifies and
//    places them, and nothing of a slot's state leaves registers but its
//    survivor;
//  - load-balanced expansion: one warp finds the tile's first owner by a
//    32-way search over cum (32 probes a step, five steps for a million
//    hits); every later bucket that starts inside the tile marks its
//    first slot in shared memory, and a block max-scan of the marks gives
//    every slot its owner (no search per slot).  A thread expands all
//    four of its slots (owner, entry, r1, r2) before it verifies any, so
//    their dependent loads are in flight together;
//  - no work for a slot whose result is dropped: slots k >= total end at
//    once, the length tests come before any row is read, and in the
//    deduplicating modes a slot with r1 > r2 reads rows only for the
//    containment test (and then the edge test, whose bit a containment
//    survivor carries);
//  - r1's rows staged: slots are in query order, so a tile's slots share
//    a few r1 rows; those are copied once into shared memory (the low 32
//    bits of each int64-held word), and only r2's row is read from device
//    memory (mostly L2: packed2 is 31-43 MB at the cells);
//  - windows compared a word at a time with funnel shifts, up to the
//    compared length only, stopping at the first mismatching word;
//  - stable compaction by a single-pass prefix sum with decoupled
//    look-back: warp ballots rank a tile's survivors in slot order, the
//    tile publishes its count, adds its predecessors' (one warp reads 32
//    predecessors' published counts at a time, back to the nearest that
//    has published its prefix) and writes its survivors from there; the
//    last tile writes n_keep;
//  - per-read counts by int32 atomics, one per run of equal r1 within a
//    warp (__match_any_sync): exact in any order.
//
// Tuned on an H100 (variants timed in turns, the card alone; PERF.md):
// the warp-wide look-back, with the four slots expanded before any is
// verified and the 32-way search, took 5-9% off a one-thread look-back;
// eight-word compare chunks (80 registers), and 6 or 8 blocks an SM
// forced by launch bounds (40 and 32 registers, with spills), were
// slower.
//
// The mode comes from the call: containment test or not, deduplicating
// (keep r1 <= r2 edges) or not, the one-word or the two-array survivor,
// one read length or the lengths array.  The four are template
// parameters; emit_verify_launch dispatches on their bits.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 4;
constexpr int kTile = kThreads * kItems;  // slots a block
constexpr int kWarps = kThreads / 32;
constexpr int kMaxStageRows = 16;          // r1 rows staged a tile
constexpr int kStageBytes = 24576;         // shared memory for them, at most
constexpr int kChunk = 4;                  // words loaded ahead a compare
constexpr unsigned kFull = 0xffffffffu;

// mode bits (ops/emit_verify.py kernel_mode)
constexpr int kModeCont = 1;
constexpr int kModeDedup = 2;
constexpr int kModeWords = 4;
constexpr int kModeUniform = 8;

struct Args {
  const uint32_t* packed2;  // int64 [2 nrows, wp] viewed as uint32 pairs
  const int32_t* lengths;   // [n1]
  const int64_t* rk;        // the chunk's hits: rk_pad + h0
  const int32_t* rleft;     // rleft_pad + h0
  const int32_t* cum;       // inclusive sum of the chunk's nh counts
  const int64_t* sid;       // [m] index entries (rid << 2 | orient)
  int64_t* words;           // [cap] survivors (one-word mode)
  int32_t* r2_out;          // [cap] (pair mode)
  int32_t* meta_out;        // [cap] (pair mode)
  int32_t* keep_counts;     // [n1], zeroed
  int32_t* n_keep;          // one int32
  unsigned long long* status;  // [ntiles], zeroed: flag << 32 | count
  unsigned int* ticket;     // zeroed
  int64_t m;
  int32_t cap, nh, n1, nrows, wp, w, qw_max;
  int32_t row0, hash_len, npos, lmax, off_bits, uniform_len, stage_rows;
};

__device__ __forceinline__ unsigned long long load_relaxed(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];"
               : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_relaxed(unsigned long long* p,
                                              unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;"
               :: "l"(p), "l"(v) : "memory");
}

// First b in [0, nh) with cum[b] > k (nh when none).
__device__ __forceinline__ int upper_bound(const int32_t* cum, int nh,
                                           int k) {
  int lo = 0;
  int hi = nh;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (cum[mid] > k) {
      hi = mid;
    } else {
      lo = mid + 1;
    }
  }
  return lo;
}

// Word offset of a window starting at base s: the reference's select chain
// falls back to word 0 outside 1..qw_max (ops/device_overlap.py
// _extract_words).
__device__ __forceinline__ int word_offset(int s, int qw_max) {
  const int q = s >> 4;
  return (q >= 1 && q <= qw_max) ? q : 0;
}

// The m bases from base s1 of row a (its words sa uint32 apart) equal the
// m bases from base s2 of row b (sb apart).  Compares ceil(m / 16) words
// (at most w), each the funnel shift of two neighbours, masked to the
// bases it holds; stops at the first chunk that mismatches.  Loads
// kChunk words of each row ahead of the compare.
__device__ __forceinline__ bool windows_equal(const uint32_t* a, int sa,
                                              int s1, const uint32_t* b,
                                              int sb, int s2, int m, int w,
                                              int qw_max) {
  int nw = (m + 15) >> 4;
  nw = nw < w ? nw : w;
  const uint32_t* pa = a + word_offset(s1, qw_max) * sa;
  const uint32_t* pb = b + word_offset(s2, qw_max) * sb;
  const unsigned sh1 = static_cast<unsigned>(s1 & 15) << 1;
  const unsigned sh2 = static_cast<unsigned>(s2 & 15) << 1;
  uint32_t alo = pa[0];
  uint32_t blo = pb[0];
  for (int i = 0; i < nw; i += kChunk) {
    uint32_t ahi[kChunk];
    uint32_t bhi[kChunk];
#pragma unroll
    for (int u = 0; u < kChunk; ++u) {
      if (i + u < nw) {
        ahi[u] = pa[(i + u + 1) * sa];
        bhi[u] = __ldg(pb + (i + u + 1) * sb);
      }
    }
    uint32_t diff = 0;
#pragma unroll
    for (int u = 0; u < kChunk; ++u) {
      if (i + u < nw) {
        const uint32_t x = __funnelshift_r(alo, ahi[u], sh1) ^
                           __funnelshift_r(blo, bhi[u], sh2);
        const int nb = m - 16 * (i + u);
        diff |= nb >= 16 ? x : x & ((1u << (2 * nb)) - 1u);
        alo = ahi[u];
        blo = bhi[u];
      }
    }
    if (diff != 0) {
      return false;
    }
  }
  return true;
}

// One warp's search: the first b in [0, nh) with cum[b] > k (nh when
// none), 32 probes a step, the same answer in every lane.
__device__ __forceinline__ int warp_upper_bound(const int32_t* cum, int nh,
                                                int k, int lane) {
  int lo = 0;
  int hi = nh;
  while (lo < hi) {
    const int step = (hi - lo + 31) >> 5;
    const int probes = (hi - lo + step - 1) / step;
    const unsigned above = __ballot_sync(
        kFull, lane < probes && cum[lo + lane * step] > k);
    const int f = above ? __ffs(above) - 1 : probes;
    if (f == 0) {
      hi = lo;
    } else {
      hi = f < probes ? lo + f * step : hi;
      lo += (f - 1) * step + 1;
    }
  }
  return lo;
}

template <bool kCont, bool kDedup, bool kWords, bool kUniform>
__global__ void __launch_bounds__(kThreads)
    emit_verify_kernel(const Args a) {
  extern __shared__ uint32_t rows_s[];  // stage_rows x wp words
  __shared__ __align__(16) int32_t own[kTile];
  __shared__ int32_t warp_max[kWarps];
  __shared__ int32_t prefix[kItems * kWarps];
  __shared__ int32_t s_tile, s_o0, s_overflow, s_r1_first, s_nstage, s_excl;

  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  if (t == 0) {
    s_tile = static_cast<int>(atomicAdd(a.ticket, 1u));
  }
  __syncthreads();
  const int tile = s_tile;
  const int nh_total = a.nh > 0 ? a.cum[a.nh - 1] : 0;
  const int total = nh_total < a.cap ? nh_total : a.cap;
  const int k0 = tile * kTile;
  if (tile > 0 && k0 >= total) {
    return;  // no slot here, and no later tile waits on this one
  }
  const int tile_end = total < k0 + kTile ? total : k0 + kTile;
  const bool any = tile_end > k0;  // false only in tile 0 of no slots

  // -------------------------------------------------- owners of the slots
  if (warp == 0) {
    const int o0 = warp_upper_bound(a.cum, a.nh, k0, lane);
    if (lane == 0) {
      s_o0 = o0;
      // buckets of zero slots could push the tile's last owner past the
      // kTile buckets marked below; then every slot searches on its own
      s_overflow = o0 + kTile < a.nh && a.cum[o0 + kTile - 1] < tile_end;
    }
  }
  for (int x = t; x < kTile; x += kThreads) {
    own[x] = 0;
  }
  __syncthreads();
  const int o0 = s_o0;
  const bool overflow = s_overflow;
  for (int x = 1 + t; x < kTile; x += kThreads) {
    const int b = o0 + x;
    if (b < a.nh) {
      const int st = a.cum[b - 1];
      if (st < tile_end && a.cum[b] > st) {
        own[st - k0] = x;
      }
    }
  }
  __syncthreads();
  {
    // block max-scan of the marks, four a thread
    int4 v = reinterpret_cast<int4*>(own)[t];
    v.y = max(v.y, v.x);
    v.z = max(v.z, v.y);
    v.w = max(v.w, v.z);
    int run = v.w;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(kFull, run, d);
      if (lane >= d) {
        run = max(run, y);
      }
    }
    if (lane == 31) {
      warp_max[warp] = run;
    }
    int before = __shfl_up_sync(kFull, run, 1);
    if (lane == 0) {
      before = 0;
    }
    __syncthreads();
    for (int q = 0; q < warp; ++q) {
      before = max(before, warp_max[q]);
    }
    v.x = max(v.x, before);
    v.y = max(v.y, before);
    v.z = max(v.z, before);
    v.w = max(v.w, before);
    reinterpret_cast<int4*>(own)[t] = v;
  }
  __syncthreads();

  // ---------------------------------------------- r1's rows, staged once
  const uint32_t* const p32 = a.packed2;
  const int qmask = 0x3FFFFFFF;
  if (warp == 0 && any) {
    const int last = overflow
                         ? warp_upper_bound(a.cum, a.nh, tile_end - 1, lane)
                         : o0 + own[tile_end - 1 - k0];
    if (lane == 0) {
      const int r1a = static_cast<int>(a.rk[o0] & qmask) / a.npos;
      const int r1b = static_cast<int>(a.rk[last] & qmask) / a.npos;
      s_r1_first = a.row0 + r1a;
      const int span = r1b - r1a + 1;
      s_nstage = span < a.stage_rows ? span : a.stage_rows;
    }
  }
  __syncthreads();
  const int r1_first = any ? s_r1_first : 0;
  const int nstage = any ? s_nstage : 0;
  {
    const int64_t base = static_cast<int64_t>(r1_first) * a.wp;
    for (int x = t; x < nstage * a.wp; x += kThreads) {
      rows_s[x] = p32[2 * (base + x)];
    }
  }
  __syncthreads();

  // ---------------- expand every slot first, so their loads fly together
  int r1[kItems];
  int r2[kItems];
  int orient[kItems];
  int j[kItems];
  bool live[kItems];
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const int k = k0 + i * kThreads + t;
    live[i] = k < tile_end;
    int b = overflow ? upper_bound(a.cum, a.nh, k) : o0 + own[k - k0];
    b = b < a.nh ? b : a.nh - 1;  // a spare slot reads a real bucket
    b = b > 0 ? b : 0;
    const int start = b > 0 ? a.cum[b - 1] : 0;
    int64_t src = static_cast<int64_t>(k) - start + a.rleft[b];
    src = src < 0 ? 0 : (src >= a.m ? a.m - 1 : src);
    const int qid = static_cast<int>(a.rk[b] & qmask);
    const int64_t e = a.sid[src];
    r2[i] = static_cast<int>(e >> 2);
    orient[i] = static_cast<int>(e & 3);
    const int qloc = qid / a.npos;
    j[i] = qid - qloc * a.npos;
    const int r = a.row0 + qloc;
    r1[i] = r < 0 ? 0 : (r >= a.n1 ? a.n1 - 1 : r);
  }

  // ------------------------------------------------- verify and keep
  const int l = a.hash_len;
  bool keep[kItems];
  uint32_t word[kItems];
  int32_t meta[kItems];
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    keep[i] = false;
    word[i] = 0;
    meta[i] = 0;
    if (!any || !live[i]) {
      continue;
    }
    const int len1 = kUniform ? a.uniform_len : a.lengths[r1[i]];
    const int len2 = kUniform ? a.uniform_len : a.lengths[r2[i]];
    const int o = orient[i];
    const int jj = j[i];
    const bool is_pre = (o & 1) == 0;
    const bool is_rev = o > 1;
    const int rev_shift = is_rev ? a.lmax - len2 : 0;
    const uint32_t* row2 =
        p32 + 2 * static_cast<int64_t>(r2[i] + (is_rev ? a.nrows : 0)) * a.wp;
    const uint32_t* row1;
    int stride1;
    if (r1[i] >= r1_first && r1[i] - r1_first < nstage) {
      row1 = rows_s + (r1[i] - r1_first) * a.wp;
      stride1 = 1;
    } else {
      row1 = p32 + 2 * static_cast<int64_t>(r1[i]) * a.wp;
      stride1 = 2;
    }

    bool cont = false;
    if (kCont) {
      const int m2 = len2 - l;
      const bool ok_c = (is_pre ? len1 - jj - l >= m2 : jj >= m2) &&
                        len1 > len2 && len2 > l;
      if (ok_c) {
        int s1 = is_pre ? jj : jj - m2;
        s1 = s1 < 0 ? 0 : s1;
        cont = windows_equal(row1, stride1, s1, row2, 2, rev_shift, len2,
                             a.w, a.qw_max);
      }
    }
    bool edge = false;
    const bool ok_e = is_pre ? len1 - jj < len2 : len2 - l >= jj;
    if (ok_e && (!kDedup || r1[i] <= r2[i] || cont)) {
      int s2 = is_pre ? 0 : len2 - l - jj;
      s2 = s2 < 0 ? 0 : s2;
      edge = windows_equal(row1, stride1, is_pre ? jj : 0, row2, 2,
                           s2 + rev_shift, is_pre ? len1 - jj : jj + l, a.w,
                           a.qw_max);
    }
    keep[i] = kDedup ? ((edge && r1[i] <= r2[i]) || cont) : (edge || cont);

    const int eo = o == 0 ? 3 : (o == 1 ? 0 : (o == 2 ? 2 : 1));
    const int64_t fe = eo | (edge ? 4 : 0) | (cont ? 8 : 0);
    const int64_t eoff = is_pre ? jj : len1 - l - jj;
    if (kWords) {
      const int ob = a.off_bits;
      const int64_t top = (int64_t{1} << ob) - 1;
      const int64_t off = eoff < 0 ? 0 : (eoff > top ? top : eoff);
      word[i] = static_cast<uint32_t>(
          (static_cast<uint64_t>(r2[i]) << (4 + ob)) |
          static_cast<uint64_t>(fe << ob) | static_cast<uint64_t>(off));
    } else {
      meta[i] = static_cast<int32_t>((fe | (eoff << 4)) & 0xFFFF);
    }
  }

  // ------------------ rank in slot order; count per read, one atomic a run
  const unsigned lt_mask = (1u << lane) - 1u;
  int rank[kItems];
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const unsigned ballot = __ballot_sync(kFull, keep[i]);
    rank[i] = __popc(ballot & lt_mask);
    if (lane == 0) {
      prefix[i * kWarps + warp] = __popc(ballot);
    }
    if (keep[i]) {
      const unsigned same = __match_any_sync(ballot, r1[i]);
      if (lane == __ffs(same) - 1) {
        atomicAdd(a.keep_counts + r1[i], __popc(same));
      }
    }
  }
  __syncthreads();

  // ------------------- the tile's count, its predecessors', and n_keep
  if (warp == 0) {
    // exclusive scan of the 32 (item, warp) counts, in slot order
    const int c = prefix[lane];
    int inc = c;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(kFull, inc, d);
      if (lane >= d) {
        inc += y;
      }
    }
    prefix[lane] = inc - c;
    const int agg = __shfl_sync(kFull, inc, 31);
    unsigned long long* st = a.status;
    int excl = 0;
    if (tile == 0) {
      if (lane == 0) {
        store_relaxed(st, (2ull << 32) | static_cast<unsigned>(agg));
      }
    } else {
      if (lane == 0) {
        store_relaxed(st + tile, (1ull << 32) | static_cast<unsigned>(agg));
      }
      // look back 32 tiles at a time, lane i at tile p - i: add every
      // count up to the nearest tile that has published its prefix
      for (int p = tile - 1;; p -= 32) {
        unsigned long long v = 2ull << 32;  // before tile 0: prefix 0
        if (p - lane >= 0) {
          do {
            v = load_relaxed(st + p - lane);
          } while ((v >> 32) == 0);
        }
        const unsigned done = __ballot_sync(kFull, (v >> 32) == 2);
        const int upto = done ? __ffs(done) - 1 : 31;
        int part = lane <= upto ? static_cast<int>(v & 0xffffffffull) : 0;
#pragma unroll
        for (int d = 16; d > 0; d >>= 1) {
          part += __shfl_xor_sync(kFull, part, d);
        }
        excl += part;
        if (done) {
          break;
        }
      }
      if (lane == 0) {
        store_relaxed(st + tile,
                      (2ull << 32) | static_cast<unsigned>(excl + agg));
      }
    }
    if (lane == 0) {
      s_excl = excl;
      if (k0 + kTile >= total) {
        *a.n_keep = excl + agg;
      }
    }
  }
  __syncthreads();

  // ------------------------------------------ survivors, in slot order
  const int excl = s_excl;
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    if (keep[i]) {
      const int pos = excl + prefix[i * kWarps + warp] + rank[i];
      if (kWords) {
        a.words[pos] = static_cast<int64_t>(word[i]);
      } else {
        a.r2_out[pos] = r2[i];
        a.meta_out[pos] = meta[i];
      }
    }
  }
}

template <bool kCont, bool kDedup, bool kWords, bool kUniform>
int launch(const Args& a, int ntiles, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(a.stage_rows) * a.wp * 4;
  emit_verify_kernel<kCont, kDedup, kWords, kUniform>
      <<<static_cast<unsigned>(ntiles), kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <bool kCont, bool kDedup, bool kWords>
int launch_len(const Args& a, int mode, int ntiles, cudaStream_t s) {
  return (mode & kModeUniform)
             ? launch<kCont, kDedup, kWords, true>(a, ntiles, s)
             : launch<kCont, kDedup, kWords, false>(a, ntiles, s);
}

template <bool kCont, bool kDedup>
int launch_words(const Args& a, int mode, int ntiles, cudaStream_t s) {
  return (mode & kModeWords)
             ? launch_len<kCont, kDedup, true>(a, mode, ntiles, s)
             : launch_len<kCont, kDedup, false>(a, mode, ntiles, s);
}

template <bool kCont>
int launch_dedup(const Args& a, int mode, int ntiles, cudaStream_t s) {
  return (mode & kModeDedup)
             ? launch_words<kCont, true>(a, mode, ntiles, s)
             : launch_words<kCont, false>(a, mode, ntiles, s);
}

}  // namespace

// Slots a block takes: the caller sizes the tile status array to
// ceil(cap / emit_verify_tile()) entries.
extern "C" int emit_verify_tile() { return kTile; }

// packed2: int64 [2 nrows, wp]; lengths: int32 [n1]; rk: int64, rleft and
// cum: int32, each from the chunk's first hit, nh of them (cum the
// inclusive sum of the chunk's counts); sid: int64 [m]; words: int64
// [cap] (mode bit kModeWords) or r2_out, meta_out: int32 [cap];
// keep_counts: int32 [n1] and scratch: zeroed, scratch holding one int32
// n_keep, one pad word, a uint32 ticket and its pad, then
// ceil(cap / kTile) uint64 tile states (8-byte aligned).  All contiguous
// on `device`.  Launches on `stream` and returns the CUDA error as an int
// (0 on success), or -1 for arguments out of the kernel's range.
extern "C" int emit_verify_launch(
    const void* packed2, const void* lengths, const void* rk,
    const void* rleft, const void* cum, const void* sid, void* words,
    void* r2_out, void* meta_out, void* keep_counts, void* scratch,
    int64_t m, int cap, int nh, int n1, int nrows, int wp, int w,
    int qw_max, int row0, int hash_len, int npos, int lmax, int off_bits,
    int uniform_len, int mode, int device, void* stream) {
  if (cap <= 0 || wp <= 0 || w <= 0 || qw_max + w + 1 > wp || npos <= 0 ||
      nh < 0 || off_bits > 27) {
    return -1;
  }
  int stage_rows = kStageBytes / (4 * wp);
  stage_rows = stage_rows < kMaxStageRows ? stage_rows : kMaxStageRows;
  int32_t* s = static_cast<int32_t*>(scratch);
  Args a;
  a.packed2 = static_cast<const uint32_t*>(packed2);
  a.lengths = static_cast<const int32_t*>(lengths);
  a.rk = static_cast<const int64_t*>(rk);
  a.rleft = static_cast<const int32_t*>(rleft);
  a.cum = static_cast<const int32_t*>(cum);
  a.sid = static_cast<const int64_t*>(sid);
  a.words = static_cast<int64_t*>(words);
  a.r2_out = static_cast<int32_t*>(r2_out);
  a.meta_out = static_cast<int32_t*>(meta_out);
  a.keep_counts = static_cast<int32_t*>(keep_counts);
  a.n_keep = s;
  a.ticket = reinterpret_cast<unsigned int*>(s + 2);
  a.status = reinterpret_cast<unsigned long long*>(s + 4);
  a.m = m;
  a.cap = cap;
  a.nh = nh;
  a.n1 = n1;
  a.nrows = nrows;
  a.wp = wp;
  a.w = w;
  a.qw_max = qw_max;
  a.row0 = row0;
  a.hash_len = hash_len;
  a.npos = npos;
  a.lmax = lmax;
  a.off_bits = off_bits;
  a.uniform_len = uniform_len;
  a.stage_rows = stage_rows;
  const int ntiles = (cap + kTile - 1) / kTile;
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err == cudaSuccess && prev != device) {
    err = cudaSetDevice(device);
  }
  if (err != cudaSuccess) {
    return static_cast<int>(err);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int rc = (mode & kModeCont) ? launch_dedup<true>(a, mode, ntiles, st)
                                    : launch_dedup<false>(a, mode, ntiles, st);
  if (prev != device) {
    err = cudaSetDevice(prev);
    if (rc == 0 && err != cudaSuccess) {
      return static_cast<int>(err);
    }
  }
  return rc;
}
