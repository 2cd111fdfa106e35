// The device pipeline's row packing, written by hand for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the JAX package's _setup_kernel makes its
// rows with XLA ops (metagenomics_tpu/ops/device_overlap.py:329-341) and
// only then hashes them (:344-347), and the port's plain version
// (ops/device_overlap.py _setup_pack_torch) is the same chain in torch.
// From the forward packed words pf [n1, w] (2-bit bases, 16 a word,
// LSB-first lanes, zero-extended in int64) this kernel writes, bit for
// bit as the plain version:
//
//  - codes [n1, lmax] uint8: base c of row r, lane c & 15 of word c >> 4;
//  - flipped [n1, lmax] uint8: 3 - codes[r, lmax - 1 - c], the reverse
//    strand in the flipped-padded layout (a row's data at its right end);
//  - packed2 [2 n1, wp] int64: rows [0, n1) the forward words, rows
//    [n1, 2 n1) the flipped rows packed 16 bases a word (lanes at or past
//    lmax zero), each row zero-padded from w to wp words.
//
// What bounds it: bytes.  It reads pf once (8 bytes a word) and writes
// the three outputs once: n1 (8 w + 2 lmax + 16 wp) bytes, 75.8 MB at the
// 150 bp cells and 98.8 MB at the trimmed 300 bp cell, 23-30 us at
// 3.35 TB/s.  The torch chain it replaces widened every base to an int64
// lane ([n1, 16 w] int64, 149 MB a pass at the 150 bp cells) about ten
// times over.  This design:
//
//  - one launch, no intermediate in device memory: a block takes `rows`
//    consecutive rows (a multiple of 16, so each block's byte outputs
//    start 16-byte aligned), stages their words once in shared memory as
//    uint32, and beside each its reverse complement;
//  - the reverse strand from words, not bases: complementing a word is
//    x ^ 0xFFFFFFFF, and reversing its sixteen 2-bit lanes is a bit
//    reverse (__brev) followed by a swap of adjacent bits.  Word m of the
//    reversed row is the reverse complement of forward word w - 1 - m;
//    that string is the flipped row shifted by d = 16 w - lmax lanes, so
//    any 16 flipped lanes are one funnel shift of two neighbours;
//  - byte outputs as 16-byte stores: a thread takes 16 consecutive bytes
//    of the block's flat [rows, lmax] range, gathers their 16 lanes into
//    one word (a funnel shift, and one more where the 16 bytes cross into
//    the next row), spreads them to bytes and stores them with one uint4
//    store an output;
//  - word outputs as coalesced 8-byte stores, neighbouring threads on
//    neighbouring words.
//
// It takes any lmax < 4096 and any w with lmax <= 16 w <= 4096: nothing
// reads a read length (pf's lanes past a read are 0, so the plain version
// gives its padding as that of pf), and lanes of pf at or past lmax are
// never read into an output.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kStageWords = 4096;  // uint32 words a strand a block, at most
constexpr int kMaxRows = 64;       // rows a block, at most

struct Args {
  const int64_t* pf;  // [n1, w], values < 2^32
  uint8_t* codes;     // [n1, lmax]
  uint8_t* flipped;   // [n1, lmax]
  int64_t* packed2;   // [2 n1, wp]
  int n1, w, wp, lmax, rows;
};

// Complement each 2-bit lane of x and reverse the lanes' order.
__device__ __forceinline__ uint32_t reverse_complement(uint32_t x) {
  const uint32_t y = __brev(~x);
  return ((y >> 1) & 0x55555555u) | ((y & 0x55555555u) << 1);
}

// The 16 lanes of a staged row (w words) from lane c on; lanes past the
// row's 16 w read 0.
__device__ __forceinline__ uint32_t lanes_at(const uint32_t* row, int w,
                                             int c) {
  const int q = c >> 4;
  const uint32_t lo = q < w ? row[q] : 0u;
  const uint32_t hi = q + 1 < w ? row[q + 1] : 0u;
  return __funnelshift_r(lo, hi, static_cast<unsigned>(c & 15) << 1);
}

// The 16 bases of the flat [nrows, lmax] range from row rr, column c on,
// lane i the base at flat position + i: base c of row rr is lane c + off
// of the staged row.  Bases past the last row read 0.
__device__ __forceinline__ uint32_t chunk_lanes(const uint32_t* s, int w,
                                                int lmax, int off, int rr,
                                                int c, int nrows) {
  uint32_t x = 0;
  int filled = 0;
  while (filled < 16 && rr < nrows) {
    const int n = min(16 - filled, lmax - c);
    uint32_t v = lanes_at(s + rr * w, w, c + off);
    if (n < 16) {
      v &= (1u << (2 * n)) - 1u;
    }
    x |= v << (2 * filled);
    filled += n;
    c += n;
    if (c == lmax) {
      c = 0;
      ++rr;
    }
  }
  return x;
}

// Four 2-bit lanes (the low byte of b) to four bytes.
__device__ __forceinline__ uint32_t spread4(uint32_t b) {
  return (b & 0x3u) | ((b & 0xCu) << 6) | ((b & 0x30u) << 12) |
         ((b & 0xC0u) << 18);
}

__device__ __forceinline__ uint4 spread16(uint32_t x) {
  return make_uint4(spread4(x & 0xFFu), spread4((x >> 8) & 0xFFu),
                    spread4((x >> 16) & 0xFFu), spread4(x >> 24));
}

__global__ void __launch_bounds__(kThreads)
    setup_pack_kernel(const Args a) {
  extern __shared__ uint32_t stage[];
  const int w = a.w;
  uint32_t* const sf = stage;               // rows x w forward words
  uint32_t* const sr = stage + a.rows * w;  // rows x w reversed words
  const int t = threadIdx.x;
  const int r0 = blockIdx.x * a.rows;
  const int nrows = min(a.rows, a.n1 - r0);

  // ------------------------------------ the block's words, read once
  {
    const int64_t* src = a.pf + static_cast<int64_t>(r0) * w;
    for (int x = t; x < nrows * w; x += kThreads) {
      const uint32_t v = static_cast<uint32_t>(src[x]);
      const int rr = x / w;
      const int k = x - rr * w;
      sf[x] = v;
      sr[rr * w + (w - 1 - k)] = reverse_complement(v);
    }
  }
  __syncthreads();

  // ---------------------- codes and flipped, 16 bytes a thread and store
  const int lmax = a.lmax;
  const int d = 16 * w - lmax;  // flipped base c is reversed lane c + d
  {
    const int nbytes = nrows * lmax;
    const int64_t base = static_cast<int64_t>(r0) * lmax;
    uint8_t* const cf = a.codes + base;
    uint8_t* const cr = a.flipped + base;
    for (int j = t; j < (nbytes + 15) >> 4; j += kThreads) {
      const int p = j << 4;
      const int rr = p / lmax;
      const int c = p - rr * lmax;
      const uint32_t xf = chunk_lanes(sf, w, lmax, 0, rr, c, nrows);
      const uint32_t xr = chunk_lanes(sr, w, lmax, d, rr, c, nrows);
      if (p + 16 <= nbytes) {
        *reinterpret_cast<uint4*>(cf + p) = spread16(xf);
        *reinterpret_cast<uint4*>(cr + p) = spread16(xr);
      } else {
        for (int i = 0; i < nbytes - p; ++i) {
          cf[p + i] = static_cast<uint8_t>((xf >> (2 * i)) & 3u);
          cr[p + i] = static_cast<uint8_t>((xr >> (2 * i)) & 3u);
        }
      }
    }
  }

  // ---------------------------------- both strands' words, zero-padded
  {
    const int wp = a.wp;
    int64_t* const out_f = a.packed2 + static_cast<int64_t>(r0) * wp;
    int64_t* const out_r =
        a.packed2 + (static_cast<int64_t>(a.n1) + r0) * wp;
    for (int x = t; x < nrows * wp; x += kThreads) {
      const int rr = x / wp;
      const int k = x - rr * wp;
      uint32_t f = 0;
      uint32_t r = 0;
      if (k < w) {
        f = sf[rr * w + k];
        r = lanes_at(sr + rr * w, w, 16 * k + d);
      }
      out_f[x] = static_cast<int64_t>(f);
      out_r[x] = static_cast<int64_t>(r);
    }
  }
}

// Rows a block for w words a row: a multiple of 16, at most kMaxRows,
// with both strands' staged words within kStageWords each.
int rows_a_block(int w) {
  int rows = 16 * (kStageWords / (16 * w));
  rows = rows < kMaxRows ? rows : kMaxRows;
  return rows < 16 ? 16 : rows;
}

}  // namespace

// pf: int64 [n1, w]; codes, flipped: uint8 [n1, lmax]; packed2: int64
// [2 n1, wp]; all contiguous on `device`, the byte outputs 16-byte
// aligned.  Launches on `stream` and returns the CUDA error as an int (0
// on success), or -1 for arguments out of the kernel's range.
extern "C" int setup_pack_launch(const void* pf, void* codes, void* flipped,
                                 void* packed2, int n1, int w, int wp,
                                 int lmax, int device, void* stream) {
  if (n1 <= 0 || w <= 0 || 16 * w > kStageWords || wp < w || lmax <= 0 ||
      lmax > 16 * w || lmax >= 4096) {
    return -1;
  }
  Args a;
  a.pf = static_cast<const int64_t*>(pf);
  a.codes = static_cast<uint8_t*>(codes);
  a.flipped = static_cast<uint8_t*>(flipped);
  a.packed2 = static_cast<int64_t*>(packed2);
  a.n1 = n1;
  a.w = w;
  a.wp = wp;
  a.lmax = lmax;
  a.rows = rows_a_block(w);
  const int nblocks = (n1 + a.rows - 1) / a.rows;
  const size_t smem = static_cast<size_t>(2 * a.rows * w) * 4;
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err == cudaSuccess && prev != device) {
    err = cudaSetDevice(device);
  }
  if (err != cudaSuccess) {
    return static_cast<int>(err);
  }
  setup_pack_kernel<<<static_cast<unsigned>(nblocks), kThreads, smem,
                      static_cast<cudaStream_t>(stream)>>>(a);
  const int rc = static_cast<int>(cudaGetLastError());
  if (prev != device) {
    err = cudaSetDevice(prev);
    if (rc == 0 && err != cudaSuccess) {
      return static_cast<int>(err);
    }
  }
  return rc;
}
