// Window hashes of the overlap index, written by hand for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel metagenomics_tpu/ops/pallas_hash.py
// (_kernel, launched by _window_hashes_padded).  For every row of base
// codes and every window start j < npos = lmax - l + 1, with
// c = (code & 3) + 1, it computes
//
//     w1 = sum_{k<l} c[j+k] * B1^(l-1-k)   (mod 2^32), w2 likewise with B2,
//     out[row, j] = (w1 * M1) xor (w2 * M2)
//
// bit for bit as the reference's rolling hash (device_overlap.py
// window_hashes_u32) and the port's plain version (ops/window_hash.py
// window_hashes_torch).  The value is stored zero-extended in an int64,
// the layout the port's probe join consumes.  A second entry point,
// window_hash_at, computes the same value at k given starts per row only
// (the pipeline's reverse-strand keys, two per read).
//
// What bounds it on the H100: bytes.  window_hash reads N*lmax code bytes
// and writes N*npos 8-byte hashes (540 MB at [906397, 100], l = 39: 0.161
// ms at 3.35 TB/s).  The first version of this kernel reached a third of
// that, with a time nearly flat in l: its tile was loaded one byte per
// thread and nothing overlapped the load with the stores.  This design:
//
//  - constant work per output: a prefix pass stages, per row and base,
//    P[i] = sum_{k<i} c[k] * B^(i-1-k) in shared memory (two threads a
//    row, one per base, lmax IMADs each over codes read four to a
//    32-bit shared load), and then w[j] = P[j+l] - P[j] * B^l in
//    wrap-around uint32 arithmetic (the identity the Pallas docstring
//    states), with B^l passed by the caller: two 8-byte shared loads and
//    four multiplies per output, whatever l is, and the output's row
//    found by a multiply-high instead of a division;
//  - wide, overlapped loads: a tile of whole rows is one contiguous byte
//    range, copied with 16-byte cp.async into one of two shared buffers
//    (the unaligned head and tail bytes plainly), so a persistent grid of
//    a few blocks per SM stages tile t + grid while it hashes tile t;
//    rows per tile are chosen so the range is a multiple of 16 bytes;
//  - coalesced streaming stores: a tile's outputs are one contiguous int64
//    range; each warp hashes 64 consecutive outputs (lane-consecutive
//    shared loads, no bank conflicts), swaps them with shuffles so each
//    lane holds a pair, and writes the pair as one 16-byte __stcs store
//    (tile starts are even, so every pair is 16-byte aligned).
//
// Tuned on an H100 (variants timed in turns with it; PERF.md): the word
// loads and the multiply-high took 9-27% off the first version of this
// design; 36, 56 and 110 KB of shared memory a block and 128 or 512
// threads moved it by less than 5% or made it slower.
//
// window_hash_at is gather-shaped: per output l bytes of one row, so it
// stages tiles the same way and runs Horner's rule over the staged bytes.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint32_t kB1 = 0x01000193u;  // FNV prime
constexpr uint32_t kB2 = 0x9E3779B1u;  // golden-ratio odd constant
constexpr uint32_t kM1 = 0x85EBCA6Bu;
constexpr uint32_t kM2 = 0xC2B2AE35u;
constexpr int kThreads = 256;
constexpr int kMaxRows = 128;              // rows per tile
constexpr int kHashSmem = 72 * 1024;       // per block: three blocks an SM
constexpr int kAtSmem = 32 * 1024;

__device__ __forceinline__ uint32_t mix(uint32_t w1, uint32_t w2) {
  return (w1 * kM1) ^ (w2 * kM2);
}

// Stage bytes [src, src + nbytes) at buf + (src & 15), so that 16-byte
// aligned global chunks land on 16-byte aligned shared addresses: the
// aligned middle as asynchronous 16-byte copies, the head and tail bytes
// with plain loads.  The caller commits the group and waits for it.
__device__ __forceinline__ void stage_async(uint8_t* buf, const uint8_t* src,
                                            int nbytes) {
  const int mis = static_cast<int>(reinterpret_cast<uintptr_t>(src) & 15);
  uint8_t* dst = buf + mis;
  const int head = min((16 - mis) & 15, nbytes);
  const int nvec = (nbytes - head) >> 4;
  for (int i = threadIdx.x; i < head; i += blockDim.x) {
    dst[i] = src[i];
  }
  for (int i = head + (nvec << 4) + threadIdx.x; i < nbytes;
       i += blockDim.x) {
    dst[i] = src[i];
  }
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst + head));
  const uint8_t* g = src + head;
  for (int v = threadIdx.x; v < nvec; v += blockDim.x) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 :: "r"(s + 16 * v), "l"(g + 16 * v) : "memory");
  }
}

__device__ __forceinline__ void commit_group() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void wait_all_but_newest() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Persistent loop over tiles of `rows_per_tile` whole rows, tile
// blockIdx.x, blockIdx.x + gridDim.x, ...: the next tile is staged into
// the other buffer while body(tile bytes, first row, rows) runs on this
// one.  Every thread of the block calls body; it may synchronise.
template <typename Body>
__device__ __forceinline__ void for_each_tile(const uint8_t* codes, int64_t n,
                                              int lmax, int rows_per_tile,
                                              uint8_t* buf0, uint8_t* buf1,
                                              Body body) {
  const int64_t ntiles = (n + rows_per_tile - 1) / rows_per_tile;
  const int64_t tile_bytes = static_cast<int64_t>(rows_per_tile) * lmax;
  auto rows_of = [&](int64_t t) {
    const int64_t left = n - t * rows_per_tile;
    return left < rows_per_tile ? static_cast<int>(left) : rows_per_tile;
  };
  int64_t t = blockIdx.x;
  if (t < ntiles) {
    stage_async(buf0, codes + t * tile_bytes, rows_of(t) * lmax);
  }
  commit_group();
  for (int it = 0; t < ntiles; t += gridDim.x, ++it) {
    const int64_t next = t + gridDim.x;
    if (next < ntiles) {
      stage_async((it & 1) ? buf0 : buf1, codes + next * tile_bytes,
                  rows_of(next) * lmax);
    }
    commit_group();
    wait_all_but_newest();
    __syncthreads();
    const uint8_t* src = codes + t * tile_bytes;
    const uint8_t* tile = ((it & 1) ? buf1 : buf0) +
                          (reinterpret_cast<uintptr_t>(src) & 15);
    body(tile, t * rows_per_tile, rows_of(t));
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kThreads, 3)
window_hash_kernel(const uint8_t* __restrict__ codes,
                   int64_t* __restrict__ out, int64_t n, int lmax,
                   int hash_len, int rows_per_tile, int buf_bytes,
                   uint32_t b1_pow_l, uint32_t b2_pow_l,
                   uint32_t npos_magic) {
  extern __shared__ __align__(16) uint8_t smem[];
  // prefix hashes: P[row * stride + i] = (P_B1[i], P_B2[i]), i <= lmax
  uint2* prefix = reinterpret_cast<uint2*>(smem + 2 * buf_bytes);
  const unsigned npos = lmax - hash_len + 1;
  const int stride = lmax + 1;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;

  for_each_tile(codes, n, lmax, rows_per_tile, smem, smem + buf_bytes,
                [&](const uint8_t* tile, int64_t row0, int rows) {
    uint32_t* pw = reinterpret_cast<uint32_t*>(prefix);
    for (int t = threadIdx.x; t < 2 * rows; t += blockDim.x) {
      const int r = t >> 1;
      const uint32_t base = (t & 1) ? kB2 : kB1;
      const uint8_t* c = tile + r * lmax;
      uint32_t* p = pw + 2 * r * stride + (t & 1);
      uint32_t h = 0;
      p[0] = 0;
      auto step = [&](uint32_t code, int i) {
        h = h * base + ((code & 3u) + 1u);
        p[2 * (i + 1)] = h;
      };
      // bytes up to a 4-byte boundary, then four codes a 32-bit load
      int i = 0;
      for (; i < lmax && (reinterpret_cast<uintptr_t>(c + i) & 3); ++i) {
        step(c[i], i);
      }
      for (; i + 4 <= lmax; i += 4) {
        const uint32_t w = *reinterpret_cast<const uint32_t*>(c + i);
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          step(w >> (8 * b), i + b);
        }
      }
      for (; i < lmax; ++i) {
        step(c[i], i);
      }
    }
    __syncthreads();

    const unsigned total = static_cast<unsigned>(rows) * npos;
    long long* dst = reinterpret_cast<long long*>(out + row0 * npos);
    auto hash_at = [&](unsigned e) -> uint32_t {
      const unsigned r = npos_magic ? __umulhi(e, npos_magic) : e;
      const uint2* pr = prefix + r * stride + (e - r * npos);
      const uint2 a = pr[0];
      const uint2 z = pr[hash_len];
      return mix(z.x - a.x * b1_pow_l, z.y - a.y * b2_pow_l);
    };
    for (unsigned base = 64u * warp; base < total; base += 64u * nwarps) {
      const unsigned e0 = base + lane;
      const unsigned e1 = e0 + 32;
      const uint32_t h0 = e0 < total ? hash_at(e0) : 0u;
      const uint32_t h1 = e1 < total ? hash_at(e1) : 0u;
      // lane k takes outputs base + 2k and base + 2k + 1
      const int from = (2 * lane) & 31;
      const uint32_t a0 = __shfl_sync(0xffffffffu, h0, from);
      const uint32_t a1 = __shfl_sync(0xffffffffu, h0, from + 1);
      const uint32_t b0 = __shfl_sync(0xffffffffu, h1, from);
      const uint32_t b1 = __shfl_sync(0xffffffffu, h1, from + 1);
      const unsigned e = base + 2 * lane;
      const long long lo = lane < 16 ? a0 : b0;
      const long long hi = lane < 16 ? a1 : b1;
      if (e + 1 < total) {
        __stcs(reinterpret_cast<longlong2*>(dst + e), make_longlong2(lo, hi));
      } else if (e < total) {
        __stcs(dst + e, lo);
      }
    }
  });
}

__global__ void __launch_bounds__(kThreads)
window_hash_at_kernel(const uint8_t* __restrict__ codes,
                      const int64_t* __restrict__ starts,
                      int64_t* __restrict__ out, int64_t n, int lmax,
                      int hash_len, int k, int rows_per_tile,
                      int buf_bytes) {
  extern __shared__ __align__(16) uint8_t smem[];
  for_each_tile(codes, n, lmax, rows_per_tile, smem, smem + buf_bytes,
                [&](const uint8_t* tile, int64_t row0, int rows) {
    const int total = rows * k;
    const int64_t* st = starts + row0 * k;
    long long* dst = reinterpret_cast<long long*>(out + row0 * k);
    for (int e = threadIdx.x; e < total; e += blockDim.x) {
      const uint8_t* c = tile + (e / k) * lmax + static_cast<int>(st[e]);
      uint32_t w1 = 0;
      uint32_t w2 = 0;
      for (int i = 0; i < hash_len; ++i) {
        const uint32_t v = (c[i] & 3u) + 1u;
        w1 = w1 * kB1 + v;
        w2 = w2 * kB2 + v;
      }
      __stcs(dst + e, static_cast<long long>(mix(w1, w2)));
    }
  });
}

int gcd(int a, int b) {
  while (b) {
    const int t = a % b;
    a = b;
    b = t;
  }
  return a;
}

// Rows per tile: as many as `budget` bytes of shared memory hold (at
// `per_row` bytes a row plus `fixed`), at most kMaxRows, even, and a
// multiple of 16 / gcd(lmax, 16) so each tile's byte range is a whole
// number of 16-byte chunks; 2 where not even that fits.
int rows_per_tile(int lmax, int per_row, int fixed, int budget) {
  int q = 16 / gcd(lmax, 16);
  if (q & 1) {
    q *= 2;
  }
  int rows = (budget - fixed) / per_row;
  rows = rows < kMaxRows ? rows : kMaxRows;
  return rows >= q ? rows - rows % q : 2;
}

// Launch `kernel` on a persistent grid: as many blocks as fit on the card
// at `smem` bytes of dynamic shared memory each, at most one per tile.
template <typename Kernel, typename... Args>
int launch_persistent(Kernel kernel, int64_t ntiles, size_t smem,
                      cudaStream_t stream, Args... args) {
  int dev = 0;
  int sms = 0;
  int per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, smem);
  }
  if (err != cudaSuccess) {
    return static_cast<int>(err);
  }
  int64_t blocks = static_cast<int64_t>(per_sm > 0 ? per_sm : 1) * sms;
  blocks = blocks < ntiles ? blocks : ntiles;
  kernel<<<static_cast<unsigned int>(blocks), kThreads, smem, stream>>>(
      args...);
  return static_cast<int>(cudaGetLastError());
}

size_t round16(size_t x) { return (x + 15) & ~static_cast<size_t>(15); }

}  // namespace

// codes: uint8 [n, lmax] contiguous on the device (any alignment); out:
// int64 [n, npos] contiguous and 16-byte aligned.  Requires
// 1 <= hash_len <= lmax < 4096; b1_pow_l and b2_pow_l are B1^l and B2^l
// mod 2^32.  Launches on `stream` and returns the CUDA error as an int
// (0 on success).
extern "C" int window_hash_launch(const void* codes, void* out, int64_t n,
                                  int lmax, int hash_len, uint32_t b1_pow_l,
                                  uint32_t b2_pow_l, void* stream) {
  if (n <= 0) {
    return 0;
  }
  const int per_row = 2 * lmax + (lmax + 1) * 8;
  const int rows = rows_per_tile(lmax, per_row, 64, kHashSmem);
  const int buf_bytes = static_cast<int>(round16(rows * lmax + 16));
  // r = e / npos as a multiply-high by ceil(2^32 / npos): exact for
  // e * (npos - 2^32 mod npos) < 2^32, which holds since e < kMaxRows *
  // 4096 = 2^19 and npos <= 4096; npos = 1 (no 32-bit magic) passes 0
  const uint32_t npos = lmax - hash_len + 1;
  const uint32_t magic = npos == 1 ? 0u : static_cast<uint32_t>(
      ((1ull << 32) + npos - 1) / npos);
  const size_t smem = 2 * static_cast<size_t>(buf_bytes) +
                      static_cast<size_t>(rows) * (lmax + 1) * 8;
  return launch_persistent(
      window_hash_kernel, (n + rows - 1) / rows, smem,
      static_cast<cudaStream_t>(stream), static_cast<const uint8_t*>(codes),
      static_cast<int64_t*>(out), n, lmax, hash_len, rows, buf_bytes,
      b1_pow_l, b2_pow_l, magic);
}

// codes: uint8 [n, lmax] contiguous (any alignment); starts: int64 [n, k]
// contiguous, every value in [0, lmax - hash_len] (the caller checks);
// out: int64 [n, k] contiguous.  out[r, i] is window_hash's value at row
// r, start starts[r, i].  Returns the CUDA error as an int.
extern "C" int window_hash_at_launch(const void* codes, const void* starts,
                                     void* out, int64_t n, int lmax,
                                     int hash_len, int k, void* stream) {
  if (n <= 0 || k <= 0) {
    return 0;
  }
  const int rows = rows_per_tile(lmax, 2 * lmax, 64, kAtSmem);
  const int buf_bytes = static_cast<int>(round16(rows * lmax + 16));
  return launch_persistent(
      window_hash_at_kernel, (n + rows - 1) / rows, 2 * buf_bytes,
      static_cast<cudaStream_t>(stream), static_cast<const uint8_t*>(codes),
      static_cast<const int64_t*>(starts), static_cast<int64_t*>(out), n,
      lmax, hash_len, k, rows, buf_bytes);
}
