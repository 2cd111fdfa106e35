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
// window_hash_at serves the same TPU kernel's reverse-strand launch: the
// pipeline needs only two windows a read of the reverse strand (starts
// lmax - len and lmax - l), so it hashes k given windows a row.  What
// bounds it: bytes, but at lmax = 100 the two windows (0..38 and 61..99)
// touch nearly every 32-byte sector of a row, so device memory moves about
// a whole row a read while the bound counts the 78 covered bytes: ~80% of
// the bound is its ceiling there.  This design: one thread an output, in
// output order e = row * k + i, so a row's k windows sit in neighbouring
// lanes and share its sectors in L1; each thread prefetches its row into
// L1, loads its start, then its window straight from device memory as
// aligned 16-byte chunks, four in flight at a time, takes the bytes out by
// shifts and runs Horner's rule for both bases in registers (bytes before
// the window hash as 0, which leaves the sums at 0).  No shared memory
// and no block barrier; a flat grid, one output a thread.  Tried on an
// H100 and slower: 4-byte loads aligned by funnel shifts, one chunk in
// flight, no prefetch, and a persistent grid that prefetches each
// thread's next output.  A start outside [0, lmax - l] is not read: the
// thread writes 0 and sets the caller's flag, which the caller reads back
// with a copy it makes anyway, so no launch waits for a check.
//
// Launch setup (the SM count, the shared-memory attribute, the occupancy)
// is queried once per kernel, device and shared-memory size, not per
// launch.

#include <cstdint>
#include <map>
#include <mutex>
#include <tuple>

#include <cuda_runtime.h>

namespace {

constexpr uint32_t kB1 = 0x01000193u;  // FNV prime
constexpr uint32_t kB2 = 0x9E3779B1u;  // golden-ratio odd constant
constexpr uint32_t kM1 = 0x85EBCA6Bu;
constexpr uint32_t kM2 = 0xC2B2AE35u;
constexpr int kThreads = 256;
constexpr int kMaxRows = 128;              // rows per tile
constexpr int64_t kMaxGrid = 1 << 20;     // window_hash_at's blocks
constexpr int kHashSmem = 72 * 1024;       // per block: three blocks an SM

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

// Horner's rule for both bases over the nb low bytes of v4 (all four for
// nb >= 4), whose bytes each hold a code value c + 1 (at most 4, so bytes
// never carry into each other).
__device__ __forceinline__ void horner(uint32_t v4, int nb, uint32_t& w1,
                                       uint32_t& w2) {
  auto step = [&](int b) {
    const uint32_t v = (v4 >> (8 * b)) & 0xFFu;
    w1 = w1 * kB1 + v;
    w2 = w2 * kB2 + v;
  };
  if (nb >= 4) {
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      step(b);
    }
  } else {
    for (int b = 0; b < nb; ++b) {
      step(b);
    }
  }
}

__global__ void __launch_bounds__(kThreads)
window_hash_at_kernel(const uint8_t* __restrict__ codes,
                      const uint8_t* __restrict__ codes_end,
                      const int64_t* __restrict__ starts,
                      int64_t* __restrict__ out, int32_t* __restrict__ bad,
                      int64_t total, int lmax, int hash_len, int k) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  long long* dst = reinterpret_cast<long long*>(out);
  for (int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       e < total; e += stride) {
    const int64_t row = k == 2 ? e >> 1 : e / k;
    const uint8_t* rowp = codes + row * lmax;
    // the row's first and last lines (all of a row of up to 128 bytes)
    // start on their way to L1 while the start is loaded
    asm volatile("prefetch.global.L1 [%0];" :: "l"(rowp));
    asm volatile("prefetch.global.L1 [%0];" :: "l"(rowp + lmax - 1));
    const int64_t s = __ldcs(reinterpret_cast<const long long*>(starts) + e);
    if (s < 0 || s > lmax - hash_len) {
      *bad = 1;
      __stcs(dst + e, 0LL);
      continue;
    }
    const uint8_t* p = rowp + s;
    uint32_t w1 = 0;
    uint32_t w2 = 0;
    // the window as 16-byte chunks from the aligned address at or below p;
    // `head` bytes of the first chunk precede the window
    const int head = static_cast<int>(reinterpret_cast<uintptr_t>(p) & 15);
    const uint4* cp = reinterpret_cast<const uint4*>(p - head);
    const int nbytes = head + hash_len;
    const int nchunks = (nbytes + 15) >> 4;
    if (reinterpret_cast<const uint8_t*>(cp) < codes ||
        reinterpret_cast<const uint8_t*>(cp + nchunks) > codes_end) {
      // a chunk would leave the tensor (its first or last row): bytes
      for (int i = 0; i < hash_len; ++i) {
        horner((p[i] & 3u) + 1u, 1, w1, w2);
      }
    } else {
      // four chunks in flight, then hashed
      for (int c0 = 0; c0 < nchunks; c0 += 4) {
        uint4 q[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          if (c0 + u < nchunks) {
            q[u] = __ldg(cp + c0 + u);
          }
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          if (c0 + u >= nchunks) {
            break;
          }
          const uint32_t words[4] = {q[u].x, q[u].y, q[u].z, q[u].w};
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int pos = 16 * (c0 + u) + 4 * j;  // the word's first byte
            const int lead = head - pos;            // its bytes before p
            if (pos >= nbytes) {
              break;
            }
            if (lead >= 4) {
              continue;
            }
            uint32_t v4 = (words[j] & 0x03030303u) + 0x01010101u;
            if (lead > 0) {
              v4 &= 0xFFFFFFFFu << (8 * lead);
            }
            horner(v4, nbytes - pos, w1, w2);
          }
        }
      }
    }
    __stcs(dst + e, static_cast<long long>(mix(w1, w2)));
  }
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

// Launch setup, cached: blocks of a persistent grid per (kernel, device,
// dynamic shared memory), and the largest shared-memory attribute set per
// (kernel, device).  Queried on first use only, under one lock.
std::mutex g_launch_mu;
std::map<std::tuple<const void*, int, size_t>, int64_t> g_blocks;
std::map<std::tuple<const void*, int>, size_t> g_smem_attr;

// As many blocks as fit on the current device at `smem` bytes of dynamic
// shared memory each.
template <typename Kernel>
cudaError_t persistent_blocks(Kernel kernel, size_t smem, int64_t* blocks) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) {
    return err;
  }
  const void* fn = reinterpret_cast<const void*>(kernel);
  std::lock_guard<std::mutex> lock(g_launch_mu);
  const auto key = std::make_tuple(fn, dev, smem);
  const auto hit = g_blocks.find(key);
  if (hit != g_blocks.end()) {
    *blocks = hit->second;
    return cudaSuccess;
  }
  int sms = 0;
  int per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  size_t& attr = g_smem_attr[std::make_tuple(fn, dev)];
  if (err == cudaSuccess && smem > attr) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err == cudaSuccess) {
      attr = smem;
    }
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, smem);
  }
  if (err != cudaSuccess) {
    return err;
  }
  *blocks = static_cast<int64_t>(per_sm > 0 ? per_sm : 1) * sms;
  g_blocks[key] = *blocks;
  return cudaSuccess;
}

// Launch `kernel` on a persistent grid: as many blocks as fit on the card
// at `smem` bytes of dynamic shared memory each, at most one per tile.
template <typename Kernel, typename... Args>
int launch_persistent(Kernel kernel, int64_t ntiles, size_t smem,
                      cudaStream_t stream, Args... args) {
  int64_t blocks = 0;
  const cudaError_t err = persistent_blocks(kernel, smem, &blocks);
  if (err != cudaSuccess) {
    return static_cast<int>(err);
  }
  blocks = blocks < ntiles ? blocks : ntiles;
  kernel<<<static_cast<unsigned int>(blocks), kThreads, smem, stream>>>(
      args...);
  return static_cast<int>(cudaGetLastError());
}

size_t round16(size_t x) { return (x + 15) & ~static_cast<size_t>(15); }

// Run launch() with `device` current (the caller's device is restored), so
// the wrapper need not switch devices itself.
template <typename Launch>
int on_device(int device, Launch launch) {
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err == cudaSuccess && prev != device) {
    err = cudaSetDevice(device);
  }
  if (err != cudaSuccess) {
    return static_cast<int>(err);
  }
  const int rc = launch();
  if (prev != device) {
    err = cudaSetDevice(prev);
    if (rc == 0 && err != cudaSuccess) {
      return static_cast<int>(err);
    }
  }
  return rc;
}

}  // namespace

// codes: uint8 [n, lmax] contiguous on the device (any alignment); out:
// int64 [n, npos] contiguous and 16-byte aligned.  Requires
// 1 <= hash_len <= lmax < 4096; b1_pow_l and b2_pow_l are B1^l and B2^l
// mod 2^32.  Launches on `stream` of device `device` and returns the CUDA
// error as an int (0 on success).
extern "C" int window_hash_launch(const void* codes, void* out, int64_t n,
                                  int lmax, int hash_len, uint32_t b1_pow_l,
                                  uint32_t b2_pow_l, int device,
                                  void* stream) {
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
  return on_device(device, [&] {
    return launch_persistent(
        window_hash_kernel, (n + rows - 1) / rows, smem,
        static_cast<cudaStream_t>(stream),
        static_cast<const uint8_t*>(codes), static_cast<int64_t*>(out), n,
        lmax, hash_len, rows, buf_bytes, b1_pow_l, b2_pow_l, magic);
  });
}

// codes: uint8 [n, lmax] contiguous (any alignment); starts: int64 [n, k]
// contiguous; out: int64 [n, k] contiguous; bad: one int32 on the device.
// out[r, i] is window_hash's value at row r, start starts[r, i]; a start
// outside [0, lmax - hash_len] gives 0 there and sets *bad to 1 (nothing
// else is written to it: the caller zeroes it and reads it back).
// Launches on `stream` of device `device`; returns the CUDA error as an
// int.
extern "C" int window_hash_at_launch(const void* codes, const void* starts,
                                     void* out, void* bad, int64_t n,
                                     int lmax, int hash_len, int k,
                                     int device, void* stream) {
  if (n <= 0 || k <= 0) {
    return 0;
  }
  return on_device(device, [&] {
    const int64_t total = n * k;
    int64_t blocks = (total + kThreads - 1) / kThreads;
    blocks = blocks < kMaxGrid ? blocks : kMaxGrid;  // the loop strides on
    const uint8_t* c = static_cast<const uint8_t*>(codes);
    window_hash_at_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
        c, c + n * lmax, static_cast<const int64_t*>(starts),
        static_cast<int64_t*>(out), static_cast<int32_t*>(bad), total, lmax,
        hash_len, k);
    return static_cast<int>(cudaGetLastError());
  });
}
