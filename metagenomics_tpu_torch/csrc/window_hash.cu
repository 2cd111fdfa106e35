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
// the layout the port's probe join consumes.
//
// What bounds it on the H100: bytes.  It reads N*lmax code bytes and
// writes N*npos 8-byte hashes; the ~2*l integer multiply-adds per output
// are far below the card's integer rate.  The design therefore touches
// device memory once per byte: each block stages a tile of whole rows in
// shared memory (converted to c on the way in, coalesced byte loads over
// the tile's contiguous range), then its threads walk the tile's
// (row, j) outputs with j fastest, so the stores of a warp are contiguous.
// Each output is a Horner evaluation over the l staged codes, which is the
// polynomial above in wrap-around uint32 arithmetic with no power table;
// neighbouring threads read neighbouring shared bytes (broadcast, no bank
// conflicts).  The TPU kernel's 256-row / 128-lane padding is a TPU tiling
// detail and has no counterpart: the ragged last tile is handled by the
// row count.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint32_t kB1 = 0x01000193u;  // FNV prime
constexpr uint32_t kB2 = 0x9E3779B1u;  // golden-ratio odd constant
constexpr uint32_t kM1 = 0x85EBCA6Bu;
constexpr uint32_t kM2 = 0xC2B2AE35u;
constexpr int kThreads = 256;
constexpr int kTileBytes = 16384;      // staged codes per block

__global__ void __launch_bounds__(kThreads)
window_hash_kernel(const uint8_t* __restrict__ codes,
                   int64_t* __restrict__ out, int64_t n, int lmax,
                   int hash_len, int rows_per_block) {
  extern __shared__ uint8_t tile[];
  const int npos = lmax - hash_len + 1;
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * rows_per_block;
  const int64_t left = n - row0;
  const int rows = left < rows_per_block ? static_cast<int>(left)
                                         : rows_per_block;
  const uint8_t* src = codes + row0 * lmax;
  const int nbytes = rows * lmax;
  for (int i = threadIdx.x; i < nbytes; i += blockDim.x) {
    tile[i] = static_cast<uint8_t>((src[i] & 3) + 1);
  }
  __syncthreads();

  int64_t* dst = out + row0 * npos;
  const int total = rows * npos;
  for (int i = threadIdx.x; i < total; i += blockDim.x) {
    const int r = i / npos;
    const int j = i - r * npos;
    const uint8_t* c = tile + r * lmax + j;
    uint32_t w1 = 0;
    uint32_t w2 = 0;
    for (int k = 0; k < hash_len; ++k) {
      const uint32_t v = c[k];
      w1 = w1 * kB1 + v;
      w2 = w2 * kB2 + v;
    }
    dst[i] = static_cast<int64_t>((w1 * kM1) ^ (w2 * kM2));
  }
}

}  // namespace

// codes: uint8 [n, lmax] contiguous on the device; out: int64 [n, npos]
// contiguous.  Requires 1 <= hash_len <= lmax <= kTileBytes (the wrapper
// enforces lmax < 4096).  Launches on `stream` and returns
// cudaGetLastError() as an int (0 on success).
extern "C" int window_hash_launch(const void* codes, void* out, int64_t n,
                                  int lmax, int hash_len, void* stream) {
  if (n <= 0) {
    return 0;
  }
  const int rows_per_block = kTileBytes / lmax > 0 ? kTileBytes / lmax : 1;
  const int64_t blocks = (n + rows_per_block - 1) / rows_per_block;
  const size_t smem = static_cast<size_t>(rows_per_block) * lmax;
  window_hash_kernel<<<static_cast<unsigned int>(blocks), kThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(codes), static_cast<int64_t*>(out), n,
      lmax, hash_len, rows_per_block);
  return static_cast<int>(cudaGetLastError());
}
