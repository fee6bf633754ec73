// Fused BON pairwise masking for Hopper (sm_90a):
//
//     out = encode(x) + sum_j sign_j * pad(keys[j], base)   (mod 2^32)
//
// over m keys: a learner's n - 1 pairwise pads and its self-mask in the
// Bonawitz baseline's masking round, and its unmask correction (the
// self-mask and the pads shared with dead peers, x = 0). Replaces the
// Pallas kernel src/repro/kernels/bon_mask.py (bon_mask, _bon_mask_kernel).
//
// What bounds it on an H100: per word it moves 8 bytes (x read, out
// written), like mask_add, but does about 36m + m + 2 operations (half a
// 20-round Threefry-2x32 evaluation and an add or subtract per key, the
// encode). At m = 36 that is about 17x the time its bytes take at
// 3.35 TB/s when issued at 128 lanes per SM per clock, so it is bound by
// operations, not bytes: the O(n) compute per learner that SAFE avoids.
//
// Design: one thread per Threefry counter accumulates both words of the
// pair over all m keys in registers and writes them once (the Pallas
// kernel unrolls m at trace time and evaluates a whole block per word,
// keeping one lane). m is not capped: the wrapper uploads the [m, 3]
// (k0, k1, sign > 0) table to the card, and each block stages it in
// shared memory kKeyTile keys at a time, so every thread of a block reads
// the same key from shared memory (a broadcast). Aligned pairs, odd-word
// views and the odd-V tail are handled as in mask_add (threefry.cuh).
#include "threefry.cuh"

namespace {

constexpr int kKeyTile = 1024;  // keys staged per pass: 12 KiB of shared memory

__global__ void __launch_bounds__(safe::kThreads)
bon_mask_kernel(const float* __restrict__ x, uint32_t* __restrict__ out,
                int64_t n, const uint32_t* __restrict__ table, int m,
                uint32_t base, float scale, bool vec) {
  __shared__ uint32_t keys[kKeyTile * 3];
  const int64_t pair = static_cast<int64_t>(blockIdx.x) * safe::kThreads + threadIdx.x;
  const uint32_t ctr = base + static_cast<uint32_t>(pair);
  uint2 acc = make_uint2(0u, 0u);
  // Every thread of the block takes part in the staging, in range or not.
  for (int j0 = 0; j0 < m; j0 += kKeyTile) {
    const int tile = min(kKeyTile, m - j0);
    __syncthreads();  // the previous tile is consumed
    for (int k = threadIdx.x; k < 3 * tile; k += safe::kThreads) {
      keys[k] = table[3 * static_cast<int64_t>(j0) + k];
    }
    __syncthreads();
    for (int j = 0; j < tile; ++j) {
      const uint2 p = safe::threefry2x32(keys[3 * j], keys[3 * j + 1], ctr, 0u);
      if (keys[3 * j + 2] != 0u) {
        acc.x += p.x;
        acc.y += p.y;
      } else {
        acc.x -= p.x;
        acc.y -= p.y;
      }
    }
  }
  const int64_t i = 2 * pair;
  if (i >= n) return;
  safe::encode_add_pair(x, out, i, n, acc, scale, vec);
}

}  // namespace

// `table` is a device array [m, 3] of (k0, k1, 1 if the sign is > 0 else 0).
extern "C" int safe_bon_mask(const float* x, uint32_t* out, int64_t n,
                             const uint32_t* table, int64_t m, uint32_t base,
                             float scale, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n <= 0) return 0;
  if (m < 0 || m > 0x7FFFFFFF) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t blocks = (safe::pad_pairs(n, 0) + safe::kThreads - 1) / safe::kThreads;
  if (blocks > 0x7FFFFFFF) return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = safe::aligned8(x) && safe::aligned8(out);
  bon_mask_kernel<<<static_cast<unsigned>(blocks), safe::kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      x, out, n, table, static_cast<int>(m), base, scale, vec);
  return static_cast<int>(cudaGetLastError());
}
