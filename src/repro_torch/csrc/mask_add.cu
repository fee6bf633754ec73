// Fused fixed-point encode + Threefry pad add for Hopper (sm_90a):
//
//     out[i] = encode(x[i]) + pad(key, base)[start + i]   (mod 2^32)
//
// Replaces the Pallas kernel src/repro/kernels/threefry_mask_add.py
// (mask_add, _mask_add_kernel), whose pad starts at word 0 (start = 0
// here). It is the SAFE initiator's step: its outgoing hop pad, its
// private mask R (x = 0), and its unmask pad; the pipelined schedule
// starts segment s's hop pads at word s * seg of the edge's stream.
//
// What bounds it on an H100: per word it moves 8 bytes (x read, out
// written) and does about 39 operations (half a 20-round Threefry-2x32
// evaluation, the encode's multiply and conversion, the add). Issued at
// 128 lanes per SM per clock the operations take half the time the
// traffic takes at 3.35 TB/s, so HBM bounds it.
//
// Design: one thread per Threefry counter, writing both words the
// counter yields, so the cipher runs once per two words (the Pallas
// kernel runs it once per word and keeps one lane). The pair moves as
// one 8-byte access when it sits on an 8-byte boundary, and as two words
// otherwise. An odd start or an odd length leaves a lone word at an
// edge (threefry.cuh). Offsets are 64-bit.
#include "threefry.cuh"

namespace {

__global__ void __launch_bounds__(safe::kThreads)
mask_add_kernel(const float* __restrict__ x, uint32_t* __restrict__ out,
                int64_t n, uint32_t k0, uint32_t k1, uint32_t ctr0, int lead,
                float scale, bool vec) {
  const int64_t pair = static_cast<int64_t>(blockIdx.x) * safe::kThreads + threadIdx.x;
  const int64_t i = 2 * pair - lead;
  if (i >= n) return;
  const uint2 pad = safe::threefry2x32(k0, k1, ctr0 + static_cast<uint32_t>(pair), 0u);
  safe::encode_add_pair(x, out, i, n, pad, scale, vec);
}

}  // namespace

extern "C" int safe_mask_add(const float* x, uint32_t* out, int64_t n,
                             uint32_t k0, uint32_t k1, uint32_t base,
                             int64_t start, float scale, int device,
                             void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n <= 0) return 0;
  if (start < 0) return static_cast<int>(cudaErrorInvalidValue);
  const int lead = static_cast<int>(start & 1);
  const int64_t blocks = (safe::pad_pairs(n, lead) + safe::kThreads - 1) / safe::kThreads;
  if (blocks > 0x7FFFFFFF) return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = safe::aligned8(x, lead) && safe::aligned8(out, lead);
  mask_add_kernel<<<static_cast<unsigned>(blocks), safe::kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      x, out, n, k0, k1, safe::pad_counter(base, start), lead, scale, vec);
  return static_cast<int>(cudaGetLastError());
}
