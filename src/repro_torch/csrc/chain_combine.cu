// Fused SAFE chain hop for Hopper (sm_90a): decrypt, add the local
// vector, re-encrypt, in one pass over device memory:
//
//     out = cipher - pad(k_in, base) + encode(x) + pad(k_out, base)  (mod 2^32)
//
// Replaces the Pallas kernels of src/repro/kernels/chain_combine.py:
//   chain_combine          (_chain_combine_kernel): one hop, the step each
//                          of the n-1 non-initiators of a ring takes;
//   chain_combine_batched  (_chain_combine_batched_kernel): S hops in one
//                          launch, row s under its own keys, counter base
//                          and start word — the multi-session engine's
//                          hop, and one step of the pipelined schedule
//                          (m segments, segment s's pads starting at word
//                          s * seg of the stream).
//
// What bounds it on an H100: per word it moves 12 bytes (cipher and x
// read, out written) and does about 77 operations (two 20-round
// Threefry-2x32 evaluations per two words, the encode's multiply and
// conversion, three ring adds). Issued at 128 lanes per SM per clock the
// operations take about two thirds of the time the traffic takes at
// 3.35 TB/s, so HBM bounds it. (On the 64 INT32 lanes alone the operations
// would bind; the kernel measured faster than that, because the compiler
// also issues integer adds on the FMA pipe.)
//
// Design: the pads never touch memory, and one thread per counter
// evaluates each cipher once for the two words it yields (the Pallas
// kernel evaluates it per word and keeps one lane, twice the integer
// work, which would make the ALUs bind). The two pads are folded into one
// (pad_out - pad_in; the ring is commutative). Pairs move as 8-byte
// accesses when they sit on an 8-byte boundary and as two words
// otherwise: with odd V every other row of [S, V] starts on an odd word,
// and an odd start word shifts every pair by one. Lone edge words are
// handled in threefry.cuh. The batched kernel puts the row on grid y and
// takes the rows' keys and counters in its parameters, up to 128 rows a
// launch; offsets s * V + i are 64-bit.
#include "threefry.cuh"

namespace {

__device__ __forceinline__ void hop_pair(
    const uint32_t* __restrict__ cipher, const float* __restrict__ x,
    uint32_t* __restrict__ out, int64_t i, int64_t n, uint32_t kin0,
    uint32_t kin1, uint32_t kout0, uint32_t kout1, uint32_t ctr, float scale,
    bool vec) {
  const uint2 pin = safe::threefry2x32(kin0, kin1, ctr, 0u);
  const uint2 pout = safe::threefry2x32(kout0, kout1, ctr, 0u);
  safe::combine_pair(cipher, x, out, i, n,
                     make_uint2(pout.x - pin.x, pout.y - pin.y), scale, vec);
}

__global__ void __launch_bounds__(safe::kThreads)
chain_combine_kernel(const uint32_t* __restrict__ cipher,
                     const float* __restrict__ x, uint32_t* __restrict__ out,
                     int64_t n, uint32_t kin0, uint32_t kin1, uint32_t kout0,
                     uint32_t kout1, uint32_t base, float scale, bool vec) {
  const int64_t pair = static_cast<int64_t>(blockIdx.x) * safe::kThreads + threadIdx.x;
  const int64_t i = 2 * pair;
  if (i >= n) return;
  hop_pair(cipher, x, out, i, n, kin0, kin1, kout0, kout1,
           base + static_cast<uint32_t>(pair), scale, vec);
}

// Rows of one launch: row s = (kin0, kin1, kout0, kout1, counter, lead),
// where counter and lead place the row's pads at their start word
// (threefry.cuh). The table travels by value in the kernel's parameters
// (the constant bank), as the Pallas kernel's rows travel by scalar
// prefetch: no device copy, no host-device transfer before the launch.
// __grid_constant__ lets a thread index it at its block's row without a
// per-thread copy. 128 rows x 6 words keep the parameters under 4 KiB.
constexpr int kMaxRows = 128;
constexpr int kRowWords = 6;
struct KeyRows {
  uint32_t w[kMaxRows * kRowWords];
};

__global__ void __launch_bounds__(safe::kThreads)
chain_combine_batched_kernel(const uint32_t* __restrict__ cipher,
                             const float* __restrict__ x,
                             uint32_t* __restrict__ out, int64_t n,
                             const __grid_constant__ KeyRows keys, float scale) {
  const uint32_t* t = keys.w + kRowWords * blockIdx.y;
  const int lead = static_cast<int>(t[5]);
  const int64_t pair = static_cast<int64_t>(blockIdx.x) * safe::kThreads + threadIdx.x;
  const int64_t i = 2 * pair - lead;
  if (i >= n) return;
  const int64_t row = static_cast<int64_t>(blockIdx.y) * n;
  const uint32_t* c_row = cipher + row;
  const float* x_row = x + row;
  uint32_t* o_row = out + row;
  const bool vec = safe::aligned8(c_row, lead) && safe::aligned8(x_row, lead) &&
                   safe::aligned8(o_row, lead);
  hop_pair(c_row, x_row, o_row, i, n, t[0], t[1], t[2], t[3],
           t[4] + static_cast<uint32_t>(pair), scale, vec);
}

int64_t grid_x(int64_t n, int lead) {
  return (safe::pad_pairs(n, lead) + safe::kThreads - 1) / safe::kThreads;
}

}  // namespace

extern "C" int safe_chain_combine(const uint32_t* cipher, const float* x,
                                  uint32_t* out, int64_t n, uint32_t kin0,
                                  uint32_t kin1, uint32_t kout0, uint32_t kout1,
                                  uint32_t base, float scale, int device,
                                  void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n <= 0) return 0;
  const int64_t blocks = grid_x(n, 0);
  if (blocks > 0x7FFFFFFF) return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = safe::aligned8(cipher) && safe::aligned8(x) && safe::aligned8(out);
  chain_combine_kernel<<<static_cast<unsigned>(blocks), safe::kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      cipher, x, out, n, kin0, kin1, kout0, kout1, base, scale, vec);
  return static_cast<int>(cudaGetLastError());
}

// `table` is a host array [rows, 6]; rows <= kMaxRows (the wrapper splits
// larger batches into several launches), and each lead is 0 or 1.
extern "C" int safe_chain_combine_batched(const uint32_t* cipher,
                                          const float* x, uint32_t* out,
                                          int64_t rows, int64_t n,
                                          const uint32_t* table, float scale,
                                          int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n <= 0 || rows <= 0) return 0;
  if (rows > kMaxRows) return static_cast<int>(cudaErrorInvalidValue);
  KeyRows keys;
  int lead = 0;
  for (int64_t k = 0; k < rows * kRowWords; ++k) keys.w[k] = table[k];
  for (int64_t r = 0; r < rows; ++r) {
    const uint32_t l = table[r * kRowWords + 5];
    if (l > 1) return static_cast<int>(cudaErrorInvalidValue);
    lead |= static_cast<int>(l);
  }
  const int64_t blocks = grid_x(n, lead);
  if (blocks > 0x7FFFFFFF) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(blocks), static_cast<unsigned>(rows));
  chain_combine_batched_kernel<<<grid, safe::kThreads, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
      cipher, x, out, n, keys, scale);
  return static_cast<int>(cudaGetLastError());
}
