// Threefry-2x32 keystream and fixed-point encode shared by the SAFE
// masking kernels (mask_add.cu, chain_combine.cu, bon_mask.cu).
//
// Word i of a pad is lane (i & 1) of Threefry2x32(key, (base + i/2, 0)),
// counters wrapping mod 2^32: the schedule of the JAX package's
// crypto/prf.py::keystream_pair_lanes. One thread evaluates one counter
// and owns the two words it yields, so no keystream word is computed
// twice (the Pallas kernels evaluate the whole block per word and keep
// one lane).
//
// A pad may start at any word `start` of that stream (the pipelined
// schedule's segment s starts at word s * seg). Its word i is stream word
// start + i, so thread p evaluates counter base + start / 2 + p
// (`pad_counter`) and owns output words i = 2p - lead and i + 1, where
// lead = start & 1: with an odd start the first thread keeps only lane 1
// (i = -1 is not a word), and every pair sits one word earlier.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace safe {

constexpr int kThreads = 256;

__device__ __forceinline__ uint32_t rotl32(uint32_t x, int d) {
  return __funnelshift_l(x, x, d);
}

template <int R0, int R1, int R2, int R3>
__device__ __forceinline__ void mix4(uint32_t& x0, uint32_t& x1) {
  x0 += x1; x1 = rotl32(x1, R0); x1 ^= x0;
  x0 += x1; x1 = rotl32(x1, R1); x1 ^= x0;
  x0 += x1; x1 = rotl32(x1, R2); x1 ^= x0;
  x0 += x1; x1 = rotl32(x1, R3); x1 ^= x0;
}

// Threefry-2x32, 20 rounds: rotations (13,15,26,6)/(17,29,16,24), key
// injection after every 4 rounds with parity constant 0x1BD11BDA.
__device__ __forceinline__ uint2 threefry2x32(uint32_t k0, uint32_t k1,
                                              uint32_t c0, uint32_t c1) {
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
  uint32_t x0 = c0 + k0;
  uint32_t x1 = c1 + k1;
  mix4<13, 15, 26, 6>(x0, x1);  x0 += k1; x1 += k2 + 1u;
  mix4<17, 29, 16, 24>(x0, x1); x0 += k2; x1 += k0 + 2u;
  mix4<13, 15, 26, 6>(x0, x1);  x0 += k0; x1 += k1 + 3u;
  mix4<17, 29, 16, 24>(x0, x1); x0 += k1; x1 += k2 + 4u;
  mix4<13, 15, 26, 6>(x0, x1);  x0 += k2; x1 += k0 + 5u;
  return make_uint2(x0, x1);
}

// Counter of thread 0 of a pad that starts at stream word `start`.
__host__ __device__ inline uint32_t pad_counter(uint32_t base, int64_t start) {
  return base + static_cast<uint32_t>(static_cast<uint64_t>(start) >> 1);
}

// Threads a pad of n words starting on lane `lead` needs.
__host__ __device__ inline int64_t pad_pairs(int64_t n, int lead) {
  return (n + lead + 1) / 2;
}

// f32 -> uint32 ring element: round half to even of x * 2^scale_bits as
// int32 (exact inside the codec's max_abs_value; saturates outside it).
__device__ __forceinline__ uint32_t encode(float x, float scale) {
  return static_cast<uint32_t>(__float2int_rn(__fmul_rn(x, scale)));
}

// A word pair at word index i. `vec` says whether the pair sits on an
// 8-byte boundary: a row of an [S, V] tensor with odd V, a slice, or an
// odd start may put it on an odd word, and then it is moved as two words.
__device__ __forceinline__ float2 load_pair(const float* p, bool vec) {
  if (vec) return *reinterpret_cast<const float2*>(p);
  return make_float2(p[0], p[1]);
}

__device__ __forceinline__ uint2 load_pair(const uint32_t* p, bool vec) {
  if (vec) return *reinterpret_cast<const uint2*>(p);
  return make_uint2(p[0], p[1]);
}

__device__ __forceinline__ void store_pair(uint32_t* p, uint2 v, bool vec) {
  if (vec) {
    *reinterpret_cast<uint2*>(p) = v;
  } else {
    p[0] = v.x;
    p[1] = v.y;
  }
}

// out = encode(x) + pad over the words i, i + 1 a thread owns (i < n is
// the caller's check). A whole pair moves together; at the edges a lone
// word takes lane 0 (i = n - 1) or lane 1 (i = -1).
__device__ __forceinline__ void encode_add_pair(
    const float* __restrict__ x, uint32_t* __restrict__ out, int64_t i,
    int64_t n, uint2 pad, float scale, bool vec) {
  if (i >= 0 && i + 1 < n) {
    const float2 xv = load_pair(x + i, vec);
    store_pair(out + i, make_uint2(encode(xv.x, scale) + pad.x,
                                   encode(xv.y, scale) + pad.y), vec);
  } else if (i >= 0) {
    out[i] = encode(x[i], scale) + pad.x;
  } else {
    out[0] = encode(x[0], scale) + pad.y;
  }
}

// out = cipher + encode(x) + pad over the words i, i + 1, as above.
__device__ __forceinline__ void combine_pair(
    const uint32_t* __restrict__ cipher, const float* __restrict__ x,
    uint32_t* __restrict__ out, int64_t i, int64_t n, uint2 pad, float scale,
    bool vec) {
  if (i >= 0 && i + 1 < n) {
    const uint2 c = load_pair(cipher + i, vec);
    const float2 xv = load_pair(x + i, vec);
    store_pair(out + i, make_uint2(c.x + encode(xv.x, scale) + pad.x,
                                   c.y + encode(xv.y, scale) + pad.y), vec);
  } else if (i >= 0) {
    out[i] = cipher[i] + encode(x[i], scale) + pad.x;
  } else {
    out[0] = cipher[0] + encode(x[0], scale) + pad.y;
  }
}

// Whether pairs at words -lead, 2 - lead, ... of `p` are 8-byte aligned.
__host__ __device__ inline bool aligned8(const void* p, int lead = 0) {
  return ((reinterpret_cast<uintptr_t>(p) - 4u * static_cast<unsigned>(lead)) & 7u) == 0;
}

}  // namespace safe

extern "C" const char* safe_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
