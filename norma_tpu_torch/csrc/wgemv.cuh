// The weight-streaming pieces of w4_matmul.cu: y[M, N] = x[M, K] @ W[K, N]
// with few rows M and a large integer weight that is read from device
// memory once per row tile.
//
// Block shape: BM rows of x (a template parameter of the kernels, at most
// MAX_BM) by BN = 31 * CPT output columns; lane l < 31
// of every warp owns columns c0 + l * CPT .. + CPT, and each lane loads one
// aligned 16-byte chunk per weight row (lane 31 only loads), so a warp
// reads ~512 contiguous bytes of a row.  The warps of a block split the
// contraction; their sums meet in a
// fixed-order tree through shared memory (deterministic), and blocks that
// split the contraction further (gridDim.z > 1) write f32 partials that
// split_sum adds in order.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace norma {
namespace wgemv {

constexpr int MAX_BM = 4;        // most x rows per block
constexpr int CPT = 16;          // output columns per thread: one 16-byte load
constexpr int BN = 31 * CPT;     // output columns per block (lane 31 only loads)
constexpr int MAX_WARPS = 8;
constexpr int XTILE = 8192;      // floats of staged x per block (32 KB)
constexpr int RED_PITCH = 33;    // [r][j][lane] slots, padded against bank conflicts
constexpr int MAX_SLOT = MAX_BM * CPT * RED_PITCH;  // floats of one warp's partials
constexpr int SMEM_FLOATS = (XTILE > (MAX_WARPS / 2) * MAX_SLOT) ? XTILE : (MAX_WARPS / 2) * MAX_SLOT;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

// Bytes 4 * O + bs / 8 .. + 16 of the 32 bytes in w.
template <int O>
__device__ __forceinline__ uint4 funnel(const uint32_t (&w)[8], uint32_t bs) {
  return make_uint4(__funnelshift_r(w[O], w[O + 1], bs), __funnelshift_r(w[O + 1], w[O + 2], bs),
                    __funnelshift_r(w[O + 2], w[O + 3], bs), __funnelshift_r(w[O + 3], w[O + 4], bs));
}

// A weight row's bytes for the warp's columns, in two stages so that a
// thread can have many rows' loads in flight before it waits on any.  The
// rows need not be 16-byte aligned (the logits head has N = 51866
// columns): stage 1 loads, per lane, the aligned 16-byte chunk at its
// position in the aligned-down segment; stage 2 gives lane l < 31 the 16
// bytes at seg + 16 * l from its own chunk and lane l + 1's (a shuffle and
// a funnel shift).  Chunks that start at or past `end` read as zeros; one
// that starts before `end` may read up to 15 bytes past it, which stays
// inside PyTorch's CUDA allocations (their sizes are rounded up to 512
// bytes).
__device__ __forceinline__ uint4 load_chunk(const int8_t* seg, const int8_t* end, int lane) {
  const int8_t* p = seg - (reinterpret_cast<uintptr_t>(seg) & 15) + 16 * lane;
  return p < end ? __ldg(reinterpret_cast<const uint4*>(p)) : make_uint4(0u, 0u, 0u, 0u);
}

// Stage 2; all 32 lanes must call it with the same seg.
__device__ __forceinline__ uint4 align_chunk(const uint4& v, const int8_t* seg) {
  const int off = (int)(reinterpret_cast<uintptr_t>(seg) & 15);
  const uint32_t w[8] = {v.x, v.y, v.z, v.w, __shfl_down_sync(0xffffffffu, v.x, 1),
                         __shfl_down_sync(0xffffffffu, v.y, 1), __shfl_down_sync(0xffffffffu, v.z, 1),
                         __shfl_down_sync(0xffffffffu, v.w, 1)};
  const uint32_t bs = 8u * (off & 3);
  switch (off >> 2) {  // warp-uniform; constant indices keep w in registers
    case 0: return funnel<0>(w, bs);
    case 1: return funnel<1>(w, bs);
    case 2: return funnel<2>(w, bs);
    default: return funnel<3>(w, bs);
  }
}

// Exact int -> float without the (quarter-rate) I2F: 2^23 + m as bits
// 0x4B0000mm, minus 2^23 + bias, in one PRMT and one FADD per value.
// Eight signed 4-bit codes in w: the low nibbles of its bytes to lo, the
// high nibbles to hi; m = nibble ^ 8, bias 8.
__device__ __forceinline__ void s4x8(uint32_t w, float (&lo)[4], float (&hi)[4]) {
  const uint32_t t = w ^ 0x88888888u;
  const uint32_t l = t & 0x0f0f0f0fu, h = (t >> 4) & 0x0f0f0f0fu;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    lo[i] = __uint_as_float(__byte_perm(l, 0x4B000000u, 0x7440u + i)) - 8388616.0f;
    hi[i] = __uint_as_float(__byte_perm(h, 0x4B000000u, 0x7440u + i)) - 8388616.0f;
  }
}

__device__ __forceinline__ uint32_t word_of(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

template <int BM>
__device__ __forceinline__ void slot_store(float* slot, const float (&acc)[BM][CPT], int lane) {
#pragma unroll
  for (int r = 0; r < BM; ++r)
#pragma unroll
    for (int j = 0; j < CPT; ++j) slot[(r * CPT + j) * RED_PITCH + lane] = acc[r][j];
}

template <int BM>
__device__ __forceinline__ void slot_add(const float* slot, float (&acc)[BM][CPT], int lane) {
#pragma unroll
  for (int r = 0; r < BM; ++r)
#pragma unroll
    for (int j = 0; j < CPT; ++j) acc[r][j] += slot[(r * CPT + j) * RED_PITCH + lane];
}

// Sum every warp's acc through a fixed tree; slot 0 of `red` then holds the
// block's total.  Call after a __syncthreads() that ends all other use of
// `red`'s memory; returns synchronised.
template <int BM>
__device__ __forceinline__ void block_tree(float (&acc)[BM][CPT], float* red, int warp, int nwarps,
                                           int lane) {
  constexpr int SLOT = BM * CPT * RED_PITCH;
  int cur = nwarps;
  while (cur > 1) {
    const int h = (cur + 1) >> 1;
    if (warp >= h && warp < cur) slot_store(red + (warp - h) * SLOT, acc, lane);
    __syncthreads();
    if (warp < cur - h) slot_add(red + warp * SLOT, acc, lane);
    __syncthreads();
    cur = h;
  }
  if (warp == 0) slot_store(red, acc, lane);
  __syncthreads();
}

// Write the block total (slot 0) coalesced: the result times scale[n]
// (when given) to out, or, when the contraction is split over blocks, the
// partial to ws[blockIdx.z].
template <int BM>
__device__ __forceinline__ void store_block(const float* red, const float* scale, float* out, float* ws,
                                            int M, int N, int m0, int c0) {
  const int nt = blockDim.x * blockDim.y, tid = threadIdx.y * blockDim.x + threadIdx.x;
  for (int i = tid; i < BM * BN; i += nt) {
    const int r = i / BN, col = i % BN, m = m0 + r, n = c0 + col;
    if (m >= M || n >= N) continue;
    const float v = red[(r * CPT + col % CPT) * RED_PITCH + col / CPT];
    if (gridDim.z == 1) {
      out[(size_t)m * N + n] = scale != nullptr ? v * scale[n] : v;
    } else {
      ws[((size_t)blockIdx.z * M + m) * N + n] = v;
    }
  }
}

// out[i] = sum_z ws[z][i] (in z order), times scale[i % N] when given.
// static: each .cu that includes this header gets its own copy.
static __global__ void split_sum(const float* __restrict__ ws, const float* __restrict__ scale,
                                 float* __restrict__ out, int splits, long long MN, int N) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= MN) return;
  float v = 0.f;
  for (int z = 0; z < splits; ++z) v += ws[z * MN + i];
  out[i] = scale != nullptr ? v * scale[i % N] : v;
}

static inline cudaError_t launch_split_sum(const float* ws, const float* scale, float* out, int splits,
                                           int M, int N, cudaStream_t stream) {
  const long long MN = (long long)M * N;
  split_sum<<<(unsigned)((MN + 255) / 256), 256, 0, stream>>>(ws, scale, out, splits, MN, N);
  return cudaGetLastError();
}

// Grid of a launch: x = row tiles (fastest, so the row tiles of one column
// tile run together and share its weight bytes in L2), y = column tiles,
// z = contraction splits.
inline bool grid_of(int M, int N, int splits, int BM, dim3* grid) {
  const long long gx = (M + BM - 1) / BM, gy = (N + BN - 1) / BN;
  if (gx > 0x7fffffffLL || gy > 65535 || splits < 1 || splits > 65535) return false;
  *grid = dim3((unsigned)gx, (unsigned)gy, (unsigned)splits);
  return true;
}

}  // namespace wgemv
}  // namespace norma
