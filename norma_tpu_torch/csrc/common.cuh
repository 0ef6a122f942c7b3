// Shared device helpers for the norma_tpu_torch kernels: warp/block
// reductions and the counter-based Philox4x32-10 generator.
#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace norma {

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Block-wide reductions: every thread gets the result.  `sh` holds >= 32
// entries of shared scratch; blockDim.x is a multiple of 32.
__device__ __forceinline__ float block_sum(float v, float* sh) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5, nw = blockDim.x >> 5;
  v = warp_sum(v);
  __syncthreads();
  if (lane == 0) sh[w] = v;
  __syncthreads();
  if (w == 0) {
    v = warp_sum(lane < nw ? sh[lane] : 0.f);
    if (lane == 0) sh[0] = v;
  }
  __syncthreads();
  return sh[0];
}

__device__ __forceinline__ float block_max(float v, float* sh) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5, nw = blockDim.x >> 5;
  v = warp_max(v);
  __syncthreads();
  if (lane == 0) sh[w] = v;
  __syncthreads();
  if (w == 0) {
    v = warp_max(lane < nw ? sh[lane] : -CUDART_INF_F);
    if (lane == 0) sh[0] = v;
  }
  __syncthreads();
  return sh[0];
}

// A thread-block cluster's barrier split in two: every thread arrives, and
// later waits for the whole cluster's arrivals.  A kernel that writes into
// another CTA's shared memory before any cluster.sync() arrives on entry and
// waits before that first write, so every CTA of the cluster has started.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() { asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory"); }

// Arg-max with the first-index tie rule: (key, idx) pairs, larger key wins,
// equal keys keep the smaller index.  Keys must not be NaN.
__device__ __forceinline__ void argmax_combine(float& k, int& i, float k2, int i2) {
  if (k2 > k || (k2 == k && i2 < i)) {
    k = k2;
    i = i2;
  }
}

// Philox4x32-10 (Salmon et al., SC'11): 128 random bits per (counter, key).
__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint2 k) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const uint32_t lo0 = 0xD2511F53u * c.x, hi0 = __umulhi(0xD2511F53u, c.x);
    const uint32_t lo1 = 0xCD9E8D57u * c.z, hi1 = __umulhi(0xCD9E8D57u, c.z);
    c = make_uint4(hi1 ^ c.y ^ k.x, lo1, hi0 ^ c.w ^ k.y, lo0);
    k.x += 0x9E3779B9u;
    k.y += 0xBB67AE85u;
  }
  return c;
}

// 32 random bits -> uniform in [1e-12, 1): the top 23 bits scaled by 2^-23,
// clamped away from 0 so -log(u) stays finite.
__device__ __forceinline__ float uniform_from_bits(uint32_t bits) {
  return fmaxf((float)(bits >> 9) * (1.0f / 8388608.0f), 1e-12f);
}

__device__ __forceinline__ uint32_t word(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

}  // namespace norma
