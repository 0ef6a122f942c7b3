// w4a16: y[M, N] = x[M, K] @ W[K, N], W blockwise int4: q [K/2, N] int8
// holds two 4-bit codes per byte in split-half order (byte (i, n): row i in
// the low nibble, row i + K/2 in the high one), s [K/blk, N] bf16 holds one
// scale per (blk-row block, column).  x bf16 or f32, f32 out.
//
// Replaces the TPU kernel norma_tpu/ops/quant_matmul.py::w4_matmul_pallas
// (pl.pallas_call at :338, body _w4_kernel at :293): the int4 logits head
// (quantize_logits="int4"), run on every prefill and decode step.
//
// Arithmetic: this follows the JAX twin w4_matmul_jnp, not the TPU kernel.
// Each blk-row block's x . code sum is taken in f32 and multiplied by that
// block's f32 scale, and the blocks are summed; the TPU kernel instead
// pre-scales the weights in bf16 (w * s rounded to bf16) and feeds the MXU.
// So the gap to the plain PyTorch version (ops/quant_matmul.py::
// w4_matmul_torch) is f32 summation order only.
//
// What bounds it on the H100: bytes.  The packed head is 640 x 51866 B =
// 33 MB plus 2 MB of scales, ~10 us at 3.35 TB/s (the int8 head streams
// 66 MB, the bf16 one 133 MB); at the decode step's M <= 48 rows each byte
// meets at most 2 M multiply-adds.
//
// Design (wgemv.cuh): 16 packed bytes per thread and weight row (16
// columns, two contraction rows each), neighbouring lanes on neighbouring
// columns (one aligned load whatever the row's alignment), each byte read
// once per block of BM = 2 rows (at 4 rows the two f32 partials per row
// and column, 128 floats a thread, spilled and ran 1.4-2x slower on the
// H100); both nibbles become exact floats in
// registers by the 2^23 trick (no I2F).  Each warp owns exactly one packed block (blk
// packed rows, so one scale block of each half) and keeps its two f32
// partials (low and high half) apart until it multiplies each by its bf16
// scale widened to f32; the warps meet in a fixed-order tree, and packed
// blocks beyond one block's warps go to further blocks (gridDim.z) whose
// partials split_sum adds in order.  x lives in shared memory as f32.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "wgemv.cuh"

namespace {

using namespace norma::wgemv;

constexpr int U = 8;   // packed rows in flight per thread
constexpr int BM = 2;  // x rows per block

template <typename XT>
__global__ void __launch_bounds__(32 * MAX_WARPS) w4_kernel(
    const XT* __restrict__ x, const int8_t* __restrict__ q, const __nv_bfloat16* __restrict__ scale,
    float* __restrict__ out, float* __restrict__ ws, int M, int N, int K, int blk) {
  __shared__ __align__(16) float smem[SMEM_FLOATS];
  const int lane = threadIdx.x, warp = threadIdx.y, nw = blockDim.y;
  const int tid = warp * 32 + lane, nt = nw * 32;
  const int m0 = blockIdx.x * BM, c0 = blockIdx.y * BN;
  const int half = K / 2, npb = half / blk;
  const int pb0 = blockIdx.z * nw;  // this block's first packed block
  const int pitch = nw * blk;

  // x columns of the block's packed rows, both halves, as f32:
  // smem[h][r][i] = x[m0 + r, h * K/2 + pb0 * blk + i].
  for (int t = tid; t < 2 * BM * pitch; t += nt) {
    const int h = t / (BM * pitch), rem = t % (BM * pitch), r = rem / pitch, i = rem % pitch;
    const int k = pb0 * blk + i;
    smem[t] = (m0 + r < M && k < half) ? to_f(x[(size_t)(m0 + r) * K + h * half + k]) : 0.f;
  }
  __syncthreads();

  float lo[BM][CPT], hi[BM][CPT];
#pragma unroll
  for (int r = 0; r < BM; ++r)
#pragma unroll
    for (int j = 0; j < CPT; ++j) lo[r][j] = hi[r][j] = 0.f;

  // Every lane of a warp with a packed block runs the loop (the loads
  // shuffle across the warp); lane 31 and lanes past N accumulate bytes
  // that are never stored.
  const int pb = pb0 + warp;
  const int c = c0 + lane * CPT, ncol = lane < 31 ? N - c : 0;
  if (pb < npb) {  // warp-uniform
    const int8_t* seg = q + (size_t)pb * blk * N + c0;
    const int8_t* end = q + (size_t)half * N;
    const float* xlo = smem + warp * blk;
    const float* xhi = smem + BM * pitch + warp * blk;
    for (int i = 0; i < blk; i += U) {
      uint4 w[U];
#pragma unroll
      for (int u = 0; u < U; ++u) w[u] = load_chunk(seg + (size_t)min(i + u, blk - 1) * N, end, lane);
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (i + u < blk) {
          const uint4 b = align_chunk(w[u], seg + (size_t)(i + u) * N);
          float xl[BM], xh[BM];
#pragma unroll
          for (int r = 0; r < BM; ++r) {
            xl[r] = xlo[r * pitch + i + u];
            xh[r] = xhi[r * pitch + i + u];
          }
#pragma unroll
          for (int wi = 0; wi < 4; ++wi) {
            float cl[4], ch[4];
            s4x8(word_of(b, wi), cl, ch);
#pragma unroll
            for (int j = 0; j < 4; ++j)
#pragma unroll
              for (int r = 0; r < BM; ++r) {
                lo[r][4 * wi + j] = fmaf(xl[r], cl[j], lo[r][4 * wi + j]);
                hi[r][4 * wi + j] = fmaf(xh[r], ch[j], hi[r][4 * wi + j]);
              }
          }
        }
      }
    }
    // Each half's block sum times its scale (rows pb and npb + pb of s).
    const __nv_bfloat16* slo = scale + (size_t)pb * N + c;
    const __nv_bfloat16* shi = scale + (size_t)(npb + pb) * N + c;
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const float a = j < ncol ? __bfloat162float(slo[j]) : 0.f;
      const float b = j < ncol ? __bfloat162float(shi[j]) : 0.f;
#pragma unroll
      for (int r = 0; r < BM; ++r) lo[r][j] = lo[r][j] * a + hi[r][j] * b;
    }
  }
  __syncthreads();  // x tile no longer read: its memory becomes the tree's
  block_tree(lo, smem, warp, nw, lane);
  store_block<BM>(smem, nullptr, out, ws, M, N, m0, c0);
}

template <typename XT>
cudaError_t launch(const void* x, const void* q, const void* scale, void* out, void* ws, int M, int N,
                   int K, int blk, int splits, int warps, cudaStream_t stream) {
  dim3 grid;
  if (!grid_of(M, N, splits, BM, &grid)) return cudaErrorInvalidConfiguration;
  w4_kernel<XT><<<grid, dim3(32, warps), 0, stream>>>(
      (const XT*)x, (const int8_t*)q, (const __nv_bfloat16*)scale, (float*)out, (float*)ws, M, N, K, blk);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return e;
  return launch_split_sum((const float*)ws, nullptr, (float*)out, splits, M, N, stream);
}

}  // namespace

// x [M, K] (bf16 if is_bf16 else f32), q [K/2, N] int8 and scale [K/blk, N]
// bf16, all contiguous; out [M, N] f32.  blk divides K/2, and the K/2/blk
// packed blocks are exactly splits * warps (one per warp).  With splits > 1,
// ws holds splits * M * N f32.
extern "C" int norma_w4_matmul(const void* x, const void* q, const void* scale, void* out, void* ws,
                               int M, int N, int K, int blk, int splits, int warps, int is_bf16,
                               void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % 2 || blk < 1 || (K / 2) % blk || warps < 1 ||
      warps > MAX_WARPS || 2 * BM * warps * blk > XTILE || (long long)splits * warps != (K / 2) / blk ||
      (splits > 1 && ws == nullptr))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  return (int)(is_bf16 ? launch<__nv_bfloat16>(x, q, scale, out, ws, M, N, K, blk, splits, warps, s)
                       : launch<float>(x, q, scale, out, ws, M, N, K, blk, splits, warps, s));
}
