// w8a16: y[M, N] = (x[M, K] @ q[K, N]) * s[N], int8 weights with one f32
// scale per output column, x bf16 or f32, f32 out.
//
// Replaces the TPU kernel norma_tpu/ops/quant_matmul.py::w8_matmul_pallas
// (pl.pallas_call at :75, body _w8_kernel at :45), which widens int8 tiles
// to bf16 in VMEM and runs the MXU.  Here it serves the int8 decoder layers
// (model/whisper.py::ldense / qkv_proj) and the int8 logits head on every
// decode step, where the plain PyTorch route first writes a bf16 copy of
// each weight to device memory.
//
// What bounds it on the H100: the decode step has M <= 48 rows (6 at one
// stream), so each weight byte meets at most M multiply-adds: the product
// is bound by the int8 bytes streamed from device memory (1.6-6.6 MB per
// decoder matrix, 66 MB for the [1280, 51866] head; ~20 us for the head
// at 3.35 TB/s).
//
// Design (wgemv.cuh): each weight byte is read once per block of BM rows
// (2 up to M = 2, else 4: the wrapper's choice), 16 bytes per thread with neighbouring lanes on neighbouring
// columns (one aligned load whatever the row's alignment); codes become
// floats exactly by the 2^23 trick, not by I2F; x lives in shared memory
// as f32; products accumulate in f32 registers (bf16 x int8 products are
// exact in f32); the warps of a
// block split the contraction and meet in a fixed-order tree; when the
// block grid alone would not fill the card, the contraction is split over
// blocks too (the wrapper's plan) and split_sum adds the partials in order
// and applies the scale.  Every M is correct: rows are tiled by BM and the
// contraction by the wrapper's chunks.  CUDA cores, no tensor cores, no
// TMA yet.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "wgemv.cuh"

namespace {

using namespace norma::wgemv;

constexpr int U = 8;  // weight rows in flight per thread

template <typename XT, int BM>
__global__ void __launch_bounds__(32 * MAX_WARPS) w8_kernel(
    const XT* __restrict__ x, const int8_t* __restrict__ q, const float* __restrict__ scale,
    float* __restrict__ out, float* __restrict__ ws, int M, int N, int K, int kchunk) {
  __shared__ __align__(16) float smem[SMEM_FLOATS];
  const int lane = threadIdx.x, warp = threadIdx.y, nw = blockDim.y;
  const int tid = warp * 32 + lane, nt = nw * 32;
  const int m0 = blockIdx.x * BM, c0 = blockIdx.y * BN;
  const int pitch = nw * kchunk;                     // k rows of this block's x tile
  const int kb = blockIdx.z * pitch;                 // its first k
  const int kspan = min(pitch, K - kb);

  // x[m0 : m0 + BM, kb : kb + kspan] as f32, zeros outside.
  for (int i = tid; i < BM * pitch; i += nt) {
    const int r = i / pitch, kk = i % pitch;
    smem[i] = (m0 + r < M && kk < kspan) ? to_f(x[(size_t)(m0 + r) * K + kb + kk]) : 0.f;
  }
  __syncthreads();

  float acc[BM][CPT];
#pragma unroll
  for (int r = 0; r < BM; ++r)
#pragma unroll
    for (int j = 0; j < CPT; ++j) acc[r][j] = 0.f;

  // Every lane runs the loop (the loads shuffle across the warp); lane 31
  // and lanes past N accumulate bytes that are never stored.  A short last
  // step re-reads its last row instead of branching around the loads.
  const int k_lo = warp * kchunk, k_hi = min(k_lo + kchunk, kspan);
  const int8_t* seg = q + (size_t)kb * N + c0;
  const int8_t* end = q + (size_t)K * N;
  for (int kk = k_lo; kk < k_hi; kk += U) {
    uint4 w[U];
#pragma unroll
    for (int u = 0; u < U; ++u) w[u] = load_chunk(seg + (size_t)min(kk + u, k_hi - 1) * N, end, lane);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (kk + u < k_hi) {
        const uint4 b = align_chunk(w[u], seg + (size_t)(kk + u) * N);
        float xv[BM];
#pragma unroll
        for (int r = 0; r < BM; ++r) xv[r] = smem[r * pitch + kk + u];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float wf[4];
          s8x4(word_of(b, i), wf);
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int r = 0; r < BM; ++r) acc[r][4 * i + j] = fmaf(xv[r], wf[j], acc[r][4 * i + j]);
        }
      }
    }
  }
  __syncthreads();  // x tile no longer read: its memory becomes the tree's
  block_tree(acc, smem, warp, nw, lane);
  store_block<BM>(smem, scale, out, ws, M, N, m0, c0);
}

template <typename XT, int BM>
cudaError_t launch(const void* x, const void* q, const void* scale, void* out, void* ws, int M, int N,
                   int K, int splits, int warps, int kchunk, cudaStream_t stream) {
  dim3 grid;
  if (!grid_of(M, N, splits, BM, &grid)) return cudaErrorInvalidConfiguration;
  w8_kernel<XT, BM><<<grid, dim3(32, warps), 0, stream>>>(
      (const XT*)x, (const int8_t*)q, (const float*)scale, (float*)out, (float*)ws, M, N, K, kchunk);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return e;
  return launch_split_sum((const float*)ws, (const float*)scale, (float*)out, splits, M, N, stream);
}

template <int BM>
cudaError_t launch_bm(int is_bf16, const void* x, const void* q, const void* scale, void* out, void* ws,
                      int M, int N, int K, int splits, int warps, int kchunk, cudaStream_t s) {
  return is_bf16 ? launch<__nv_bfloat16, BM>(x, q, scale, out, ws, M, N, K, splits, warps, kchunk, s)
                 : launch<float, BM>(x, q, scale, out, ws, M, N, K, splits, warps, kchunk, s);
}

}  // namespace

// x [M, K] (bf16 if is_bf16 else f32) and q [K, N] int8 contiguous, scale
// [N] f32; out [M, N] f32.  bm (2 or 4) is the row tile; splits * warps *
// kchunk must cover K; with splits > 1, ws holds splits * M * N f32.
extern "C" int norma_w8_matmul(const void* x, const void* q, const void* scale, void* out, void* ws,
                               int M, int N, int K, int splits, int warps, int kchunk, int bm, int is_bf16,
                               void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || warps < 1 || warps > MAX_WARPS || kchunk < 1 || (bm != 2 && bm != 4) ||
      bm * warps * kchunk > XTILE || (long long)splits * warps * kchunk < K || (splits > 1 && ws == nullptr))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  return (int)(bm == 2 ? launch_bm<2>(is_bf16, x, q, scale, out, ws, M, N, K, splits, warps, kchunk, s)
                       : launch_bm<4>(is_bf16, x, q, scale, out, ws, M, N, K, splits, warps, kchunk, s));
}
