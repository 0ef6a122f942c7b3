// int8 x int8 -> int32 GEMM with per-row / per-column scales (w8a8).
//
// Replaces the TPU kernel norma_tpu/ops/quant_matmul.py::q8a8_dense_pallas
// (pl.pallas_call at :180, body _q8a8_kernel at :140): out[m, n] =
// float(sum_k xq[m, k] * wq[k, n]) * xs[m] * ws[n] (+ b[n]), f32 out, in
// that order of f32 operations (__fmul_rn / __fadd_rn keep nvcc from
// contracting them into an FMA, so the epilogue is bit-equal to the plain
// PyTorch version ops/quant_matmul.py::q8a8_dense_torch).  The int32
// accumulation is exact: |acc| <= K * 127^2 < 2^31 for K < 133,000.
//
// What bounds it on the H100: at the w8a8 encoder's shapes (M = B * 1500
// rows, K x N in {1280 x 3840, 1280 x 1280, 1280 x 5120, 5120 x 1280}) the
// product is compute-bound (~120 GOP for the fused QKV at B=8 against
// ~21 MB of operands), so tensor-core int8 throughput bounds it.
//
// Design: WMMA s8 16x16x16 fragments (mma.sync under the hood, int32
// accumulators), a 128 x 128 output tile per CTA of 8 warps (4 along M x 2
// along N, each warp 32 x 64 = 2 x 4 fragments), K in steps of 32.  WMMA
// loads need 32-byte aligned fragment pointers, so the shared tiles are
// kept as 16-byte-wide slabs: A as [k-half][row][16], B as
// [16-column block][k][16]; each thread stages exactly one 16-byte slab
// row of A and one of B per step, two buffers deep, with the next step's
// global loads issued before the current step's MMAs.  Rows beyond M and
// columns beyond N load zeros and are not stored.  The epilogue goes
// through a per-warp 16 x 16 int32 scratch in shared memory.  No wgmma or
// TMA yet: that is the later speed-up.
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int BM = 128, BN = 128, BK = 32;
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads) q8a8_kernel(
    const int8_t* __restrict__ xq, const float* __restrict__ xs,
    const int8_t* __restrict__ wq, const float* __restrict__ ws,
    const float* __restrict__ bias, float* __restrict__ out, int M, int N, int K) {
  __shared__ __align__(128) int8_t As[2][2][BM][16];       // [buf][k half][row][16]
  __shared__ __align__(128) int8_t Bs[2][BN / 16][BK][16];  // [buf][col block][k][16]
  __shared__ __align__(128) int scratch[kThreads / 32][16 * 16];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp >> 1, wn = warp & 1;  // warp tile: rows wm*32, cols wn*64
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  // This thread's slab rows: A row a_row, k half a_half; B k row b_k,
  // column block b_blk.
  const int a_row = tid >> 1, a_half = tid & 1;
  const int b_k = tid >> 3, b_blk = tid & 7;
  const bool a_ok = m0 + a_row < M;
  const bool b_ok = n0 + b_blk * 16 < N;
  const int8_t* a_src = xq + (size_t)(m0 + a_row) * K + a_half * 16;
  const int8_t* b_src = wq + (size_t)b_k * N + n0 + b_blk * 16;

  const int4 zero = make_int4(0, 0, 0, 0);
  int4 ra = a_ok ? *reinterpret_cast<const int4*>(a_src) : zero;
  int4 rb = b_ok ? *reinterpret_cast<const int4*>(b_src) : zero;
  *reinterpret_cast<int4*>(&As[0][a_half][a_row][0]) = ra;
  *reinterpret_cast<int4*>(&Bs[0][b_blk][b_k][0]) = rb;
  __syncthreads();

  wmma::fragment<wmma::accumulator, 16, 16, 16, int> acc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0);

  const int nk = K / BK;
  for (int kt = 0; kt < nk; ++kt) {
    const int buf = kt & 1;
    const bool more = kt + 1 < nk;
    if (more) {
      const size_t k1 = (size_t)(kt + 1) * BK;
      ra = a_ok ? *reinterpret_cast<const int4*>(a_src + k1) : zero;
      rb = b_ok ? *reinterpret_cast<const int4*>(b_src + k1 * N) : zero;
    }
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, signed char, wmma::row_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, signed char, wmma::row_major> fb[4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], &As[buf][kk][wm * 32 + i * 16][0], 16);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        wmma::load_matrix_sync(fb[j], &Bs[buf][wn * 4 + j][kk * 16][0], 16);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    if (more) {
      *reinterpret_cast<int4*>(&As[buf ^ 1][a_half][a_row][0]) = ra;
      *reinterpret_cast<int4*>(&Bs[buf ^ 1][b_blk][b_k][0]) = rb;
    }
    __syncthreads();
  }

  // Epilogue: acc * xs[m] * ws[n] (+ b[n]) in f32, one fragment at a time.
  int* sc = scratch[warp];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      wmma::store_matrix_sync(sc, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const int mb = m0 + wm * 32 + i * 16, nb = n0 + wn * 64 + j * 16;
#pragma unroll
      for (int e = lane; e < 256; e += 32) {
        const int m = mb + (e >> 4), n = nb + (e & 15);
        if (m < M && n < N) {
          float y = __fmul_rn(__fmul_rn(__int2float_rn(sc[e]), xs[m]), ws[n]);
          if (bias != nullptr) y = __fadd_rn(y, bias[n]);
          out[(size_t)m * N + n] = y;
        }
      }
      __syncwarp();
    }
  }
}

}  // namespace

extern "C" int norma_q8a8(const void* xq, const void* xs, const void* wq, const void* ws,
                          const void* bias, void* out, int M, int N, int K, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % BK || N % 16) return (int)cudaErrorInvalidValue;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  q8a8_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const int8_t*)xq, (const float*)xs, (const int8_t*)wq, (const float*)ws,
      (const float*)bias, (float*)out, M, N, K);
  return (int)cudaGetLastError();
}
