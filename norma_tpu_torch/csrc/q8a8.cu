// int8 x int8 -> int32 GEMM with per-row / per-column scales (w8a8).
//
// Replaces the TPU kernel norma_tpu/ops/quant_matmul.py::q8a8_dense_pallas
// (pl.pallas_call at :180, body _q8a8_kernel at :140): out[m, n] =
// float(sum_k xq[m, k] * wq[k, n]) * xs[m] * ws[n] (+ b[n]), in that order
// of f32 operations (__fmul_rn / __fadd_rn keep nvcc from contracting them
// into an FMA, so the epilogue is bit-equal to the plain PyTorch version
// ops/quant_matmul.py::q8a8_dense_torch), then stored as f32 or rounded
// once to bf16 (bit-equal to the f32 result's .to(bf16)).  The int32
// accumulation is exact: |acc| <= K * 127^2 < 2^31 for K < 133,000.
//
// What bounds it on the H100: at the w8a8 encoder's shapes (M = B * 1500
// rows, K x N in {1280 x 3840, 1280 x 1280, 1280 x 5120, 5120 x 1280}) the
// f32 output's bytes and the int8 tensor-core rate are of one size (M =
// 12000, 1280 x 3840: 205 MB, 0.061 ms at 3.35 TB/s; 118 GOP, 0.060 ms at
// 1979 TOP/s); a bf16 output halves the bytes.
//
// Design (Hopper): s8 wgmma needs BOTH operands K-major, so the weight
// codes arrive as [N, K] storage (the [K, N] view the model holds has
// strides (1, K); DecodeEngine holds such copies of the encoder's codes,
// model/quant.py::prep_encoder_q8_kernel, and the wrapper copies codes in
// another layout for the call).  A CTA of 288 threads computes a
// 128 x BN output tile (BN = 128, or 64 when 128-wide tiles give the card
// fewer than two waves): two consumer warpgroups of 64 rows and one
// producer warp.  The producer streams 128-byte-deep K slices of A
// (activation codes [M, K]) and B (weight codes [N, K]) by TMA (128B
// swizzle; rows >= M read as zeros) into a 4-stage ring with full / empty
// mbarriers; each consumer runs four wgmma m64nBNk32 .s32.s8.s8 per slice,
// keeping one slice's group in flight while it releases the previous
// slice.  The epilogue runs on the accumulator registers: each thread
// scales its pairs of columns and stores them as float2 (or bf16x2).
//
// Tails (tensor-parallel shards: distil-large-v3's fused QKV at tp=4 has
// N = 960, o_proj's row shard K = 320): K and N need only be multiples of
// 64.  A K tail slice reads past K as zeros (TMA fills a box's
// out-of-bounds elements with zeros and still counts the box's bytes), so
// its products add nothing; a last column tile past N loads zero weight
// rows the same way and its epilogue stores nothing at n >= N.  No
// padding copy, no second kernel.  (A `continue` past N in the epilogue
// kept the compiler from hoisting its loads: 11-22% slower at M = 12000,
// NVIDIA H100 80GB HBM3, chip_smoke phase 8.)
#include <cuda_bf16.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace norma::hopper;

constexpr int BM = 128, BKB = 128, STAGES = 4, kConsumers = 256, kThreads = kConsumers + 32;

template <int BN>
constexpr size_t smem_bytes() {
  return 1024 + (size_t)STAGES * (BM + BN) * BKB + 2 * STAGES * sizeof(uint64_t);
}

template <int BN>
__device__ __forceinline__ void wgmma_s8(int (&acc)[BN / 2], uint64_t da, uint64_t db) {
  if constexpr (BN == 128)
    wgmma_m64n128k32_s8_ss(acc, da, db, 1);
  else
    wgmma_m64n64k32_s8_ss(acc, da, db, 1);
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

template <int BN, typename OutT>
__global__ void __launch_bounds__(kThreads, 1) q8a8_wgmma_kernel(
    const __grid_constant__ CUtensorMap amap, const __grid_constant__ CUtensorMap bmap,
    const float* __restrict__ xs, const float* __restrict__ ws, const float* __restrict__ bias,
    OutT* __restrict__ out, int M, int N, int K) {
  constexpr int kABytes = BM * BKB, kBBytes = BN * BKB, kStageBytes = kABytes + kBBytes;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + STAGES * kStageBytes);
  uint64_t* empty = full + STAGES;

  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN, nk = (K + BKB - 1) / BKB;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (warp == kConsumers / 32) {
    // Producer warp: one thread keeps up to STAGES slices in flight.
    if (lane == 0) {
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % STAGES;
        if (kt >= STAGES) mbar_wait(&empty[s], ((kt / STAGES) - 1) & 1);
        uint8_t* st = smem + s * kStageBytes;
        mbar_expect_tx(&full[s], kStageBytes);
        tma_load_2d(st, &amap, &full[s], kt * BKB, m0);
        tma_load_2d(st + kABytes, &bmap, &full[s], kt * BKB, n0);
      }
    }
    return;
  }

  // Consumer warpgroup wg: output rows wg*64 .. +63 of the tile.
  const int wg = warp >> 2;
  int acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0;

  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt % STAGES;
    mbar_wait(&full[s], (kt / STAGES) & 1);
    const uint8_t* st = smem + s * kStageBytes;
    const uint64_t da = smem_desc(st + wg * 64 * BKB, 16, 1024);
    const uint64_t db = smem_desc(st + kABytes, 16, 1024);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BKB / 32; ++kk) wgmma_s8<BN>(acc, da + 2 * kk, db + 2 * kk);
    wgmma_commit();
    wgmma_wait<1>();  // the previous slice's products are done: release it
    if (kt > 0) mbar_arrive(&empty[(kt - 1) % STAGES]);
  }
  wgmma_wait<0>();
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) fence_reg(acc[i]);

  // acc[4j + e]: row ra (+ 8 for e >= 2), column 8j + 2 (lane % 4) + (e & 1).
  const int ra = m0 + wg * 64 + (warp & 3) * 16 + (lane >> 2), rb = ra + 8;
  const float xa = ra < M ? xs[ra] : 0.f, xb = rb < M ? xs[rb] : 0.f;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    // A tail tile's columns past N read column N - 2's scales and bias
    // (loads stay unconditional, so the compiler keeps them ahead of the
    // stores) and store nothing; N is even, so n < N means n + 1 < N.
    const int n = n0 + 8 * j + 2 * (lane & 3), nl = n < N ? n : N - 2;
    const float w0 = ws[nl], w1 = ws[nl + 1];
    float y[4] = {__fmul_rn(__fmul_rn(__int2float_rn(acc[4 * j]), xa), w0),
                  __fmul_rn(__fmul_rn(__int2float_rn(acc[4 * j + 1]), xa), w1),
                  __fmul_rn(__fmul_rn(__int2float_rn(acc[4 * j + 2]), xb), w0),
                  __fmul_rn(__fmul_rn(__int2float_rn(acc[4 * j + 3]), xb), w1)};
    if (bias != nullptr) {
      const float b0 = bias[nl], b1 = bias[nl + 1];
      y[0] = __fadd_rn(y[0], b0);
      y[1] = __fadd_rn(y[1], b1);
      y[2] = __fadd_rn(y[2], b0);
      y[3] = __fadd_rn(y[3], b1);
    }
    if (ra < M && n < N) store2(out + (size_t)ra * N + n, y[0], y[1]);
    if (rb < M && n < N) store2(out + (size_t)rb * N + n, y[2], y[3]);
  }
}

template <int BN, typename OutT>
int launch(const void* xq, const void* xs, const void* wq, const void* ws, const void* bias, void* out,
           int M, int N, int K, cudaStream_t stream) {
  CUtensorMap amap, bmap;
  const uint64_t a_dims[2] = {(uint64_t)K, (uint64_t)M}, b_dims[2] = {(uint64_t)K, (uint64_t)N};
  const uint64_t stride[1] = {(uint64_t)K};
  const uint32_t a_box[2] = {BKB, BM}, b_box[2] = {BKB, BN};
  int e = encode_tensor_map(&amap, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, xq, a_dims, stride, a_box);
  if (e) return e;
  e = encode_tensor_map(&bmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, wq, b_dims, stride, b_box);
  if (e) return e;
  auto kern = q8a8_wgmma_kernel<BN, OutT>;
  const cudaError_t c =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_bytes<BN>());
  if (c != cudaSuccess) return (int)c;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  kern<<<grid, kThreads, smem_bytes<BN>(), stream>>>(amap, bmap, (const float*)xs, (const float*)ws,
                                                     (const float*)bias, (OutT*)out, M, N, K);
  return (int)cudaGetLastError();
}

}  // namespace

// wq: the weight codes as [N, K] storage (K-major).  bn: the output tile's
// width (128 or 64; ops/quant_matmul.py::q8a8_plan picks it).  K and N are
// multiples of 64.
extern "C" int norma_q8a8(const void* xq, const void* xs, const void* wq, const void* ws,
                          const void* bias, void* out, int M, int N, int K, int bn, int out_bf16,
                          void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % 64 || N % 64 || (bn != 64 && bn != 128))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (bn == 128)
    return out_bf16 ? launch<128, __nv_bfloat16>(xq, xs, wq, ws, bias, out, M, N, K, s)
                    : launch<128, float>(xq, xs, wq, ws, bias, out, M, N, K, s);
  return out_bf16 ? launch<64, __nv_bfloat16>(xq, xs, wq, ws, bias, out, M, N, K, s)
                  : launch<64, float>(xq, xs, wq, ws, bias, out, M, N, K, s);
}
