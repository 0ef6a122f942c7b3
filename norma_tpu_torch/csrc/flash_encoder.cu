// Non-causal multi-head self-attention for the encoder, flash style.
//
// Replaces the TPU kernels norma_tpu/ops/flash_encoder.py::
// flash_self_attention (:21) and jax_flash_self_attention (:66), which run
// the stock Pallas TPU flash-attention kernel over q/k/v padded from 1500
// to 1536 positions with segment masks.  For stream b, head h and query
// row r over all keys c < T:
//
//   s[c] = (sum_d q[r, d] * k[c, d]) * dh**-0.5   (f32 accumulation)
//   online softmax over key tiles in f32 (running max m, running sum l of
//   the unrounded p = exp(s - m));
//   o    = sum_c round(p[c]) * v[c, :] / l         (p rounded to the input
//                                                   dtype, f32 accumulation)
//
// the stock kernel's rounding points.  Same contract as the plain PyTorch
// version ops/flash_encoder.py::flash_attention_torch (which takes the
// exact softmax in one pass; the two agree to the rounding of p).
//
// What bounds it on the H100: compute.  At B=8, T=1500, H=20, dh=64 the
// two products are 92.2 GFLOP per layer against 123 MB of q/k/v/out: 0.093
// ms of bf16 tensor-core time against 0.037 ms of HBM time.  The [T, T]
// score matrix never reaches device memory.
//
// bf16 (the serving path): a FlashAttention-3 shape on Hopper's tensor
// cores.  Grid (ceil(T/128), H, B); a CTA of 288 threads: two consumer
// warpgroups of 64 query rows each and one producer warp.  The producer
// loads the 128 x 64 Q tile once and streams 128-key K and V tiles through
// a 2-stage shared-memory ring by TMA (128B swizzle, full / empty
// mbarriers).  The tensor maps are 3-D (channel, position, stream) over
// q/k/v's own strides, so positions >= T read as zeros, no tile crosses
// into the next stream, and the fused-QKV projection's slices need no
// copy.  Each consumer runs S = Q.K^T as wgmma m64n128k16 (both operands
// K-major in shared memory), the online softmax in registers on the
// accumulator layout (keys >= T masked to -inf; exp2 with log2(e) folded
// into the f32 scale), rounds p to bf16 into the register A operand of
// O += P.V (wgmma m64n64k16, V read MN-major through the transpose bit),
// divides by l once and rounds once into the contiguous [B, T, D] output.
//
// f32 (flash_attention=True at f32, held at 1e-5): exact f32 rules out the
// bf16 tensor cores, so it runs on the CUDA cores.  Grid (ceil(T/64), H,
// B), one CTA of 256 threads per (stream, head, 64-row query tile).  Q^T,
// K^T and V tiles of 64 x 64 live in shared memory as f32 (52 KB, opt-in
// dynamic); each thread owns a 4 x 4 block of the score tile (4 query rows
// x 4 keys) and of the output (4 rows x 4 channels), so every inner step is
// two 16-byte shared loads for 16 FMAs.  Row max and row sum reduce over
// the 16 threads that share a row (a half-warp, 4 shuffles).  The P^T
// tile (p stays f32: the contract rounds p to the input dtype) reuses
// K^T's buffer.  Keys at or beyond T are masked to -inf and query rows
// beyond T are computed but not stored.  q, k and v are read in place
// through their batch and row strides.
#include <cuda_bf16.h>

#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int kThreads = 256, DH = 64, TQ = 64, TK = 64, LD = 68;
constexpr size_t kSmemBytes = (size_t)3 * 64 * LD * sizeof(float);

__device__ __forceinline__ float half_warp_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__global__ void __launch_bounds__(kThreads) flash_encoder_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    long long q_sb, long long q_st, long long k_sb, long long k_st, long long v_sb,
    long long v_st, float* __restrict__ out, int T_len, int H, float scale) {
  extern __shared__ __align__(16) float smem[];
  float* Qt = smem;            // [d][row]
  float* KPt = Qt + 64 * LD;   // K^T [d][key], then P^T [key][row]
  float* Vs = KPt + 64 * LD;   // [key][d]

  const int b = blockIdx.z, h = blockIdx.y, r0 = blockIdx.x * TQ;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int D = H * DH;
  const float* qb = q + (size_t)b * q_sb + h * DH;
  const float* kb = k + (size_t)b * k_sb + h * DH;
  const float* vb = v + (size_t)b * v_sb + h * DH;

  for (int i = tid; i < TQ * DH; i += kThreads) {
    const int r = i / DH, d = i % DH;
    Qt[d * LD + r] = r0 + r < T_len ? qb[(size_t)(r0 + r) * q_st + d] : 0.f;
  }

  float o[4][4], m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -CUDART_INF_F;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) o[i][j] = 0.f;
  }

  for (int c0 = 0; c0 < T_len; c0 += TK) {
    __syncthreads();  // the previous tile's P^T and V are consumed
    for (int i = tid; i < TK * DH; i += kThreads) {
      const int c = i / DH, d = i % DH;
      const bool ok = c0 + c < T_len;
      KPt[d * LD + c] = ok ? kb[(size_t)(c0 + c) * k_st + d] : 0.f;
      Vs[c * LD + d] = ok ? vb[(size_t)(c0 + c) * v_st + d] : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < DH; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(&Qt[d * LD + ty * 4]);
      const float4 kk = *reinterpret_cast<const float4*>(&KPt[d * LD + tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w}, kv[4] = {kk.x, kk.y, kk.z, kk.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], kv[j], s[i][j]);
    }

    // Online softmax update for this thread's 4 rows.
    float p[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mt = -CUDART_INF_F;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = c0 + tx * 4 + j < T_len ? s[i][j] * scale : -CUDART_INF_F;
        mt = fmaxf(mt, s[i][j]);
      }
      const float mn = fmaxf(m[i], half_warp_max(mt));
      const float corr = expf(m[i] - mn);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        p[i][j] = expf(s[i][j] - mn);
        rs += p[i][j];
      }
      l[i] = l[i] * corr + half_warp_sum(rs);
      m[i] = mn;
#pragma unroll
      for (int j = 0; j < 4; ++j) o[i][j] *= corr;
    }
    __syncthreads();  // every thread is done reading K^T
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(&KPt[(tx * 4 + j) * LD + ty * 4]) =
          make_float4(p[0][j], p[1][j], p[2][j], p[3][j]);
    __syncthreads();

#pragma unroll 8
    for (int c = 0; c < TK; ++c) {
      const float4 a = *reinterpret_cast<const float4*>(&KPt[c * LD + ty * 4]);
      const float4 vv = *reinterpret_cast<const float4*>(&Vs[c * LD + tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w}, vw[4] = {vv.x, vv.y, vv.z, vv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) o[i][j] = fmaf(av[i], vw[j], o[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + ty * 4 + i;
    if (r < T_len) {
      float* dst = out + ((size_t)b * T_len + r) * D + h * DH + tx * 4;
#pragma unroll
      for (int j = 0; j < 4; ++j) dst[j] = o[i][j] / l[i];
    }
  }
}

int launch(const void* q, const void* k, const void* v, long long q_sb, long long q_st,
           long long k_sb, long long k_st, long long v_sb, long long v_st, void* out, int B,
           int T_len, int H, float scale, cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(flash_encoder_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemBytes);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((T_len + TQ - 1) / TQ, H, B);
  flash_encoder_kernel<<<grid, kThreads, kSmemBytes, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, q_sb, q_st, k_sb, k_st, v_sb, v_st,
      (float*)out, T_len, H, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// ---- bf16: wgmma + TMA ------------------------------------------------------

namespace fa3 {

using namespace norma::hopper;

constexpr int BQ = 128, BK = 128, STAGES = 2, kConsumers = 256, kThreads = kConsumers + 32;
constexpr int kQBytes = BQ * DH * 2, kKVBytes = BK * DH * 2;  // 128-byte rows
constexpr int kTileBytes = kQBytes + STAGES * 2 * kKVBytes;
constexpr size_t kSmemBytes = 1024 + kTileBytes + (1 + 2 * STAGES) * sizeof(uint64_t);

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

__global__ void __launch_bounds__(kThreads, 1) flash_encoder_wgmma_kernel(
    const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
    const __grid_constant__ CUtensorMap vmap, __nv_bfloat16* __restrict__ out, int T_len, int H,
    float scale_log2) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* sQ = smem;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + kTileBytes);
  uint64_t* q_full = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 1 + STAGES;
  auto sK = [&](int s) { return smem + kQBytes + s * 2 * kKVBytes; };
  auto sV = [&](int s) { return smem + kQBytes + s * 2 * kKVBytes + kKVBytes; };

  const int b = blockIdx.z, h = blockIdx.y, r0 = blockIdx.x * BQ;
  const int nt = (T_len + BK - 1) / BK;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (warp == kConsumers / 32) {
    // Producer warp: one thread issues every load.
    if (lane == 0) {
      mbar_expect_tx(q_full, kQBytes);
      tma_load_3d(sQ, &qmap, q_full, h * DH, r0, b);
      for (int t = 0; t < nt; ++t) {
        const int s = t % STAGES;
        if (t >= STAGES) mbar_wait(&empty[s], ((t / STAGES) - 1) & 1);
        mbar_expect_tx(&full[s], 2 * kKVBytes);
        tma_load_3d(sK(s), &kmap, &full[s], h * DH, t * BK, b);
        tma_load_3d(sV(s), &vmap, &full[s], h * DH, t * BK, b);
      }
    }
    return;
  }

  // Consumer warpgroup wg owns query rows wg*64 .. +63 of the tile; this
  // thread rows ra = (warp % 4) * 16 + lane / 4 and ra + 8 of those.
  const int wg = warp >> 2, tq = lane & 3;
  const int ra = (warp & 3) * 16 + (lane >> 2);
  float o[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] = 0.f;
  float m0 = -CUDART_INF_F, m1 = -CUDART_INF_F, l0 = 0.f, l1 = 0.f;

  mbar_wait(q_full, 0);
  const uint64_t dq = smem_desc(sQ + wg * 64 * 128, 16, 1024);

  for (int t = 0; t < nt; ++t) {
    const int s = t % STAGES;
    mbar_wait(&full[s], (t / STAGES) & 1);

    // S = Q . K^T over dh = 64: four k16 steps, +32 bytes each.
    float sc[64];
    const uint64_t dk = smem_desc(sK(s), 16, 1024);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_m64n128k16_bf16_ss(sc, dq + 2 * kk, dk + 2 * kk, kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < 64; ++i) fence_reg(sc[i]);

    if ((t + 1) * BK > T_len) {  // the last tile: keys >= T out
      const int c0 = t * BK + 2 * tq;
#pragma unroll
      for (int i = 0; i < 64; ++i)
        if (c0 + 8 * (i >> 2) + (i & 1) >= T_len) sc[i] = -CUDART_INF_F;
    }
    float mx0 = -CUDART_INF_F, mx1 = -CUDART_INF_F;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      mx0 = fmaxf(mx0, fmaxf(sc[4 * j], sc[4 * j + 1]));
      mx1 = fmaxf(mx1, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
    }
    const float mn0 = fmaxf(m0, quad_max(mx0)), mn1 = fmaxf(m1, quad_max(mx1));
    const float c0 = exp2f((m0 - mn0) * scale_log2), c1 = exp2f((m1 - mn1) * scale_log2);
    m0 = mn0;
    m1 = mn1;
    const float b0 = mn0 * scale_log2, b1 = mn1 * scale_log2;
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      sc[4 * j] = exp2f(fmaf(sc[4 * j], scale_log2, -b0));
      sc[4 * j + 1] = exp2f(fmaf(sc[4 * j + 1], scale_log2, -b0));
      sc[4 * j + 2] = exp2f(fmaf(sc[4 * j + 2], scale_log2, -b1));
      sc[4 * j + 3] = exp2f(fmaf(sc[4 * j + 3], scale_log2, -b1));
      ps0 += sc[4 * j] + sc[4 * j + 1];
      ps1 += sc[4 * j + 2] + sc[4 * j + 3];
    }
    l0 = l0 * c0 + ps0;  // this thread's share of the row sums
    l1 = l1 * c1 + ps1;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      o[4 * j] *= c0;
      o[4 * j + 1] *= c0;
      o[4 * j + 2] *= c1;
      o[4 * j + 3] *= c1;
    }
    // p rounded to bf16: the k16 slice kk of S's accumulator is exactly the
    // register A fragment of the PV product.
    uint32_t pa[8][4];
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      pa[kk][0] = pack_bf16(sc[8 * kk], sc[8 * kk + 1]);
      pa[kk][1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
      pa[kk][2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
      pa[kk][3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
    }
    // O += P . V: V is [key][channel] (channels contiguous), i.e. MN-major;
    // each k16 step is 16 keys = two 8-row atoms, 2048 bytes on.
    const uint64_t dv = smem_desc(sV(s), 1024, 1024);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) wgmma_m64n64k16_bf16_rs_tb(o, pa[kk], dv + (uint64_t)(kk * 2048 >> 4), 1);
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < 32; ++i) fence_reg(o[i]);
    mbar_arrive(&empty[s]);
  }

  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  const int D = H * DH;
  const int rows[2] = {r0 + wg * 64 + ra, r0 + wg * 64 + ra + 8};
  const float ls[2] = {l0, l1};
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    if (rows[half] >= T_len) continue;
    __nv_bfloat16* dst = out + ((size_t)b * T_len + rows[half]) * D + h * DH + 2 * tq;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const __nv_bfloat162 v =
          __floats2bfloat162_rn(o[4 * j + 2 * half] / ls[half], o[4 * j + 2 * half + 1] / ls[half]);
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j) = v;
    }
  }
}

int launch(const void* q, const void* k, const void* v, long long q_sb, long long q_st, long long k_sb,
           long long k_st, long long v_sb, long long v_st, void* out, int B, int T_len, int H, float scale,
           cudaStream_t stream) {
  const int D = H * DH;
  CUtensorMap maps[3];
  const void* ptrs[3] = {q, k, v};
  const long long sb[3] = {q_sb, k_sb, v_sb}, st[3] = {q_st, k_st, v_st};
  for (int i = 0; i < 3; ++i) {
    const uint64_t dims[3] = {(uint64_t)D, (uint64_t)T_len, (uint64_t)B};
    // A size-1 batch dim's stride is never stepped; give TMA a valid one.
    const uint64_t strides[2] = {(uint64_t)st[i] * 2,
                                 (uint64_t)(B > 1 ? sb[i] : st[i] * T_len) * 2};
    const uint32_t box[3] = {DH, (uint32_t)(i == 0 ? BQ : BK), 1};
    const int e = encode_tensor_map(&maps[i], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, ptrs[i], dims, strides, box);
    if (e) return e;
  }
  cudaError_t e = cudaFuncSetAttribute(flash_encoder_wgmma_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemBytes);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((T_len + BQ - 1) / BQ, H, B);
  flash_encoder_wgmma_kernel<<<grid, kThreads, kSmemBytes, stream>>>(
      maps[0], maps[1], maps[2], (__nv_bfloat16*)out, T_len, H, scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}

}  // namespace fa3

extern "C" int norma_flash_encoder(const void* q, const void* k, const void* v, long long q_sb,
                                   long long q_st, long long k_sb, long long k_st,
                                   long long v_sb, long long v_st, void* out, int B, int T_len,
                                   int H, int dh, int is_bf16, float scale, void* stream) {
  if (dh != DH || B < 1 || T_len < 1 || H < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16)
    return fa3::launch(q, k, v, q_sb, q_st, k_sb, k_st, v_sb, v_st, out, B, T_len, H, scale, s);
  return launch(q, k, v, q_sb, q_st, k_sb, k_st, v_sb, v_st, out, B, T_len, H, scale, s);
}
