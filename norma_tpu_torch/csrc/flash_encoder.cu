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
// two products are ~92 GFLOP per layer against ~92 MB of q/k/v/out; this
// kernel runs them on the CUDA cores in f32 (tensor cores -- mma.sync /
// wgmma on bf16 tiles -- are the later speed-up).  The [T, T] score matrix
// never reaches device memory.
//
// Design (FA-2 shape): grid (ceil(T/64), H, B), one CTA of 256 threads per
// (stream, head, 64-row query tile).  Q^T, K^T and V tiles of 64 x 64 live
// in shared memory as f32 (52 KB, opt-in dynamic); each thread owns a
// 4 x 4 block of the score tile (4 query rows x 4 keys) and of the output
// (4 rows x 4 channels), so every inner step is two 16-byte shared loads
// for 16 FMAs.  Row max and row sum reduce over the 16 threads that share
// a row (a half-warp, 4 shuffles).  The rounded P^T tile reuses K^T's
// buffer.  Keys at or beyond T are masked to -inf and query rows beyond T
// are computed but not stored: no padding to 1536.  q, k and v are read in
// place through their batch and row strides, so the three slices of the
// fused QKV projection's [B, T, 3, D] output need no copy (on the w8a8
// path each f32 slice is cast to the activation dtype first, and arrives
// contiguous); the output is a contiguous [B, T, D].
#include <cuda_bf16.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256, DH = 64, TQ = 64, TK = 64, LD = 68;
constexpr size_t kSmemBytes = (size_t)3 * 64 * LD * sizeof(float);

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

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

template <typename T>
__global__ void __launch_bounds__(kThreads) flash_encoder_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    long long q_sb, long long q_st, long long k_sb, long long k_st, long long v_sb,
    long long v_st, T* __restrict__ out, int T_len, int H, float scale) {
  extern __shared__ __align__(16) float smem[];
  float* Qt = smem;            // [d][row]
  float* KPt = Qt + 64 * LD;   // K^T [d][key], then P^T [key][row]
  float* Vs = KPt + 64 * LD;   // [key][d]

  const int b = blockIdx.z, h = blockIdx.y, r0 = blockIdx.x * TQ;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int D = H * DH;
  const T* qb = q + (size_t)b * q_sb + h * DH;
  const T* kb = k + (size_t)b * k_sb + h * DH;
  const T* vb = v + (size_t)b * v_sb + h * DH;

  for (int i = tid; i < TQ * DH; i += kThreads) {
    const int r = i / DH, d = i % DH;
    Qt[d * LD + r] = r0 + r < T_len ? to_f(qb[(size_t)(r0 + r) * q_st + d]) : 0.f;
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
      KPt[d * LD + c] = ok ? to_f(kb[(size_t)(c0 + c) * k_st + d]) : 0.f;
      Vs[c * LD + d] = ok ? to_f(vb[(size_t)(c0 + c) * v_st + d]) : 0.f;
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
          make_float4(round_to<T>(p[0][j]), round_to<T>(p[1][j]), round_to<T>(p[2][j]),
                      round_to<T>(p[3][j]));
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
      T* dst = out + ((size_t)b * T_len + r) * D + h * DH + tx * 4;
#pragma unroll
      for (int j = 0; j < 4; ++j) dst[j] = from_f<T>(o[i][j] / l[i]);
    }
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, long long q_sb, long long q_st,
           long long k_sb, long long k_st, long long v_sb, long long v_st, void* out, int B,
           int T_len, int H, float scale, cudaStream_t stream) {
  auto kern = flash_encoder_kernel<T>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)kSmemBytes);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((T_len + TQ - 1) / TQ, H, B);
  kern<<<grid, kThreads, kSmemBytes, stream>>>((const T*)q, (const T*)k, (const T*)v, q_sb,
                                               q_st, k_sb, k_st, v_sb, v_st, (T*)out, T_len,
                                               H, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int norma_flash_encoder(const void* q, const void* k, const void* v, long long q_sb,
                                   long long q_st, long long k_sb, long long k_st,
                                   long long v_sb, long long v_st, void* out, int B, int T_len,
                                   int H, int dh, int is_bf16, float scale, void* stream) {
  if (dh != DH || B < 1 || T_len < 1 || H < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16)
    return launch<__nv_bfloat16>(q, k, v, q_sb, q_st, k_sb, k_st, v_sb, v_st, out, B, T_len,
                                 H, scale, s);
  return launch<float>(q, k, v, q_sb, q_st, k_sb, k_st, v_sb, v_st, out, B, T_len, H, scale,
                       s);
}
