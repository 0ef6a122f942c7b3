// Single-query cross-attention over int8 (or int4) cross-K/V codes.
//
// Replaces the TPU kernels norma_tpu/ops/paged_cross.py::
// cross_attention_q8_kernel_stacked (pl.pallas_call at :256, bodies
// _cross_decode_kernel :88, _cross_decode_kernel_i4 :162,
// _cross_decode_kernel_stacked :185) and its per-layer form
// cross_attention_q8_kernel (:297; the wrapper passes that one as a stack
// of one layer).  For stream b, head h and the G query rows g*B + b that
// share the stream (G temperature rungs):
//
//   q'   = bf16((q * k_scale) * dh**-0.5)          (f32 fold, then bf16)
//   s[t] = sum_d q'[d] * kcode[t, d]               (f32 accumulation)
//   p[t] = exp(s[t] - max s);  l = sum_t p[t]      (f32)
//   o[d] = sum_t bf16(p[t]) * vcode[t, d]          (f32 accumulation)
//   out  = (o / l) * v_scale, rounded to q's dtype
//
// the TPU kernel's rounding points, with the per-channel scales folded
// exactly as there (K scale onto q, V scale onto the output).  Same
// contract as the plain PyTorch version ops/paged_cross.py::
// cross_attention_decode_torch.
//
// Layout (the port's own; ops/paged_cross.py::prep_cross_kv_kernel*):
// codes [L, B, H, Ta, dh] int8, so one (layer, stream, head) block is
// Ta * dh contiguous bytes and a key row is 64 contiguous bytes; int4
// packs keys 2r (low nibble) and 2r+1 (high nibble) of the same channel
// into one byte, [L, B, H, Ta/2, dh] -- adjacent keys, so K and V share
// the pairing and no permutation is involved.  The layer index `li` and
// the layer / stream strides are arguments: the stacked arrays are never
// sliced or copied.
//
// What bounds it on the H100: reading the codes, 2 * B * Ta * D bytes per
// layer per step (3.9 MB at B=1, 31 MB at B=8, int8), i.e. HBM bandwidth;
// the G query rows of a stream share one read of its codes.
//
// Design: grid (H, B), one CTA of 8 warps per (stream, head).  Phase 1: a
// thread per key row (64 bytes as four 16-byte loads) computes all G
// logits against the folded q held in shared memory; the [G, Ta] f32
// logits stay in (opt-in dynamic) shared memory.  Phase 2: exact softmax
// per query row (max, then exp/sum).  Phase 3: 16 threads per key row,
// each owning 4 channels (a 4-byte load), accumulate sum_t p_t v_t for all
// G rows; lane pairs and then the 8 warps combine their partial sums.
#include <cuda_bf16.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256, kWarps = kThreads / 32, DH = 64, kMaxG = 8;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16(x));
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Sign-extended nibbles of one byte (0..255): arithmetic right shifts.
__device__ __forceinline__ float lo_nib(int b) { return (float)((int)((unsigned)b << 28) >> 28); }
__device__ __forceinline__ float hi_nib(int b) { return (float)((int)((unsigned)b << 24) >> 28); }
__device__ __forceinline__ float byte_at(int w, int i) {
  return (float)(int)(int8_t)((w >> (8 * i)) & 0xff);
}

template <typename T, bool INT4, int G>
__global__ void __launch_bounds__(kThreads) cross_decode_kernel(
    const T* __restrict__ q, long long q_rs, const int8_t* __restrict__ kc,
    const int8_t* __restrict__ vc, long long c_sl, long long c_sb,
    const float* __restrict__ ks, const float* __restrict__ vs, long long s_sl,
    long long s_sb, T* __restrict__ out, long long o_rs, int li, int B, int H, int Ta,
    float scale) {
  extern __shared__ float logits[];  // [G][Ta]
  __shared__ float qs[G][DH];
  __shared__ float partial[kWarps][G][DH];
  __shared__ float lsum[G];
  __shared__ float red[32];

  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int rows = INT4 ? Ta / 2 : Ta;  // stored code rows per (b, h)
  const size_t blk = (size_t)li * c_sl + (size_t)b * c_sb + (size_t)h * rows * DH;
  const int8_t* kb = kc + blk;
  const int8_t* vb = vc + blk;
  const float* ksr = ks + (size_t)li * s_sl + (size_t)b * s_sb + h * DH;
  const float* vsr = vs + (size_t)li * s_sl + (size_t)b * s_sb + h * DH;

  // q fold: (q * k_scale) * dh**-0.5 in f32, rounded to bf16.
  for (int i = tid; i < G * DH; i += kThreads) {
    const int g = i / DH, d = i % DH;
    const float qv = to_f(q[(size_t)(g * B + b) * q_rs + h * DH + d]);
    qs[g][d] = bf16_round(__fmul_rn(__fmul_rn(qv, ksr[d]), scale));
  }
  __syncthreads();

  // Phase 1: logits.  One thread per stored row (64 bytes).
  for (int r = tid; r < rows; r += kThreads) {
    const int4* src = reinterpret_cast<const int4*>(kb + (size_t)r * DH);
    float s0[G], s1[G];
#pragma unroll
    for (int g = 0; g < G; ++g) s0[g] = s1[g] = 0.f;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int4 v = src[c];
      const int w4[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int d = c * 16 + j;
        const int w = w4[j >> 2];
        if (INT4) {
          const int byte = (w >> (8 * (j & 3))) & 0xff;
          const float k0 = lo_nib(byte), k1 = hi_nib(byte);
#pragma unroll
          for (int g = 0; g < G; ++g) {
            s0[g] = fmaf(qs[g][d], k0, s0[g]);
            s1[g] = fmaf(qs[g][d], k1, s1[g]);
          }
        } else {
          const float k0 = byte_at(w, j & 3);
#pragma unroll
          for (int g = 0; g < G; ++g) s0[g] = fmaf(qs[g][d], k0, s0[g]);
        }
      }
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
      if (INT4) {
        logits[g * Ta + 2 * r] = s0[g];
        logits[g * Ta + 2 * r + 1] = s1[g];
      } else {
        logits[g * Ta + r] = s0[g];
      }
    }
  }
  __syncthreads();

  // Phase 2: exact softmax per query row; p stays unrounded here.
  for (int g = 0; g < G; ++g) {
    float* lg = logits + g * Ta;
    float m = -CUDART_INF_F;
    for (int t = tid; t < Ta; t += kThreads) m = fmaxf(m, lg[t]);
    m = norma::block_max(m, red);
    float l = 0.f;
    for (int t = tid; t < Ta; t += kThreads) {
      const float p = expf(lg[t] - m);
      lg[t] = p;
      l += p;
    }
    l = norma::block_sum(l, red);  // its barriers publish the p values
    if (tid == 0) lsum[g] = l;
  }

  // Phase 3: o[g][d] = sum_t bf16(p[g][t]) * v[t][d].
  const int dq = tid & 15, rg = tid >> 4;  // 4 channels, 16 row groups
  float acc[G][4];
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[g][i] = 0.f;
  for (int r = rg; r < rows; r += kThreads / 16) {
    const int w = *reinterpret_cast<const int*>(vb + (size_t)r * DH + dq * 4);
#pragma unroll
    for (int g = 0; g < G; ++g) {
      if (INT4) {
        const float p0 = bf16_round(logits[g * Ta + 2 * r]);
        const float p1 = bf16_round(logits[g * Ta + 2 * r + 1]);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int byte = (w >> (8 * i)) & 0xff;
          acc[g][i] = fmaf(p0, lo_nib(byte), acc[g][i]);
          acc[g][i] = fmaf(p1, hi_nib(byte), acc[g][i]);
        }
      } else {
        const float p = bf16_round(logits[g * Ta + r]);
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[g][i] = fmaf(p, byte_at(w, i), acc[g][i]);
      }
    }
  }
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[g][i] += __shfl_xor_sync(0xffffffffu, acc[g][i], 16);
  if (lane < 16) {
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int i = 0; i < 4; ++i) partial[warp][g][dq * 4 + i] = acc[g][i];
  }
  __syncthreads();

  for (int i = tid; i < G * DH; i += kThreads) {
    const int g = i / DH, d = i % DH;
    float o = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) o += partial[w][g][d];
    const float y = __fmul_rn(o / lsum[g], vsr[d]);
    out[(size_t)(g * B + b) * o_rs + h * DH + d] = from_f<T>(y);
  }
}

template <typename T, bool INT4, int G>
int launch(const void* q, long long q_rs, const void* kc, const void* vc, long long c_sl,
           long long c_sb, const void* ks, const void* vs, long long s_sl, long long s_sb,
           void* out, long long o_rs, int li, int B, int H, int Ta, float scale,
           cudaStream_t stream) {
  const size_t smem = (size_t)G * Ta * sizeof(float);
  auto kern = cross_decode_kernel<T, INT4, G>;
  cudaError_t e =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  kern<<<dim3(H, B), kThreads, smem, stream>>>(
      (const T*)q, q_rs, (const int8_t*)kc, (const int8_t*)vc, c_sl, c_sb, (const float*)ks,
      (const float*)vs, s_sl, s_sb, (T*)out, o_rs, li, B, H, Ta, scale);
  return (int)cudaGetLastError();
}

template <typename T, bool INT4>
int launch_g(int G, const void* q, long long q_rs, const void* kc, const void* vc,
             long long c_sl, long long c_sb, const void* ks, const void* vs, long long s_sl,
             long long s_sb, void* out, long long o_rs, int li, int B, int H, int Ta,
             float scale, cudaStream_t stream) {
#define NORMA_CROSS_G(N)                                                                    \
  case N:                                                                                   \
    return launch<T, INT4, N>(q, q_rs, kc, vc, c_sl, c_sb, ks, vs, s_sl, s_sb, out, o_rs, li, \
                              B, H, Ta, scale, stream)
  switch (G) {
    NORMA_CROSS_G(1);
    NORMA_CROSS_G(2);
    NORMA_CROSS_G(3);
    NORMA_CROSS_G(4);
    NORMA_CROSS_G(5);
    NORMA_CROSS_G(6);
    NORMA_CROSS_G(7);
    NORMA_CROSS_G(8);
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef NORMA_CROSS_G
}

}  // namespace

extern "C" int norma_cross_decode(const void* q, long long q_rs, const void* kc, const void* vc,
                                  long long c_sl, long long c_sb, const void* ks,
                                  const void* vs, long long s_sl, long long s_sb, void* out,
                                  long long o_rs, int li, int B, int H, int dh, int G, int Ta,
                                  int is_bf16, int is_int4, float scale, void* stream) {
  if (dh != DH || G < 1 || G > kMaxG || Ta < 1 || (is_int4 && Ta % 2))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
#define NORMA_CROSS(T, I4)                                                                 \
  return launch_g<T, I4>(G, q, q_rs, kc, vc, c_sl, c_sb, ks, vs, s_sl, s_sb, out, o_rs, li, B, \
                         H, Ta, scale, s)
  if (is_bf16) {
    if (is_int4) NORMA_CROSS(__nv_bfloat16, true);
    NORMA_CROSS(__nv_bfloat16, false);
  }
  if (is_int4) NORMA_CROSS(float, true);
  NORMA_CROSS(float, false);
#undef NORMA_CROSS
}
