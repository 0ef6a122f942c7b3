// Single-query self-attention decode step over the stacked KV cache.
//
// Replaces the TPU kernel norma_tpu/ops/self_decode.py::self_attention_decode
// (pl.pallas_call at :171, body _self_decode_kernel at :48): for layer `li`
// and position `pos`, attend one query row per (stream, head) over the
// cache rows below `pos` plus the step's new K/V row (which sits at `pos`),
// then write that new row into the caches IN PLACE.  Both whisper
// dh**-0.25 factors fold onto q (`scale` = dh**-0.5, in f32, then rounded
// to the cache dtype as the TPU kernel does); logits, softmax and the PV sum
// accumulate in f32.  Same contract as the plain PyTorch version
// ops/self_decode.py::self_attention_decode_torch.
//
// What bounds it on the H100: reading the layer's cache, B * pos * D * 2
// values per step (K and V), at most ~9 MB for 6 rows x 448 positions x
// 1280 f32 -- microseconds of HBM time, so at decode sizes launch latency
// and the grid's parallelism bound it, not bandwidth.
//
// The position comes by value or, for a captured CUDA graph that replays
// one launch at successive positions, from device memory (pos_ptr).
//
// Design: grid (B, H), one CTA of 4 warps per (row, head).  A warp owns
// cache rows t = warp, warp+4, ...; its lanes split head_dim (2 values per
// lane at dh=64), so each row's head slice is one contiguous, coalesced
// read, and the dot product is a 5-step shuffle reduction.  The pos+1
// logits stay in shared memory for an exact two-pass softmax (max, then
// exp/sum), then the same warp/row split accumulates sum_t p_t v_t and the
// warps' partial sums combine through shared memory.  Only rows < pos are
// ever read, so rows at or beyond pos -- stale rows from a longer earlier
// window, or the zero tail of a bucket -- cannot leak in, and the cost
// scales with the fill, not with the cache's length.  The cache's layer and
// batch strides are arguments: a bucket view cache[:, :, :S] of one
// [L, B, Tmax, D] allocation is read and written without a copy.  So are
// the q / k_new / v_new row strides: the fused QKV projection's slices
// are consumed in place.
#include <cuda_bf16.h>

#include "common.cuh"

namespace {

constexpr int kWarps = 4;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Round an f32 value through the cache dtype (identity for f32).
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

template <typename T, int DH>
__global__ void __launch_bounds__(kWarps * 32) self_decode_kernel(
    const T* __restrict__ q, const T* __restrict__ k_new, const T* __restrict__ v_new,
    T* cache_k, T* cache_v, T* __restrict__ out, long long q_sb, long long kn_sb,
    long long vn_sb, long long ck_sl, long long ck_sb, long long cv_sl, long long cv_sb,
    int li, int pos_val, const long long* __restrict__ pos_ptr, int t_len, int H, float scale) {
  constexpr int VPL = DH / 32;  // head values per lane
  extern __shared__ float logits[];  // [t_len + 1], of which [pos + 1] are used
  __shared__ float red[32];
  __shared__ float partial[kWarps][DH];
  __shared__ float qs[DH];

  // A device position (a replayed CUDA graph's) is checked here, where
  // its value is known: out of [0, t_len) the launch traps, it never reads
  // or writes outside the crop.
  const int pos = pos_ptr != nullptr ? (int)*pos_ptr : pos_val;
  if (pos < 0 || pos >= t_len) __trap();
  const int b = blockIdx.x, h = blockIdx.y, D = H * DH;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const size_t out_off = (size_t)b * D + (size_t)h * DH;
  const T* qr = q + b * q_sb + h * DH;
  const T* knr = k_new + b * kn_sb + h * DH;
  const T* vnr = v_new + b * vn_sb + h * DH;

  if (tid < DH) qs[tid] = round_to<T>(to_f(qr[tid]) * scale);
  __syncthreads();
  float qv[VPL];
#pragma unroll
  for (int i = 0; i < VPL; ++i) qv[i] = qs[lane * VPL + i];

  const T* kb = cache_k + li * ck_sl + b * ck_sb + h * DH + lane * VPL;
  const T* vb = cache_v + li * cv_sl + b * cv_sb + h * DH + lane * VPL;

  // Logits: history rows t < pos from the cache, the new row at pos.
  for (int t = warp; t < pos; t += kWarps) {
    const T* kr = kb + (size_t)t * D;
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < VPL; ++i) s += qv[i] * to_f(kr[i]);
    s = norma::warp_sum(s);
    if (lane == 0) logits[t] = s;
  }
  if (warp == kWarps - 1) {
    const T* kr = knr + lane * VPL;
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < VPL; ++i) s += qv[i] * to_f(kr[i]);
    s = norma::warp_sum(s);
    if (lane == 0) logits[pos] = s;
  }
  __syncthreads();

  // Exact softmax over pos + 1 logits.
  float m = -CUDART_INF_F;
  for (int t = tid; t <= pos; t += blockDim.x) m = fmaxf(m, logits[t]);
  m = norma::block_max(m, red);
  float l = 0.f;
  for (int t = tid; t <= pos; t += blockDim.x) {
    const float p = expf(logits[t] - m);
    logits[t] = p;
    l += p;
  }
  l = norma::block_sum(l, red);  // its barriers publish the p values

  // sum_t p_t v_t over history rows (p rounded to the cache dtype, as the
  // TPU kernel feeds its PV dot).
  float acc[VPL];
#pragma unroll
  for (int i = 0; i < VPL; ++i) acc[i] = 0.f;
  for (int t = warp; t < pos; t += kWarps) {
    const float p = round_to<T>(logits[t]);
    const T* vr = vb + (size_t)t * D;
#pragma unroll
    for (int i = 0; i < VPL; ++i) acc[i] += p * to_f(vr[i]);
  }
#pragma unroll
  for (int i = 0; i < VPL; ++i) partial[warp][lane * VPL + i] = acc[i];
  __syncthreads();

  if (tid < DH) {
    float o = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) o += partial[w][tid];
    o = (o + logits[pos] * to_f(vnr[tid])) / l;
    out[out_off + tid] = from_f<T>(o);
    // In-place write-back of the new row (li, b, pos) for this head.
    cache_k[li * ck_sl + b * ck_sb + (size_t)pos * D + h * DH + tid] = knr[tid];
    cache_v[li * cv_sl + b * cv_sb + (size_t)pos * D + h * DH + tid] = vnr[tid];
  }
}

template <typename T>
int launch(const void* q, const void* k_new, const void* v_new, void* ck, void* cv,
           void* out, long long q_sb, long long kn_sb, long long vn_sb, long long ck_sl,
           long long ck_sb, long long cv_sl, long long cv_sb, int li, int pos,
           const long long* pos_ptr, int t_len, int B, int H, int dh, float scale,
           cudaStream_t stream) {
  const dim3 grid(B, H);
  // Sized from the crop, not the position, so that one launch shape serves
  // every position of a captured graph's chunk.
  const size_t smem = (size_t)(t_len + 1) * sizeof(float);
#define NORMA_SELF_DECODE(DH)                                                        \
  self_decode_kernel<T, DH><<<grid, kWarps * 32, smem, stream>>>(                    \
      (const T*)q, (const T*)k_new, (const T*)v_new, (T*)ck, (T*)cv, (T*)out, q_sb,  \
      kn_sb, vn_sb, ck_sl, ck_sb, cv_sl, cv_sb, li, pos, pos_ptr, t_len, H, scale)
  switch (dh) {
    case 32: NORMA_SELF_DECODE(32); break;
    case 64: NORMA_SELF_DECODE(64); break;
    case 128: NORMA_SELF_DECODE(128); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef NORMA_SELF_DECODE
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int norma_self_decode(const void* q, const void* k_new, const void* v_new,
                                 void* cache_k, void* cache_v, void* out,
                                 long long q_sb, long long kn_sb, long long vn_sb,
                                 long long ck_sl, long long ck_sb, long long cv_sl,
                                 long long cv_sb, int li, int pos, const long long* pos_ptr,
                                 int B, int H, int dh, int T, int is_bf16, float scale,
                                 void* stream) {
  // A host position is checked here; a device one (pos_ptr) in the kernel.
  if (T < 1 || (pos_ptr == nullptr && (pos < 0 || pos >= T))) return (int)cudaErrorInvalidValue;
  if (is_bf16)
    return launch<__nv_bfloat16>(q, k_new, v_new, cache_k, cache_v, out, q_sb, kn_sb,
                                 vn_sb, ck_sl, ck_sb, cv_sl, cv_sb, li, pos, pos_ptr, T, B, H,
                                 dh, scale, (cudaStream_t)stream);
  return launch<float>(q, k_new, v_new, cache_k, cache_v, out, q_sb, kn_sb, vn_sb, ck_sl,
                       ck_sb, cv_sl, cv_sb, li, pos, pos_ptr, T, B, H, dh, scale,
                       (cudaStream_t)stream);
}
