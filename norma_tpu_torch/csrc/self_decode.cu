// Single-query self-attention decode step over the stacked KV cache.
//
// Replaces the TPU kernel norma_tpu/ops/self_decode.py::self_attention_decode
// (pl.pallas_call at :171, body _self_decode_kernel at :48): for layer `li`
// and position `pos`, attend one query row per (stream, head) over the
// cache rows below `pos` plus the step's new K/V row (which sits at `pos`),
// then write that new row into the caches IN PLACE.  Both whisper
// dh**-0.25 factors fold onto q (`scale` = dh**-0.5, in f32, then rounded
// to the cache dtype as the TPU kernel does); logits and the exact
// two-pass softmax over the whole row are f32, p is rounded to the cache
// dtype for the PV sum (the new row's p is not), which accumulates in f32.
// Same contract as the plain PyTorch version
// ops/self_decode.py::self_attention_decode_torch.
//
// What bounds it on the H100: the cache rows it must read, 2 * B * pos * D
// values per step (K and V): 9.2 MB at the served batch (8 rows, bf16, the
// window's mean fill of ~225), 2.8 us of HBM time.  So the latency of its
// dependent steps bounds it as much as bandwidth: the first design (one
// CTA of 4 warps per (row, head) walking rows serially with 4-byte loads,
// then V after the softmax) took ~9x its bytes.
//
// Design (ops/self_decode.py::self_decode_plan gives the launch shape):
//   - A thread-block cluster of C CTAs of 8 warps per (row, head), grid
//     (C, H, B).  CTA `rank` takes history rows [rank * pos / C,
//     (rank + 1) * pos / C), computed here from the (possibly device)
//     position, so the split stays balanced at every fill of a captured
//     graph's chunk; the launch shape depends only on the crop S.  A CTA
//     whose range is empty still joins the cluster barriers.
//   - A row's head slice is DH * sizeof(T) bytes, read as 16-byte chunks:
//     DH * sizeof(T) / 16 lanes per row (8 at dh 64 bf16, 16 at f32), so a
//     warp takes several rows per instruction and a dot product ends in a
//     3-4 step shuffle.  Each thread holds its chunk of up to kRows = 8
//     rows of K and of V in registers, all loaded at entry (with q and the
//     new row, before the position arrives where they can): every byte the
//     CTA needs is in flight at once, and V stays in flight through the
//     logits and the cluster's max.  Logits, softmax and PV then run from
//     registers, on CUDA cores in f32.
//   - The cluster meets through distributed shared memory in one fixed
//     order: each CTA's max (its warps' through shared memory) goes into
//     every CTA's shared memory; after one cluster barrier every thread
//     takes the max of the C values, the global max against which every p
//     is taken before its rounding; each CTA's partial o[DH] and sum (its
//     warps added in order) go into rank 0's shared memory, and after a
//     second barrier rank 0 adds them in rank order, adds the new row's
//     term, divides by l, and alone writes the output and the cache row at
//     `pos`.  The result is the same from run to run.
//   - Only rows < pos are ever read, so rows at or beyond pos (stale rows of
//     a longer earlier window, the zero tail of a bucket) cannot leak in.
//     A device position outside [0, S) traps.  The cache's layer and batch
//     strides are arguments: a bucket view cache[:, :, :S] of one
//     [L, B, Tmax, D] allocation is read and written without a copy, as are
//     q / k_new / v_new rows sliced out of a fused QKV projection.
#include <cooperative_groups.h>
#include <cuda_bf16.h>

#include "common.cuh"
#include "wstream.cuh"

namespace cg = cooperative_groups;

namespace {

// kRows: the most rows a thread holds (its K and V chunks live in
// registers), so a CTA takes at most kRows * kStride rows.
constexpr int kWarps = 8, kThreads = kWarps * 32, kMaxCluster = 16, kRows = 8;

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

// The values of one 16-byte chunk as f32.
__device__ __forceinline__ void unpack(const uint4& c, float (&v)[4]) {
  v[0] = __uint_as_float(c.x);
  v[1] = __uint_as_float(c.y);
  v[2] = __uint_as_float(c.z);
  v[3] = __uint_as_float(c.w);
}
__device__ __forceinline__ void unpack(const uint4& c, float (&v)[8]) {
  const uint32_t w[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

// A 16-byte load from device memory (read-only for this launch: rows
// below pos are never written by it).
__device__ __forceinline__ uint4 ld16(const void* p) {
  uint4 v;
  asm volatile("ld.global.nc.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p));
  return v;
}

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads) self_decode_kernel(
    const T* __restrict__ q, const T* __restrict__ k_new, const T* __restrict__ v_new,
    T* cache_k, T* cache_v, T* __restrict__ out, long long q_sb, long long kn_sb,
    long long vn_sb, long long ck_sl, long long ck_sb, long long cv_sl, long long cv_sb,
    int li, int pos_val, const long long* __restrict__ pos_ptr, int t_len, int H, float scale) {
  constexpr int kVec = 16 / sizeof(T);         // values per 16-byte chunk
  constexpr int kLanes = DH / kVec;            // lanes (chunks) per row
  constexpr int kRowsPerWarp = 32 / kLanes;    // rows per warp instruction
  constexpr int kStride = kWarps * kRowsPerWarp;  // rows per block instruction
  // Dynamic shared memory, used in rank 0: the CTAs' partial o [C][DH] and
  // sums [C].
  extern __shared__ __align__(16) float part[];
  __shared__ float wred[kWarps];        // the warps' max, then sums
  __shared__ float wpart[kWarps][DH];   // the warps' partial o
  __shared__ float cmax[kMaxCluster];   // the CTAs' max, by rank
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  norma::cluster_arrive_relaxed();

  const int h = blockIdx.y, b = blockIdx.z, D = H * DH;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int c = lane % kLanes, slot = lane / kLanes;  // chunk c of the warp's row `slot`
  // What does not depend on the position loads first: q and the new K row's
  // chunk c (for the new row's logit), the new row's values (for rank 0).
  const T* qr = q + b * q_sb + h * DH + c * kVec;
  const T* knr = k_new + b * kn_sb + h * DH;
  const T* vnr = v_new + b * vn_sb + h * DH;
  float qv[kVec], kn[kVec];
#pragma unroll
  for (int i = 0; i < kVec; ++i) {
    qv[i] = to_f(qr[i]);
    kn[i] = to_f(knr[c * kVec + i]);
  }
  T kn_t = T(), vn_t = T();
  if (rank == 0 && tid < DH) {
    kn_t = knr[tid];
    vn_t = vnr[tid];
  }

  // A device position (a replayed CUDA graph's) is checked here, where
  // its value is known: out of [0, t_len) the launch traps, it never reads
  // or writes outside the crop.
  const int pos = pos_ptr != nullptr ? (int)*pos_ptr : pos_val;
  if (pos < 0 || pos >= t_len) __trap();
  const int lo = (int)((long long)rank * pos / C);
  const int n = (int)((long long)(rank + 1) * pos / C) - lo;  // this CTA's rows

  // Every K and V chunk the thread needs (chunk c of rows warp *
  // kRowsPerWarp + slot + i * kStride), in flight at once as 16-byte loads.
  const T* kb = cache_k + li * ck_sl + b * ck_sb + (size_t)lo * D + h * DH + c * kVec;
  const T* vb = cache_v + li * cv_sl + b * cv_sb + (size_t)lo * D + h * DH + c * kVec;
  const int r_first = warp * kRowsPerWarp + slot;
  uint4 kr[kRows], vr[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int r = r_first + i * kStride;
    kr[i] = r < n ? ld16(kb + (size_t)r * D) : make_uint4(0, 0, 0, 0);
  }
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int r = r_first + i * kStride;
    vr[i] = r < n ? ld16(vb + (size_t)r * D) : make_uint4(0, 0, 0, 0);
  }

  // q folded by dh**-0.5 in f32, rounded to the cache dtype; the new row's
  // logit (every row group computes it; rank 0 counts it).
  float s_new = 0.f;
#pragma unroll
  for (int i = 0; i < kVec; ++i) {
    qv[i] = round_to<T>(qv[i] * scale);
    s_new = fmaf(qv[i], kn[i], s_new);
  }
#pragma unroll
  for (int o = kLanes / 2; o > 0; o >>= 1) s_new += __shfl_xor_sync(0xffffffffu, s_new, o);

  // Logits of the thread's rows; every lane of a row group gets its row's sum.
  float s[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    float kv[kVec];
    unpack(kr[i], kv);
    s[i] = 0.f;
#pragma unroll
    for (int e = 0; e < kVec; ++e) s[i] = fmaf(qv[e], kv[e], s[i]);
  }
#pragma unroll
  for (int o = kLanes / 2; o > 0; o >>= 1)
#pragma unroll
    for (int i = 0; i < kRows; ++i) s[i] += __shfl_xor_sync(0xffffffffu, s[i], o);
  float mx = rank == 0 ? s_new : -CUDART_INF_F;
#pragma unroll
  for (int i = 0; i < kRows; ++i)
    if (r_first + i * kStride < n) mx = fmaxf(mx, s[i]);

  // The row max: the block's (its warps in shared memory), then each CTA's
  // into every rank's cmax; after one cluster barrier every thread takes
  // the max over the C values.
  mx = norma::warp_max(mx);
  if (lane == 0) wred[warp] = mx;
  __syncthreads();
  norma::cluster_wait();  // every CTA of the cluster has started
  if (tid < C) {
    float v = wred[0];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) v = fmaxf(v, wred[w]);
    cluster.map_shared_rank(cmax, tid)[rank] = v;
  }
  cluster.sync();
  float m = cmax[0];
  for (int i = 1; i < C; ++i) m = fmaxf(m, cmax[i]);

  // p = exp(s - m) against the global max, l, and sum_t bf16(p_t) v_t.
  float acc[kVec], l = 0.f;
#pragma unroll
  for (int e = 0; e < kVec; ++e) acc[e] = 0.f;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    if (r_first + i * kStride < n) {
      const float p = expf(s[i] - m);
      if (c == 0) l += p;
      const float pr = round_to<T>(p);
      float vv[kVec];
      unpack(vr[i], vv);
#pragma unroll
      for (int e = 0; e < kVec; ++e) acc[e] = fmaf(pr, vv[e], acc[e]);
    }
  }
#pragma unroll
  for (int o = kLanes; o < 32; o <<= 1)
#pragma unroll
    for (int e = 0; e < kVec; ++e) acc[e] += __shfl_xor_sync(0xffffffffu, acc[e], o);
  l = norma::warp_sum(l);
  // The CTA's part (its warps in order) into rank 0's shared memory.
  if (slot == 0)
#pragma unroll
    for (int e = 0; e < kVec; ++e) wpart[warp][c * kVec + e] = acc[e];
  if (lane == 0) wred[warp] = l;
  __syncthreads();
  float* psum = part + C * DH;
  if (tid < DH) {
    float o = wpart[0][tid];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) o += wpart[w][tid];
    cluster.map_shared_rank(part, 0)[rank * DH + tid] = o;
  }
  if (tid == 0) {
    float lt = wred[0];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) lt += wred[w];
    cluster.map_shared_rank(psum, 0)[rank] = lt;
  }
  cluster.sync();

  // Rank 0: the parts in rank order, the new row, the writes.
  if (rank == 0 && tid < DH) {
    float o = 0.f, lt = 0.f;
    for (int r = 0; r < C; ++r) {
      o += part[r * DH + tid];
      lt += psum[r];
    }
    const float p_new = expf(s_new - m);
    o = (o + p_new * to_f(vn_t)) / (lt + p_new);
    out[(size_t)b * D + (size_t)h * DH + tid] = from_f<T>(o);
    // In-place write-back of the new row (li, b, pos) for this head.
    cache_k[li * ck_sl + b * ck_sb + (size_t)pos * D + h * DH + tid] = kn_t;
    cache_v[li * cv_sl + b * cv_sb + (size_t)pos * D + h * DH + tid] = vn_t;
  }
}

template <typename T, int DH>
int launch(const void* q, const void* k_new, const void* v_new, void* ck, void* cv, void* out,
           long long q_sb, long long kn_sb, long long vn_sb, long long ck_sl, long long ck_sb,
           long long cv_sl, long long cv_sb, int li, int pos, const long long* pos_ptr, int t_len,
           int B, int H, int cluster, float scale, cudaStream_t stream) {
  // The CTAs' shares, from the crop, not the position, must fit the rows a
  // CTA holds, so that one launch shape serves every position of a
  // captured graph's chunk.
  constexpr int kStride = kWarps * 32 / (DH * (int)sizeof(T) / 16);
  if ((long long)kRows * kStride * cluster < t_len - 1) return (int)cudaErrorInvalidValue;
  auto kern = self_decode_kernel<T, DH>;
  const int smem = 4 * cluster * (DH + 1);
  // Set per device (the first launches of a shape are eager, before any
  // graph captures them).
  static norma::FuncAttrs attrs;
  if (const cudaError_t e = attrs.ensure(kern, smem, cluster > 8); e != cudaSuccess) return (int)e;
  // One CTA per (row, head) launches without the cluster attribute (each
  // CTA is then its own cluster of one).
  return (int)norma::wstream::launch_cluster_grid(
      kern, dim3(cluster, H, B), cluster > 1 ? cluster : 0, kThreads, smem, stream, (const T*)q,
      (const T*)k_new, (const T*)v_new, (T*)ck, (T*)cv, (T*)out, q_sb, kn_sb, vn_sb, ck_sl, ck_sb, cv_sl,
      cv_sb, li, pos, pos_ptr, t_len, H, scale);
}

template <typename T>
int launch_dh(int dh, const void* q, const void* k_new, const void* v_new, void* ck, void* cv,
              void* out, long long q_sb, long long kn_sb, long long vn_sb, long long ck_sl,
              long long ck_sb, long long cv_sl, long long cv_sb, int li, int pos,
              const long long* pos_ptr, int t_len, int B, int H, int cluster, float scale,
              cudaStream_t stream) {
#define NORMA_SELF_DECODE(DH)                                                                   \
  case DH:                                                                                      \
    return launch<T, DH>(q, k_new, v_new, ck, cv, out, q_sb, kn_sb, vn_sb, ck_sl, ck_sb, cv_sl, \
                         cv_sb, li, pos, pos_ptr, t_len, B, H, cluster, scale, stream)
  switch (dh) {
    NORMA_SELF_DECODE(32);
    NORMA_SELF_DECODE(64);
    NORMA_SELF_DECODE(128);
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef NORMA_SELF_DECODE
}

}  // namespace

// `cluster` CTAs per (row, head): ops/self_decode.py::self_decode_plan.
extern "C" int norma_self_decode(const void* q, const void* k_new, const void* v_new,
                                 void* cache_k, void* cache_v, void* out,
                                 long long q_sb, long long kn_sb, long long vn_sb,
                                 long long ck_sl, long long ck_sb, long long cv_sl,
                                 long long cv_sb, int li, int pos, const long long* pos_ptr,
                                 int B, int H, int dh, int T, int is_bf16, int cluster,
                                 float scale, void* stream) {
  // A host position is checked here; a device one (pos_ptr) in the kernel.
  if (T < 1 || (pos_ptr == nullptr && (pos < 0 || pos >= T)) || cluster < 1 ||
      cluster > kMaxCluster || B > 65535 || H > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16)
    return launch_dh<__nv_bfloat16>(dh, q, k_new, v_new, cache_k, cache_v, out, q_sb, kn_sb, vn_sb,
                                    ck_sl, ck_sb, cv_sl, cv_sb, li, pos, pos_ptr, T, B, H, cluster,
                                    scale, s);
  return launch_dh<float>(dh, q, k_new, v_new, cache_k, cache_v, out, q_sb, kn_sb, vn_sb, ck_sl,
                          ck_sb, cv_sl, cv_sb, li, pos, pos_ptr, T, B, H, cluster, scale, s);
}
