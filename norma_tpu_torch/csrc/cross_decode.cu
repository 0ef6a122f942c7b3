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
//   p[t] = exp(s[t] - max s);  l = sum_t p[t]      (f32, over the whole row)
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
// into one byte, [L, B, H, Ta/2, dh].  The layer index `li` and the layer /
// stream strides are arguments: the stacked arrays are never sliced.
//
// What bounds it on the H100: reading the codes, 2 * B * Ta * D bytes per
// layer per step (3.84 MB at B=1, 31 MB at B=8, int8; half that int4),
// i.e. HBM bandwidth, 1.1-9.2 us.  The G rungs of a stream share one read
// of its codes.  The first design (one 256-thread CTA per (stream, head):
// 20 CTAs at B=1; G FMAs per code byte on CUDA cores from G-templated
// register arrays, which spilled at G = 4-8) took 3-40x its bytes.  The
// codes at B=8 exceed all SMs' shared memory together, so a design that
// stages them runs in waves.
//
// Design (ops/paged_cross.py::cross_decode_plan gives the launch shape):
//   - A thread-block cluster of C CTAs of 4 warps per (stream, head), grid
//     (C, H, B), C from the plan (2 at 8 streams, 4-8 at one).  CTA `rank`
//     takes the stored code rows [rank * R / C, (rank + 1) * R / C) of R
//     (Ta, or Ta/2 for int4).  Small CTAs keep every cluster resident at
//     once: 160 CTAs of 8 warps at one per (stream, head) left 28 SMs with
//     twice the work, and clusters of them started in waves.
//   - Warp w takes the CTA's 16-key tiles w, w + 4, ... and streams their
//     codes through registers as 16-byte (K) and 8-byte (V) loads, kDepth
//     = 4 tiles of each in flight; the first V tiles are issued on entry
//     with the first K tiles, so they land during the logits and the
//     cluster's max.  Only the f32 logits live in shared memory, so every
//     CTA stays resident.
//   - Logits and PV run on tensor cores as mma.sync.m16n8k16 bf16 with f32
//     accumulators; codes widen to bf16 exactly in registers
//     (wstream.cuh::s8pair_bf16 / s4pair_bf16), and a bf16 q' times an
//     integer code is exact in f32, so only the order of the sums differs
//     from the plain version.  Logits: A = 16 key rows x 16 channels of K
//     codes, B = 16 channels x 8 rungs of q' (zero past G): one MMA serves
//     every rung, so nothing is templated on G.  A thread's four
//     contraction slots are channels 16 tq + 4 s + (0, 2, 1, 3) -- one
//     16-byte load per key row feeds all four k-steps.  For int4 the A rows
//     g and g + 8 are the low and high nibbles of one stored row, so one
//     load feeds both.  PV: A = 16 channels x 16 keys of V^T (a thread's 8
//     channels of four key rows, bytes paired by __byte_perm; int4: the two
//     nibbles of one byte are the pair), B = bf16(p) 16 keys x 8 rungs.  A
//     warp's PV steps are its own tiles' keys, whose logits it wrote.
//   - The softmax is exact and two-pass over the whole row: each warp
//     writes its per-rung max into every CTA's shared memory; after one
//     cluster barrier every thread takes its rung's max over all of them,
//     so every p = exp(s - m) is taken against the global max before its
//     bf16 rounding.  Each CTA's partial o[G][64] (its warps added in order)
//     and sums go to the ranks that finish them, each rank a slice of the
//     outputs, which after a second barrier adds the ranks' parts in rank
//     order.  The result is the same from run to run.
#include <cooperative_groups.h>
#include <cuda_bf16.h>

#include "common.cuh"
#include "wstream.cuh"

namespace cg = cooperative_groups;

namespace {

using norma::wstream::bf16x2_bits;
using norma::wstream::mma_bf16;
using norma::wstream::s4pair_bf16;
using norma::wstream::s8pair_bf16;
using norma::wstream::word_of;

constexpr int kThreads = 128, kWarps = kThreads / 32, DH = 64, kMaxG = 8, kMaxCluster = 16;
constexpr int kDepth = 4;  // tiles of a warp's loads in flight

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

// 16- and 8-byte loads of codes, read-only for the launch.
__device__ __forceinline__ uint4 ld16(const void* p) {
  uint4 v;
  asm volatile("ld.global.nc.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p));
  return v;
}
__device__ __forceinline__ uint2 ld8(const void* p) {
  uint2 v;
  asm volatile("ld.global.nc.v2.u32 {%0, %1}, [%2];\n" : "=r"(v.x), "=r"(v.y) : "l"(p));
  return v;
}

// Dynamic shared memory: the [G][pitch] f32 logits of the CTA's keys.
template <typename T, bool INT4>
__global__ void __launch_bounds__(kThreads) cross_decode_kernel(
    const T* __restrict__ q, long long q_rs, const int8_t* __restrict__ kc,
    const int8_t* __restrict__ vc, long long c_sl, long long c_sb,
    const float* __restrict__ ks, const float* __restrict__ vs, long long s_sl,
    long long s_sb, T* __restrict__ out, long long o_rs, int li, int B, int Ta, int G, int pitch,
    float scale) {
  constexpr int kTileRows = INT4 ? 8 : 16;  // stored rows per 16 keys
  constexpr int KW = INT4 ? 1 : 2;          // a thread's 16-byte K loads per tile
  constexpr int VW = INT4 ? 2 : 4;          // its 8-byte V loads per step
  extern __shared__ __align__(16) float lg[];
  __shared__ float qs[kMaxG][DH];             // q', zero past G
  __shared__ float slots[kWarps][kMaxG][DH];  // the warps' partial o
  __shared__ float wl[kWarps][kMaxG];         // the warps' partial sums
  __shared__ float wmax[kMaxCluster * kWarps][kMaxG];  // every warp's max, by (rank, warp)
  __shared__ float recv[kMaxG * DH + kMaxCluster];     // the ranks' parts of this rank's outputs
  __shared__ float lrecv[kMaxCluster][kMaxG];          // the ranks' sums
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  norma::cluster_arrive_relaxed();
  const int h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g8 = lane >> 2, tq = lane & 3;
  const int R = INT4 ? Ta / 2 : Ta;  // stored rows per (b, h)
  const int r0 = (int)((long long)rank * R / C);
  const int rows = (int)((long long)(rank + 1) * R / C) - r0;
  const int nk = INT4 ? 2 * rows : rows;  // this CTA's keys
  const size_t blk = (size_t)li * c_sl + (size_t)b * c_sb + ((size_t)h * R + r0) * DH;
  const int8_t* kcb = kc + blk;
  const int8_t* vcb = vc + blk;
  // Tile (and PV step) t = warp + kWarps * k of the CTA's 16-key tiles.
  const int tiles = (rows + kTileRows - 1) / kTileRows;
  const int kt = tiles > warp ? (tiles - warp + kWarps - 1) / kWarps : 0;

  // The K fragments of tile k: stored rows rb + g8 (+ 8 for int8), the
  // 16 bytes of chunk tq; zero past the range.
  auto load_k = [&](uint4 (&f)[KW], int k) {
    const int rb = (warp + kWarps * k) * kTileRows;
#pragma unroll
    for (int w = 0; w < KW; ++w) {
      const int r = rb + g8 + 8 * w;
      f[w] = (k < kt && r < rows) ? ld16(kcb + (size_t)r * DH + 16 * tq) : make_uint4(0, 0, 0, 0);
    }
  };
  // The V fragments of step k: 8 bytes (channels 8 g8 ..) of stored rows
  // kb + tq + 4 i (int8, kb = 16 t) or kb/2 + tq + 4 i (int4).
  auto load_v = [&](uint2 (&f)[VW], int k) {
    const int rb = (warp + kWarps * k) * kTileRows;
#pragma unroll
    for (int i = 0; i < VW; ++i) {
      const int r = rb + tq + 4 * i;
      f[i] = (k < kt && r < rows) ? ld8(vcb + (size_t)r * DH + 8 * g8) : make_uint2(0, 0);
    }
  };
  // The first kDepth tiles of K and steps of V in flight from the start:
  // V lands during the logits and the cluster's max.
  uint4 kf[kDepth][KW];
  uint2 vf[kDepth][VW];
#pragma unroll
  for (int j = 0; j < kDepth; ++j) load_k(kf[j], j);
#pragma unroll
  for (int j = 0; j < kDepth; ++j) load_v(vf[j], j);

  // q fold: (q * k_scale) * dh**-0.5 in f32, rounded to bf16.
  const float* ksr = ks + (size_t)li * s_sl + (size_t)b * s_sb + h * DH;
  const float* vsr = vs + (size_t)li * s_sl + (size_t)b * s_sb + h * DH;
  for (int i = tid; i < kMaxG * DH; i += kThreads) {
    const int g = i / DH, d = i % DH;
    float v = 0.f;
    if (g < G) {
      const float qv = to_f(q[(size_t)(g * B + b) * q_rs + h * DH + d]);
      v = bf16_round(__fmul_rn(__fmul_rn(qv, ksr[d]), scale));
    }
    qs[g][d] = v;
  }
  __syncthreads();
  // The logits' B fragments: rung g8; k-step s takes channels
  // d0 = 16 tq + 4 s, slots (2tq, 2tq+1) = (d0, d0+2), (2tq+8, 2tq+9) =
  // (d0+1, d0+3) -- bytes 0/2 and 1/3 of a code word, as s8pair_bf16 pairs them.
  uint32_t bq[4][2];
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    const float* qq = &qs[g8][16 * tq + 4 * s];
    bq[s][0] = bf16x2_bits(qq[0], qq[2]);
    bq[s][1] = bf16x2_bits(qq[1], qq[3]);
  }

  // Logits, the warp's tiles in turn with kDepth tiles of loads in flight.
  // D rows: int8 keys t0 + g8 and t0 + g8 + 8; int4 keys 2 (r + g8) and
  // 2 (r + g8) + 1.
  float mx0 = -CUDART_INF_F, mx1 = -CUDART_INF_F;  // rungs 2 tq, 2 tq + 1
  for (int k0 = 0; k0 < kt; k0 += kDepth) {
#pragma unroll
    for (int j = 0; j < kDepth; ++j) {
      const int k = k0 + j;
      if (k >= kt) break;
      const int rb = (warp + kWarps * k) * kTileRows;
      float d[4] = {0.f, 0.f, 0.f, 0.f};
      int k0r, k1r;
      if constexpr (INT4) {
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          const uint32_t u = word_of(kf[j][0], s);
          const uint32_t a[4] = {s4pair_bf16(u), s4pair_bf16(u >> 4), s4pair_bf16(u >> 8), s4pair_bf16(u >> 12)};
          mma_bf16(d, a, bq[s][0], bq[s][1]);
        }
        k0r = 2 * (rb + g8);
        k1r = k0r + 1;
      } else {
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          const uint32_t u0 = word_of(kf[j][0], s), u1 = word_of(kf[j][KW - 1], s);
          const uint32_t a[4] = {s8pair_bf16(u0), s8pair_bf16(u1), s8pair_bf16(u0 >> 8), s8pair_bf16(u1 >> 8)};
          mma_bf16(d, a, bq[s][0], bq[s][1]);
        }
        k0r = rb + g8;
        k1r = k0r + 8;
      }
      load_k(kf[j], k + kDepth);
      const int c0 = 2 * tq, c1 = 2 * tq + 1;
      if (k0r < nk) {
        if (c0 < G) { lg[c0 * pitch + k0r] = d[0]; mx0 = fmaxf(mx0, d[0]); }
        if (c1 < G) { lg[c1 * pitch + k0r] = d[1]; mx1 = fmaxf(mx1, d[1]); }
      }
      if (k1r < nk) {
        if (c0 < G) { lg[c0 * pitch + k1r] = d[2]; mx0 = fmaxf(mx0, d[2]); }
        if (c1 < G) { lg[c1 * pitch + k1r] = d[3]; mx1 = fmaxf(mx1, d[3]); }
      }
    }
  }
  // Each warp's max per rung (the lanes of one tq hold the same rungs) into
  // every rank's wmax; after one cluster barrier each thread reduces its
  // rung's C x kWarps values with the three other lanes of its rung.
#pragma unroll
  for (int o = 4; o < 32; o <<= 1) {
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, o));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, o));
  }
  norma::cluster_wait();  // every CTA of the cluster has started
  for (int r = g8; r < C; r += 8) {
    float* dst = cluster.map_shared_rank(&wmax[0][0], r) + (rank * kWarps + warp) * kMaxG + 2 * tq;
    dst[0] = mx0;
    dst[1] = mx1;
  }
  cluster.sync();
  float m = -CUDART_INF_F;
  for (int i = tq; i < C * kWarps; i += 4) m = fmaxf(m, wmax[i][g8]);
  m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
  m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));

  // PV: o^T[64 channels][8 rungs] += V^T (16 channels x 16 keys) x bf16(p)
  // (16 keys x 8 rungs), the warp's steps (its own tiles' keys, whose
  // logits it wrote) in turn.  Each p = exp(s - m) against the global max
  // is taken once, by the lane that feeds it to the B fragment (rung g8),
  // which also adds it to l.  Fragment j (0..3) holds channels 8 g8 + 2 j
  // (A row g8) and 8 g8 + 2 j + 1 (row g8 + 8).
  float acc[4][4], l = 0.f;
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  const bool live = g8 < G;
  const float* prow = lg + (live ? g8 : 0) * pitch;
  auto p_at = [&](int k) {
    const float p = (live && k < nk) ? expf(prow[k] - m) : 0.f;
    l += p;
    return p;
  };
  for (int k0 = 0; k0 < kt; k0 += kDepth) {
#pragma unroll
    for (int jd = 0; jd < kDepth; ++jd) {
      const int k = k0 + jd;
      if (k >= kt) break;
      const int kb = 16 * (warp + kWarps * k);
      const uint2(&R)[VW] = vf[jd];
      if constexpr (INT4) {
        // Slots are the keys themselves: 2 tq, 2 tq + 1 of stored row
        // kb/2 + tq (R[0]), and 2 tq + 8, 2 tq + 9 of stored row kb/2 + tq + 4 (R[1]).
        const float p0 = p_at(kb + 2 * tq), p1 = p_at(kb + 2 * tq + 1);
        const float p2 = p_at(kb + 2 * tq + 8), p3 = p_at(kb + 2 * tq + 9);
        const uint32_t b0 = bf16x2_bits(p0, p1), b1 = bf16x2_bits(p2, p3);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const uint32_t w0 = (j >> 1) ? R[0].y : R[0].x, w1 = (j >> 1) ? R[1].y : R[1].x;
          const int e = 2 * (j & 1);
          // byte e's low nibble to bits 0-3 and its high nibble to bits 16-19
          const uint32_t a[4] = {s4pair_bf16(__byte_perm(w0, w0 >> 4, ((4 + e) << 8) | e)),
                                 s4pair_bf16(__byte_perm(w0, w0 >> 4, ((5 + e) << 8) | (e + 1))),
                                 s4pair_bf16(__byte_perm(w1, w1 >> 4, ((4 + e) << 8) | e)),
                                 s4pair_bf16(__byte_perm(w1, w1 >> 4, ((5 + e) << 8) | (e + 1)))};
          mma_bf16(acc[j], a, b0, b1);
        }
      } else {
        // Slots (2tq, 2tq+1, 2tq+8, 2tq+9) are keys tq + (0, 4, 8, 12): R[0..3].
        const float p0 = p_at(kb + tq), p1 = p_at(kb + tq + 4);
        const float p2 = p_at(kb + tq + 8), p3 = p_at(kb + tq + 12);
        const uint32_t b0 = bf16x2_bits(p0, p1), b1 = bf16x2_bits(p2, p3);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const uint32_t sel = (j & 1) ? 0x7632u : 0x5410u;
          const uint32_t p01 = __byte_perm((j >> 1) ? R[0].y : R[0].x, (j >> 1) ? R[1].y : R[1].x, sel);
          const uint32_t p23 = __byte_perm((j >> 1) ? R[2].y : R[2].x, (j >> 1) ? R[3].y : R[3].x, sel);
          const uint32_t a[4] = {s8pair_bf16(p01), s8pair_bf16(p01 >> 8), s8pair_bf16(p23), s8pair_bf16(p23 >> 8)};
          mma_bf16(acc[j], a, b0, b1);
        }
      }
      load_v(vf[jd], k + kDepth);
    }
  }
  // acc[j] = o[8 g8 + 2 j][2 tq], o[..][2 tq + 1], o[8 g8 + 2 j + 1][2 tq], [..][2 tq + 1].
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int ch = 8 * g8 + 2 * j;
    slots[warp][2 * tq][ch] = acc[j][0];
    slots[warp][2 * tq + 1][ch] = acc[j][1];
    slots[warp][2 * tq][ch + 1] = acc[j][2];
    slots[warp][2 * tq + 1][ch + 1] = acc[j][3];
  }
  l += __shfl_xor_sync(0xffffffffu, l, 1);
  l += __shfl_xor_sync(0xffffffffu, l, 2);
  if (tq == 0) wl[warp][g8] = l;
  __syncthreads();
  // The CTA's part (its warps in order) of output i goes to the rank that
  // finishes i: rank r finishes [r E / C, (r + 1) E / C) of the E = G x 64
  // outputs, its buffer holding each rank's part of them in rank order.
  const int E = G * DH, slen = (E + C - 1) / C;
  for (int i = tid; i < E; i += kThreads) {
    float o = slots[0][i / DH][i % DH];
    for (int w = 1; w < kWarps; ++w) o += slots[w][i / DH][i % DH];
    const int owner = ((i + 1) * C - 1) / E;
    cluster.map_shared_rank(recv, owner)[rank * slen + i - owner * E / C] = o;
  }
  if (tid < G) {
    float lt = wl[0][tid];
    for (int w = 1; w < kWarps; ++w) lt += wl[w][tid];
    for (int r = 0; r < C; ++r) cluster.map_shared_rank(&lrecv[0][0], r)[rank * kMaxG + tid] = lt;
  }
  cluster.sync();

  // This rank's outputs: the ranks' parts in rank order, then (o / l) * v_scale.
  const int e0 = rank * E / C, e1 = (rank + 1) * E / C;
  for (int i = e0 + tid; i < e1; i += kThreads) {
    const int g = i / DH, d = i % DH;
    float o = 0.f, lt = 0.f;
    for (int r = 0; r < C; ++r) {
      o += recv[r * slen + i - e0];
      lt += lrecv[r][g];
    }
    out[(size_t)(g * B + b) * o_rs + h * DH + d] = from_f<T>(__fmul_rn(o / lt, vsr[d]));
  }
}

template <typename T, bool INT4>
int launch(const void* q, long long q_rs, const void* kc, const void* vc, long long c_sl,
           long long c_sb, const void* ks, const void* vs, long long s_sl, long long s_sb,
           void* out, long long o_rs, int li, int B, int H, int G, int Ta, int cluster, int pitch,
           float scale, cudaStream_t stream) {
  const int smem = 4 * G * pitch;
  auto kern = cross_decode_kernel<T, INT4>;
  // The largest shared memory and cluster set so far (the first launches
  // of a shape are eager, before any graph captures them).
  static int sized = 0;
  static bool wide = false;
  if (smem > sized) {
    const cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    sized = smem;
  }
  if (cluster > 8 && !wide) {
    const cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return (int)e;
    wide = true;
  }
  // One CTA per (stream, head) launches without the cluster attribute (each
  // CTA is then its own cluster of one).
  return (int)norma::wstream::launch_cluster_grid(
      kern, dim3(cluster, H, B), cluster > 1 ? cluster : 0, kThreads, smem, stream, (const T*)q, q_rs, (const int8_t*)kc,
      (const int8_t*)vc, c_sl, c_sb, (const float*)ks, (const float*)vs, s_sl, s_sb, (T*)out, o_rs, li, B,
      Ta, G, pitch, scale);
}

}  // namespace

// `cluster` CTAs per (stream, head), each with [G][pitch] f32 logits
// (pitch >= the keys of its share, rounded up to 16):
// ops/paged_cross.py::cross_decode_plan.
extern "C" int norma_cross_decode(const void* q, long long q_rs, const void* kc, const void* vc,
                                  long long c_sl, long long c_sb, const void* ks,
                                  const void* vs, long long s_sl, long long s_sb, void* out,
                                  long long o_rs, int li, int B, int H, int dh, int G, int Ta,
                                  int is_bf16, int is_int4, int cluster, int pitch, float scale,
                                  void* stream) {
  const long long R = is_int4 ? Ta / 2 : Ta;
  if (dh != DH || G < 1 || G > kMaxG || Ta < 1 || (is_int4 && Ta % 2) || cluster < 1 ||
      cluster > kMaxCluster || pitch < ((R + cluster - 1) / cluster + 15) / 16 * 16 * (is_int4 ? 2 : 1) ||
      B > 65535 || H > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
#define NORMA_CROSS(T, I4)                                                                       \
  return launch<T, I4>(q, q_rs, kc, vc, c_sl, c_sb, ks, vs, s_sl, s_sb, out, o_rs, li, B, H, G, Ta, \
                       cluster, pitch, scale, s)
  if (is_bf16) {
    if (is_int4) NORMA_CROSS(__nv_bfloat16, true);
    NORMA_CROSS(__nv_bfloat16, false);
  }
  if (is_int4) NORMA_CROSS(float, true);
  NORMA_CROSS(float, false);
#undef NORMA_CROSS
}
