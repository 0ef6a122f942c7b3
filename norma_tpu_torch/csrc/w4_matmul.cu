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
// block's bf16 scale widened to f32, and the blocks are summed; the TPU
// kernel instead pre-scales the weights in bf16 (w * s rounded to bf16) and
// feeds the MXU.  So the gap to the plain PyTorch version
// (ops/quant_matmul.py::w4_matmul_torch) is f32 summation order only.
//
// What bounds it on the H100: bytes.  The packed head is 640 x 51866 B =
// 33 MB plus 2 MB of scales (~11 us at 3.35 TB/s); at the decode step's
// few rows each code byte meets at most 2 M multiply-adds.
//
// Design (wstream.cuh, shared with w8_matmul.cu): one launch per product,
// no workspace.
//   - Each block owns 128 output columns and up to 8 * RT rows (RT = 1, 2
//     or 4 tiles of 8 rows): up to 32 rows every code byte is read from
//     device memory once.
//   - The K/2 packed rows form K/2/blk units, one scale block of each half.
//     The block's W warps (4-6) and a thread-block cluster of C blocks share
//     the units evenly.  Each warp streams its units through a private
//     shared-memory ring of cp.async 16-byte copies: stages of 32 packed rows
//     of codes (pitched rows, 16-byte aligned) with the matching x columns of
//     both halves, a unit's blk / 32 stages resident at once.
//   - Products run on tensor cores as mma.sync.m16n8k16 bf16 over the
//     transposed problem, as in w8.  The nibbles widen to bf16 exactly from
//     shared memory: (n & 15) ^ 8 under the exponent of 128 is 136 + v, and
//     one bf16x2 FMA subtracts 136.  The low nibbles feed the fragments for k
//     in the first half against x columns k, the high nibbles those for
//     k + K/2.  A unit runs its low half into a zeroed f32 fragment, which is
//     multiplied by the low block's scales and added to the thread's total,
//     then its high half the same way.
//   - f32 x is split exactly into three bf16 parts (24 bits) and runs three
//     products per fragment on the same widened codes.
//   - The totals meet in a fixed order (warps, then the cluster's blocks
//     through distributed shared memory); no atomics.  At RT = 4 the
//     thread's total lives in shared memory (registers hold the unit's
//     fragment only).
// Code rows must start 16-byte aligned (ldq a multiple of 16:
// ops/quant_matmul.py::pitched_codes), blk 32 or 64 (a unit's stages fit
// the ring beside the next one's first), and K/2 a multiple of blk.
#include "common.cuh"
#include "wstream.cuh"

namespace {

using namespace norma::wstream;

constexpr int kMaxWarps = 6;
constexpr int kMaxSmem = 232448;  // bytes of shared memory a block may use

template <int RT, bool F32X>
struct Shape4 {
  static constexpr int kRows = 8 * RT;                  // x rows per block
  static constexpr int kXHalf = kKB * (F32X ? 4 : 2);   // x bytes per row, stage and half
  static constexpr int kXRow = 2 * kXHalf;
  static constexpr int kXChunks = kXRow / 16;
  static constexpr int kStages = (RT == 4 && F32X) ? 3 : 4;  // ring depth per warp
  static constexpr int kStage = kCodeStage + kRows * kXRow;
  static constexpr int kWarpRing = kStages * kStage;
  static constexpr bool kTotSmem = RT == 4;              // the totals in shared memory
  static constexpr int kTotWarp = kTotSmem ? RT * 8 * 32 * 16 : 0;  // their bytes per warp
  static constexpr int kTile = kRows * kBN;              // f32 outputs per block
  static constexpr int smem(int warps) {
    const int ring = warps * (kWarpRing + kTotWarp), slots = warps * kTile * 4;
    return ring > slots ? ring : slots;
  }
};

template <int RT, bool F32X>
__global__ void __launch_bounds__(kMaxWarps * 32) w4_mma_kernel(
    const void* __restrict__ x, const int8_t* __restrict__ q, const __nv_bfloat16* __restrict__ scale,
    float* __restrict__ out, int M, int N, int K, long long ldq, int blk) {
  using S = Shape4<RT, F32X>;
  constexpr int XP = F32X ? 3 : 1;  // bf16 parts of x
  constexpr int XB = F32X ? 4 : 2;  // bytes per x value
  constexpr int kStages = S::kStages;
  extern __shared__ __align__(128) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, W = blockDim.x >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const int n0 = (blockIdx.x / C) * kBN, m0 = blockIdx.y * S::kRows;
  const int half = K / 2, npb = half / blk, G = blk / kKB;

  // This warp's units: the cluster's warps share them evenly (one more for
  // the first npb % warps).
  const int nw = C * W, u = rank * W + warp;
  const int u_begin = u * (npb / nw) + min(u, npb % nw);
  const int u_end = u_begin + npb / nw + (u < npb % nw ? 1 : 0);
  const int s_begin = u_begin * G, s_end = u_end * G;
  unsigned char* ring = smem + warp * S::kWarpRing;
  float4* tot_s = reinterpret_cast<float4*>(smem + W * S::kWarpRing + warp * S::kTotWarp) + lane;

  auto issue = [&](int st, int slot) {
    if (st < s_end) {
      const uint32_t base = smem_addr(ring + slot * S::kStage);
      const int k0 = st * kKB;
      issue_codes(base, q, ldq, k0, half, n0, N, lane);
      // x: kRows rows x (low half, high half) chunks, zeros past M.
      constexpr int kHC = S::kXChunks / 2;
      for (int i = lane; i < S::kRows * S::kXChunks; i += 32) {
        const int rho = i / S::kXChunks, c = i % S::kXChunks;
        const int m = m0 + rho, k = (c / kHC) * half + k0 + (c % kHC) * (16 / XB);
        const bool ok = m < M;
        const int phys = F32X ? (c ^ ((rho & 1) << 2)) : (c ^ ((rho & 3) << 1));
        cp16(base + kCodeStage + rho * S::kXRow + (phys << 4),
             ok ? static_cast<const char*>(x) + ((size_t)m * K + k) * XB : x, ok);
      }
    }
    cp_commit();
  };

  float tot[S::kTotSmem ? 1 : RT][8][4];
  if constexpr (S::kTotSmem) {
#pragma unroll
    for (int e = 0; e < RT * 8; ++e) tot_s[32 * e] = make_float4(0.f, 0.f, 0.f, 0.f);
  } else {
    zero(tot);
  }

#pragma unroll
  for (int p = 0; p < kStages - 1; ++p) issue(s_begin + p, p);
  for (int unit = u_begin; unit < u_end; ++unit) {
    const int i = (unit - u_begin) * G;  // the unit's first stage, counted from s_begin
    // Scales of the unit's low block (unit) and high block (npb + unit) at
    // the thread's columns 16 g + 2 j (+1), as bf16 pairs.
    uint32_t sc[2][8];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const unsigned short* srow =
          reinterpret_cast<const unsigned short*>(scale) + (size_t)(h * npb + unit) * N;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int n = n0 + 16 * g + 2 * j;
        const uint32_t s0 = n < N ? __ldg(srow + n) : 0u, s1 = n + 1 < N ? __ldg(srow + n + 1) : 0u;
        sc[h][j] = s0 | (s1 << 16);
      }
    }
    // Committed: kStages - 1 + i groups; the unit needs the first i + G.
    if (G == 1) cp_wait<kStages - 2>(); else cp_wait<kStages - 3>();
    __syncwarp();
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float acc[RT][8][4];
      zero(acc);
      for (int gs = 0; gs < G; ++gs) {
        const unsigned char* stage = ring + ((i + gs) % kStages) * S::kStage;
        const unsigned char* xs = stage + kCodeStage;
#pragma unroll
        for (int s = 0; s < kKB / 16; ++s) {
          uint4 R[4];
          load_codes(R, stage, s, g, tq);
          // B fragments: x[8 t + g][h * K/2 + k0 + 16 s + 4 tq .. + 3].
          uint32_t bx[RT][XP][2];
#pragma unroll
          for (int t = 0; t < RT; ++t) {
            const int rho = 8 * t + g;
            if constexpr (F32X) {
              const int phys = (8 * h + 4 * s + tq) ^ ((rho & 1) << 2);
              split_x<XP>(*reinterpret_cast<const float4*>(xs + rho * S::kXRow + (phys << 4)), bx[t]);
            } else {
              const int phys = (4 * h + 2 * s + (tq >> 1)) ^ ((rho & 3) << 1);
              const uint2 v = *reinterpret_cast<const uint2*>(xs + rho * S::kXRow + (phys << 4) + (tq & 1) * 8);
              bx[t][0][0] = v.x;
              bx[t][0][1] = v.y;
            }
          }
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            uint32_t p01, p23;
            fragment_bytes(R, j, p01, p23);
            const uint32_t a[4] = {s4pair_bf16(p01 >> (4 * h)), s4pair_bf16(p01 >> (4 * h + 8)),
                                   s4pair_bf16(p23 >> (4 * h)), s4pair_bf16(p23 >> (4 * h + 8))};
#pragma unroll
            for (int t = 0; t < RT; ++t)
#pragma unroll
              for (int p = 0; p < XP; ++p) mma_bf16(acc[t][j], a, bx[t][p][0], bx[t][p][1]);
          }
        }
      }
      // The block's sums times their columns' scales, into the total.
#pragma unroll
      for (int t = 0; t < RT; ++t)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float s0 = __uint_as_float(sc[h][j] << 16), s1 = __uint_as_float(sc[h][j] & 0xFFFF0000u);
          if constexpr (S::kTotSmem) {
            float4 v = tot_s[32 * (8 * t + j)];
            v.x = fmaf(acc[t][j][0], s0, v.x);
            v.y = fmaf(acc[t][j][1], s0, v.y);
            v.z = fmaf(acc[t][j][2], s1, v.z);
            v.w = fmaf(acc[t][j][3], s1, v.w);
            tot_s[32 * (8 * t + j)] = v;
          } else {
            tot[t][j][0] = fmaf(acc[t][j][0], s0, tot[t][j][0]);
            tot[t][j][1] = fmaf(acc[t][j][1], s0, tot[t][j][1]);
            tot[t][j][2] = fmaf(acc[t][j][2], s1, tot[t][j][2]);
            tot[t][j][3] = fmaf(acc[t][j][3], s1, tot[t][j][3]);
          }
        }
    }
    __syncwarp();  // the unit's slots are read: the next issues may overwrite them
    for (int gs = 0; gs < G; ++gs) issue(s_begin + i + kStages - 1 + gs, (i + kStages - 1 + gs) % kStages);
  }
  if constexpr (S::kTotSmem) {
    float all[RT][8][4];
#pragma unroll
    for (int t = 0; t < RT; ++t)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float4 v = tot_s[32 * (8 * t + j)];
        all[t][j][0] = v.x;
        all[t][j][1] = v.y;
        all[t][j][2] = v.z;
        all[t][j][3] = v.w;
      }
    reduce_store(all, smem, W, cluster, out, nullptr, M, N, m0, n0);
  } else {
    reduce_store(tot, smem, W, cluster, out, nullptr, M, N, m0, n0);
  }
}

template <int RT, bool F32X>
cudaError_t launch(const void* x, const void* q, const void* scale, void* out, int M, int N, int K,
                   long long ldq, int blk, int cluster, int warps, cudaStream_t stream) {
  using S = Shape4<RT, F32X>;
  auto* kernel = w4_mma_kernel<RT, F32X>;
  const int smem = S::smem(warps);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  static norma::FuncAttrs attrs;  // set per device (the first launches are eager)
  if (const cudaError_t e = attrs.ensure(kernel, smem, false); e != cudaSuccess) return e;
  return launch_cluster(kernel, (N + kBN - 1) / kBN, (M + S::kRows - 1) / S::kRows, cluster, warps * 32, smem,
                        stream, x, (const int8_t*)q, (const __nv_bfloat16*)scale, (float*)out, M, N, K, ldq, blk);
}

template <bool F32X>
cudaError_t launch_rt(int rt, const void* x, const void* q, const void* scale, void* out, int M, int N, int K,
                      long long ldq, int blk, int cluster, int warps, cudaStream_t s) {
  switch (rt) {
    case 1: return launch<1, F32X>(x, q, scale, out, M, N, K, ldq, blk, cluster, warps, s);
    case 2: return launch<2, F32X>(x, q, scale, out, M, N, K, ldq, blk, cluster, warps, s);
    case 4: return launch<4, F32X>(x, q, scale, out, M, N, K, ldq, blk, cluster, warps, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// x [M, K] contiguous (bf16 if is_bf16 else f32), 16-byte aligned; q [K/2, N]
// int8 with row pitch ldq (a multiple of 16 >= N, 16-byte aligned base);
// scale [K/blk, N] bf16, contiguous; out [M, N] f32.  blk is 32 or 64 and
// divides K/2.  rt (1, 2, 4) is the row tile in units of 8
// rows, cluster (1, 2, 4 or 8) blocks of `warps` warps (4-6) share the
// K/2/blk units.
extern "C" int norma_w4_matmul(const void* x, const void* q, const void* scale, void* out, int M, int N, int K,
                               long long ldq, int blk, int rt, int cluster, int warps, int is_bf16,
                               void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % 2 || (blk != kKB && blk != 2 * kKB) || (K / 2) % blk ||
      ldq < N || ldq % 16 || cluster < 1 || cluster > 8 || (cluster & (cluster - 1)) || warps < 1 ||
      warps > kMaxWarps || (reinterpret_cast<uintptr_t>(q) & 15) || (reinterpret_cast<uintptr_t>(x) & 15))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  return (int)(is_bf16 ? launch_rt<false>(rt, x, q, scale, out, M, N, K, ldq, blk, cluster, warps, s)
                       : launch_rt<true>(rt, x, q, scale, out, M, N, K, ldq, blk, cluster, warps, s));
}
