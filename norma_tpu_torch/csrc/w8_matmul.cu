// w8a16: y[M, N] = (x[M, K] @ q[K, N]) * s[N], int8 weights with one f32
// scale per output column, x bf16 or f32, f32 out.
//
// Replaces the TPU kernel norma_tpu/ops/quant_matmul.py::w8_matmul_pallas
// (pl.pallas_call at :75, body _w8_kernel at :45), which widens int8 tiles
// to bf16 in VMEM and runs the MXU.  Here it serves the int8 decoder layers
// (model/whisper.py::ldense / qkv_proj) and the int8 logits head on every
// decode step.
//
// What bounds it on the H100: the decode step has few rows (6 at one
// stream's ladder, 8 at a batch of 8, at most 16 on the speculative
// ladder), so each weight byte meets at most that many multiply-adds: the
// product is bound by the int8 bytes streamed from device memory (1.6-6.6
// MB per decoder matrix, 66 MB for the [1280, 51866] head; ~20 us for the
// head at 3.35 TB/s).
//
// Design: one launch per product, no workspace.
//   - Each block owns 128 output columns and up to 8 * RT rows (RT = 1, 2
//     or 4 tiles of 8 rows: up to 32 rows in one pass), so up to 32 rows
//     every code byte is read from device memory once.
//   - Its 4 warps split the contraction, and a thread-block cluster of C
//     blocks (1-8, the wrapper's plan) splits it further.  Each warp streams
//     its own K range through a private 4-stage shared-memory ring of
//     cp.async 16-byte copies (32 rows of codes and the matching x columns
//     per stage), so loads of later stages are in flight while it computes.
//   - Products run on tensor cores as mma.sync.m16n8k16 bf16 x bf16 -> f32
//     over the transposed problem: A = codes^T (16 output columns x 16 k),
//     B = x^T (16 k x 8 rows), so a row tile is 8 rows, not 16.  The codes
//     widen to bf16 exactly from shared memory (two LOP3 and one bf16x2 FMA
//     per pair: (128 + low 7 bits) + (-256 or -128)); bf16 x int8 products
//     are exact in f32.  A thread's four contraction indices of a fragment
//     are four consecutive k (the same permutation on A and B leaves the sum
//     unchanged), and its 16 output columns are 16 consecutive bytes of a
//     code row, so one 16-byte shared load feeds 8 fragments; the ring is
//     XOR-swizzled so that these loads are free of bank conflicts.
//   - f32 x is split exactly into three bf16 parts (hi + mid + lo, 24 bits)
//     and runs three products per fragment on the same widened codes.
//   - The sums meet in a fixed order: the block's warps through shared
//     memory, then the cluster's blocks through distributed shared memory,
//     each block reducing and storing a slice of the tile (deterministic, no
//     atomics).  The scale is applied in that epilogue.
// Code rows must start 16-byte aligned: the row pitch (ldq) is a multiple
// of 16 bytes (the int8 head's codes carry such a pitch, ops/quant_matmul.py
// ::pitched_codes), and K is a multiple of 16.
#include "common.cuh"
#include "wstream.cuh"

namespace {

using namespace norma::wstream;

constexpr int kWarps = 4;   // warps per block
constexpr int kStages = 4;  // ring depth per warp

template <int RT, bool F32X>
struct Shape {
  static constexpr int kRows = 8 * RT;                  // x rows per block
  static constexpr int kXRow = kKB * (F32X ? 4 : 2);    // x bytes per row and stage
  static constexpr int kXChunks = kXRow / 16;
  static constexpr int kStage = kCodeStage + kRows * kXRow;
  static constexpr int kWarpRing = kStages * kStage;
  static constexpr int kRing = kWarps * kWarpRing;
  static constexpr int kTile = kRows * kBN;             // f32 outputs per block
  static constexpr int kSlots = kWarps * kTile * 4;
  static constexpr int kSmem = kRing > kSlots ? kRing : kSlots;
};

template <int RT, bool F32X>
__global__ void __launch_bounds__(kWarps * 32) w8_mma_kernel(
    const void* __restrict__ x, const int8_t* __restrict__ q, const float* __restrict__ scale,
    float* __restrict__ out, int M, int N, int K, long long ldq) {
  using S = Shape<RT, F32X>;
  constexpr int XP = F32X ? 3 : 1;  // bf16 parts of x
  constexpr int XB = F32X ? 4 : 2;  // bytes per x value
  extern __shared__ __align__(128) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int n0 = (blockIdx.x / C) * kBN, m0 = blockIdx.y * S::kRows;

  // This warp's contraction range: the cluster's warps share the stages of
  // kKB rows evenly (one more for the first nst % warps).
  const int nst = (K + kKB - 1) / kKB, nw = C * kWarps, u = rank * kWarps + warp;
  const int s_begin = u * (nst / nw) + min(u, nst % nw);
  const int s_end = s_begin + nst / nw + (u < nst % nw ? 1 : 0);
  const int kend = min(s_end * kKB, K);
  unsigned char* ring = smem + warp * S::kWarpRing;

  auto issue = [&](int st, int slot) {
    if (st < s_end) {
      const uint32_t base = smem_addr(ring + slot * S::kStage);
      const int k0 = st * kKB;
      issue_codes(base, q, ldq, k0, kend, n0, N, lane);
      // x: kRows rows x kXChunks chunks, zeros past M and past this range.
      for (int i = lane; i < S::kRows * S::kXChunks; i += 32) {
        const int rho = i / S::kXChunks, c = i % S::kXChunks;
        const int m = m0 + rho, k = k0 + c * (16 / XB);
        const bool ok = m < M && k < kend;
        const int phys = F32X ? (c ^ ((rho & 1) << 2)) : (c ^ (((rho >> 1) & 1) << 1));
        cp16(base + kCodeStage + rho * S::kXRow + (phys << 4),
             ok ? static_cast<const char*>(x) + ((size_t)m * K + k) * XB : x, ok);
      }
    }
    cp_commit();
  };

  float acc[RT][8][4];
  zero(acc);

#pragma unroll
  for (int p = 0; p < kStages - 1; ++p) issue(s_begin + p, p);
  for (int st = s_begin; st < s_end; ++st) {
    const int i = st - s_begin;
    cp_wait<kStages - 2>();
    __syncwarp();
    const unsigned char* stage = ring + (i % kStages) * S::kStage;
    const unsigned char* xs = stage + kCodeStage;
#pragma unroll
    for (int s = 0; s < kKB / 16; ++s) {
      // Rows 16 s + 4 tq + (0..3), columns n0 + 16 g .. + 15.
      uint4 R[4];
      load_codes(R, stage, s, g, tq);
      // B fragments: x[8 t + g][k0 + 16 s + 4 tq .. + 3], as XP bf16 parts.
      uint32_t bx[RT][XP][2];
#pragma unroll
      for (int t = 0; t < RT; ++t) {
        const int rho = 8 * t + g;
        if constexpr (F32X) {
          const int phys = (4 * s + tq) ^ ((rho & 1) << 2);
          split_x<XP>(*reinterpret_cast<const float4*>(xs + rho * S::kXRow + (phys << 4)), bx[t]);
        } else {
          const int off = 32 * s + 8 * tq;
          const int phys = (off >> 4) ^ (((rho >> 1) & 1) << 1);
          const uint2 v = *reinterpret_cast<const uint2*>(xs + rho * S::kXRow + (phys << 4) + (off & 15));
          bx[t][0][0] = v.x;
          bx[t][0][1] = v.y;
        }
      }
      // A fragments per 16-column tile j: columns 16 g + 2 j (+1).
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        uint32_t p01, p23;
        fragment_bytes(R, j, p01, p23);
        const uint32_t a[4] = {s8pair_bf16(p01), s8pair_bf16(p01 >> 8), s8pair_bf16(p23), s8pair_bf16(p23 >> 8)};
#pragma unroll
        for (int t = 0; t < RT; ++t)
#pragma unroll
          for (int p = 0; p < XP; ++p) mma_bf16(acc[t][j], a, bx[t][p][0], bx[t][p][1]);
      }
    }
    __syncwarp();  // the slot is read: the next issue may overwrite it
    issue(st + kStages - 1, (i + kStages - 1) % kStages);
  }
  reduce_store(acc, smem, kWarps, cluster, out, scale, M, N, m0, n0);
}

template <int RT, bool F32X>
cudaError_t launch(const void* x, const void* q, const void* scale, void* out, int M, int N, int K,
                   long long ldq, int cluster, cudaStream_t stream) {
  using S = Shape<RT, F32X>;
  auto* kernel = w8_mma_kernel<RT, F32X>;
  static norma::FuncAttrs attrs;  // set per device (the first launches are eager)
  if (const cudaError_t e = attrs.ensure(kernel, S::kSmem, false); e != cudaSuccess) return e;
  return launch_cluster(kernel, (N + kBN - 1) / kBN, (M + S::kRows - 1) / S::kRows, cluster, kWarps * 32,
                        S::kSmem, stream, x, (const int8_t*)q, (const float*)scale, (float*)out, M, N, K, ldq);
}

template <bool F32X>
cudaError_t launch_rt(int rt, const void* x, const void* q, const void* scale, void* out, int M, int N, int K,
                      long long ldq, int cluster, cudaStream_t s) {
  switch (rt) {
    case 1: return launch<1, F32X>(x, q, scale, out, M, N, K, ldq, cluster, s);
    case 2: return launch<2, F32X>(x, q, scale, out, M, N, K, ldq, cluster, s);
    case 4: return launch<4, F32X>(x, q, scale, out, M, N, K, ldq, cluster, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// x [M, K] contiguous (bf16 if is_bf16 else f32), 16-byte aligned; q [K, N]
// int8 with row pitch ldq (a multiple of 16 >= N, 16-byte aligned base);
// scale [N] f32; out [M, N] f32.  rt (1, 2, 4) is the row tile in units of
// 8 rows; cluster (1, 2, 4 or 8) blocks split the contraction (K, a
// multiple of 16), whose 32-row stages their warps share evenly.
extern "C" int norma_w8_matmul(const void* x, const void* q, const void* scale, void* out, int M, int N, int K,
                               long long ldq, int rt, int cluster, int is_bf16, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % 16 || ldq < N || ldq % 16 || cluster < 1 || cluster > 8 ||
      (cluster & (cluster - 1)) || (reinterpret_cast<uintptr_t>(q) & 15) || (reinterpret_cast<uintptr_t>(x) & 15))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  return (int)(is_bf16 ? launch_rt<false>(rt, x, q, scale, out, M, N, K, ldq, cluster, s)
                       : launch_rt<true>(rt, x, q, scale, out, M, N, K, ldq, cluster, s));
}
