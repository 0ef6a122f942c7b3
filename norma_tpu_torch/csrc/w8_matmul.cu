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
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kWarps = 4;                // warps per block
constexpr int kStages = 4;               // ring depth per warp
constexpr int kKB = 32;                  // contraction rows per stage
constexpr int kBN = 128;                 // output columns per block
constexpr int kCodeStage = kKB * kBN;    // code bytes per stage

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

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, or 16 zero bytes when !valid.
__device__ __forceinline__ void cp16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Bytes 0 and 2 of w (int8) -> bf16x2, exactly: with m the low 7 bits and
// s the sign bit, v = (128 + m) + (s ? -256 : -128).
__device__ __forceinline__ uint32_t s8pair_bf16(uint32_t w) {
  const uint32_t lo = (w & 0x007F007Fu) | 0x43004300u;
  const uint32_t c = (w & 0x00800080u) ^ 0xC300C300u;
  uint32_t r;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n" : "=r"(r) : "r"(lo), "r"(0x3F803F80u), "r"(c));
  return r;
}

__device__ __forceinline__ uint32_t bf16x2_bits(float a, float b) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
      "{%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t word_of(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

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
      // Codes: 32 rows x 8 chunks of 16 bytes; chunk c of row r lands at
      // c ^ 2 * ((r / 4) % 4), which spreads the compute's reads (rows
      // 4 tq + i, chunk g) over all banks.
#pragma unroll
      for (int v = 0; v < kCodeStage / 16 / 32; ++v) {
        const int i = lane + 32 * v, r = i >> 3, c = i & 7;
        const int k = k0 + r, n = n0 + 16 * c;
        const bool ok = k < kend && n < N;
        cp16(base + r * kBN + ((c ^ (((r >> 2) & 3) << 1)) << 4), ok ? q + (size_t)k * ldq + n : q, ok);
      }
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
#pragma unroll
  for (int t = 0; t < RT; ++t)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[t][j][e] = 0.f;

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
#pragma unroll
      for (int r = 0; r < 4; ++r)
        R[r] = *reinterpret_cast<const uint4*>(stage + (16 * s + 4 * tq + r) * kBN + ((g ^ (tq << 1)) << 4));
      // B fragments: x[8 t + g][k0 + 16 s + 4 tq .. + 3], as XP bf16 parts.
      uint32_t bx[RT][XP][2];
#pragma unroll
      for (int t = 0; t < RT; ++t) {
        const int rho = 8 * t + g;
        if constexpr (F32X) {
          const int phys = (4 * s + tq) ^ ((rho & 1) << 2);
          const float4 f = *reinterpret_cast<const float4*>(xs + rho * S::kXRow + (phys << 4));
          float v[4] = {f.x, f.y, f.z, f.w};
#pragma unroll
          for (int p = 0; p < XP; ++p) {
            float part[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              part[e] = __bfloat162float(__float2bfloat16_rn(v[e]));
              v[e] -= part[e];  // exact: the remainder of a rounding to 8 bits
            }
            bx[t][p][0] = bf16x2_bits(part[0], part[1]);
            bx[t][p][1] = bf16x2_bits(part[2], part[3]);
          }
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
        const uint32_t sel = (j & 1) ? 0x7632u : 0x5410u;
        const uint32_t p01 = __byte_perm(word_of(R[0], j >> 1), word_of(R[1], j >> 1), sel);
        const uint32_t p23 = __byte_perm(word_of(R[2], j >> 1), word_of(R[3], j >> 1), sel);
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
  cp_wait<0>();
  __syncthreads();  // every warp is done with the ring: it becomes the slots

  // Warp w's partial tile to slot w, [row][column] f32.
  float* slots = reinterpret_cast<float*>(smem);
  float* mine = slots + warp * S::kTile;
#pragma unroll
  for (int t = 0; t < RT; ++t)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int m = 8 * t + 2 * tq, n = 16 * g + 2 * j;
      *reinterpret_cast<float2*>(mine + m * kBN + n) = make_float2(acc[t][j][0], acc[t][j][2]);
      *reinterpret_cast<float2*>(mine + (m + 1) * kBN + n) = make_float2(acc[t][j][1], acc[t][j][3]);
    }
  __syncthreads();
  // The block's sum, warps in order, into slot 0.
  for (int e = tid; e < S::kTile; e += blockDim.x) {
    float v = slots[e];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) v += slots[w * S::kTile + e];
    slots[e] = v;
  }
  cluster.sync();
  // This block's slice of the tile: the cluster's blocks in rank order, then
  // the scale.
  const int slice = S::kTile / C;
  for (int e = rank * slice + tid; e < (rank + 1) * slice; e += blockDim.x) {
    float v = 0.f;
    for (int r = 0; r < C; ++r) v += cluster.map_shared_rank(slots, r)[e];
    const int m = m0 + e / kBN, n = n0 + e % kBN;
    if (m < M && n < N) out[(size_t)m * N + n] = v * scale[n];
  }
  cluster.sync();  // no block leaves while another reads its slot 0
}

template <int RT, bool F32X>
cudaError_t launch(const void* x, const void* q, const void* scale, void* out, int M, int N, int K,
                   long long ldq, int cluster, cudaStream_t stream) {
  using S = Shape<RT, F32X>;
  auto* kernel = w8_mma_kernel<RT, F32X>;
  static bool sized = false;  // set once, by the first (eager) launch
  if (!sized) {
    const cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, S::kSmem);
    if (e != cudaSuccess) return e;
    sized = true;
  }
  const long long tiles = (N + kBN - 1) / kBN, rows = (M + S::kRows - 1) / S::kRows;
  if (tiles * cluster > 0x7fffffffLL || rows > 65535) return cudaErrorInvalidConfiguration;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(tiles * cluster), (unsigned)rows, 1);
  cfg.blockDim = dim3(kWarps * 32, 1, 1);
  cfg.dynamicSmemBytes = S::kSmem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, x, (const int8_t*)q, (const float*)scale, (float*)out, M,
                                           N, K, ldq);
  return e != cudaSuccess ? e : cudaGetLastError();
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
