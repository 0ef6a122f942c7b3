// Shared pieces of the weight-streaming kernels (w8_matmul.cu, w4_matmul.cu):
// few-row products y[M, N] = x[M, K] @ W[K, N] whose time is the weight
// bytes read from device memory.  Both run one launch per product on
// mma.sync.m16n8k16 bf16 tensor cores over the transposed problem (A = codes^T,
// 16 output columns x 16 k; B = x^T, 16 k x 8 rows), stream their code rows
// through per-warp rings of cp.async 16-byte copies, and meet their K split in
// a fixed order: the block's warps through shared memory, then the cluster's
// blocks through distributed shared memory.
//
// A block owns kBN = 128 output columns.  A thread (g = lane / 4, tq = lane % 4)
// reads, per 16-row step s of a stage, the 16-byte chunk g (columns 16 g ..
// 16 g + 15) of the four code rows 16 s + 4 tq + (0..3): its four contraction
// indices of a fragment are four consecutive k (the same permutation on A and
// B leaves the sum unchanged), and fragment j (0..7) covers columns 16 g + 2 j
// (A row g) and 16 g + 2 j + 1 (A row g + 8).  So the thread's accumulators
// acc[t][j][0..3] hold, for row tile t, x rows 8 t + 2 tq (+1) at those two
// columns: [0] (row 2 tq, col 16 g + 2 j), [1] (row 2 tq + 1, same col), [2]
// and [3] the same rows at col 16 g + 2 j + 1.
//
// The decode-step attention kernels use some of it too: cross_decode.cu the
// exact int8 / int4 widening and the mma wrapper, both it and
// self_decode.cu the cluster launch.
#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace norma {
namespace wstream {

namespace cg = cooperative_groups;

constexpr int kKB = 32;                // contraction rows (code rows) per ring stage
constexpr int kBN = 128;               // output columns per block
constexpr int kCodeStage = kKB * kBN;  // code bytes per stage

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

// Where chunk c (16 columns) of code row r of a stage lies: c ^ 2 * ((r / 4)
// % 4), which spreads the compute's reads (rows 4 tq + i, chunk g) over all
// banks.
__device__ __forceinline__ int code_chunk(int r, int c) { return c ^ (((r >> 2) & 3) << 1); }

// Issue one stage's codes: kKB rows of kBN bytes from row k0 of q (row pitch
// ldq), rows at or past kend and chunks at or past column N zero.
__device__ __forceinline__ void issue_codes(uint32_t base, const int8_t* __restrict__ q, long long ldq, int k0,
                                            int kend, int n0, int N, int lane) {
#pragma unroll
  for (int v = 0; v < kCodeStage / 16 / 32; ++v) {
    const int i = lane + 32 * v, r = i >> 3, c = i & 7;
    const int k = k0 + r, n = n0 + 16 * c;
    const bool ok = k < kend && n < N;
    cp16(base + r * kBN + (code_chunk(r, c) << 4), ok ? q + (size_t)k * ldq + n : q, ok);
  }
}

// The thread's 16 code bytes of rows 16 s + 4 tq + (0..3), chunk g.
__device__ __forceinline__ void load_codes(uint4 (&R)[4], const unsigned char* stage, int s, int g, int tq) {
#pragma unroll
  for (int r = 0; r < 4; ++r)
    R[r] = *reinterpret_cast<const uint4*>(stage + (16 * s + 4 * tq + r) * kBN + ((g ^ (tq << 1)) << 4));
}

__device__ __forceinline__ uint32_t word_of(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// The bytes of fragment j: p01 = [row 0 col c, row 0 col c + 1, row 1 col c,
// row 1 col c + 1] with c = 16 g + 2 j, p23 the same for rows 2 and 3.
__device__ __forceinline__ void fragment_bytes(const uint4 (&R)[4], int j, uint32_t& p01, uint32_t& p23) {
  const uint32_t sel = (j & 1) ? 0x7632u : 0x5410u;
  p01 = __byte_perm(word_of(R[0], j >> 1), word_of(R[1], j >> 1), sel);
  p23 = __byte_perm(word_of(R[2], j >> 1), word_of(R[3], j >> 1), sel);
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

// Nibbles 0 and 4 of w (bits 0-3 and 16-19), signed 4-bit -> bf16x2 exactly.
__device__ __forceinline__ uint32_t s4pair_bf16(uint32_t w) {
  const uint32_t b = (w & 0x000F000Fu) ^ 0x43084308u;  // 128 + (n ^ 8) = 136 + v
  uint32_t r;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n" : "=r"(r) : "r"(b), "r"(0x3F803F80u), "r"(0xC308C308u));
  return r;
}

__device__ __forceinline__ uint32_t bf16x2_bits(float a, float b) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Four f32 x values as XP bf16 parts (B fragment words): XP = 3 splits each
// exactly (hi + mid + lo holds all 24 bits).
template <int XP>
__device__ __forceinline__ void split_x(const float4& f, uint32_t (&b)[XP][2]) {
  float v[4] = {f.x, f.y, f.z, f.w};
#pragma unroll
  for (int p = 0; p < XP; ++p) {
    float part[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      part[e] = __bfloat162float(__float2bfloat16_rn(v[e]));
      v[e] -= part[e];  // exact: the remainder of a rounding to 8 bits
    }
    b[p][0] = bf16x2_bits(part[0], part[1]);
    b[p][1] = bf16x2_bits(part[2], part[3]);
  }
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
      "{%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int RT>
__device__ __forceinline__ void zero(float (&acc)[RT][8][4]) {
#pragma unroll
  for (int t = 0; t < RT; ++t)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[t][j][e] = 0.f;
}

// The epilogue: every warp's partial tile acc (8 RT rows x kBN columns) meets
// the others' in a fixed order -- the block's nwarps warps in order through
// shared memory, then the cluster's blocks in rank order through distributed
// shared memory, each block reducing and storing a slice of the tile -- and
// lands in out[M, N] f32, times scale[n] where scale is not null.  smem holds
// nwarps * 8 RT * kBN floats (it may alias the ring: every cp.async is
// waited for first).
template <int RT>
__device__ __forceinline__ void reduce_store(const float (&acc)[RT][8][4], unsigned char* smem, int nwarps,
                                             cg::cluster_group& cluster, float* __restrict__ out,
                                             const float* __restrict__ scale, int M, int N, int m0, int n0) {
  constexpr int kTile = 8 * RT * kBN;  // f32 outputs per block
  const int C = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;
  cp_wait<0>();
  __syncthreads();  // every warp is done with the ring: it becomes the slots

  // Warp w's partial tile to slot w, [row][column] f32.
  float* slots = reinterpret_cast<float*>(smem);
  float* mine = slots + warp * kTile;
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
  for (int e = tid; e < kTile; e += blockDim.x) {
    float v = slots[e];
    for (int w = 1; w < nwarps; ++w) v += slots[w * kTile + e];
    slots[e] = v;
  }
  cluster.sync();
  // This block's slice of the tile: the cluster's blocks in rank order, then
  // the scale.
  const int slice = kTile / C;
  for (int e = rank * slice + tid; e < (rank + 1) * slice; e += blockDim.x) {
    float v = 0.f;
    for (int r = 0; r < C; ++r) v += cluster.map_shared_rank(slots, r)[e];
    const int m = m0 + e / kBN, n = n0 + e % kBN;
    if (m < M && n < N) out[(size_t)m * N + n] = scale != nullptr ? v * scale[n] : v;
  }
  cluster.sync();  // no block leaves while another reads its slot 0
}

// Launch `kernel` on `grid` blocks of `threads`, `smem` bytes of dynamic
// shared memory, in clusters of `cluster` blocks along x (0: no cluster
// attribute, every block its own cluster of one).
template <typename Kernel, typename... Args>
cudaError_t launch_cluster_grid(Kernel kernel, dim3 grid, int cluster, int threads, int smem, cudaStream_t stream,
                                Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = cluster > 0 ? 1 : 0;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, args...);
  return e != cudaSuccess ? e : cudaGetLastError();
}

// Launch `kernel` on a grid of (tiles * cluster, row_blocks) blocks, in
// clusters of `cluster` blocks along x.
template <typename Kernel, typename... Args>
cudaError_t launch_cluster(Kernel kernel, long long tiles, long long row_blocks, int cluster, int threads,
                           int smem, cudaStream_t stream, Args... args) {
  if (tiles * cluster > 0x7fffffffLL || row_blocks > 65535) return cudaErrorInvalidConfiguration;
  return launch_cluster_grid(kernel, dim3((unsigned)(tiles * cluster), (unsigned)row_blocks, 1), cluster, threads,
                             smem, stream, args...);
}

}  // namespace wstream
}  // namespace norma
