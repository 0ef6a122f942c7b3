// Fused log-mel frontend: padded PCM [B, S] f32 -> whisper-scale log-mel
// [B, n_mels, T] f32, frame t being samples t * 160 .. t * 160 + 400 of its
// row.  log_mel_kernel computes L[b, m, t] = log10(max(sum_k P[t, k]
// mel[k, m], 1e-10)) with P[t, k] = re^2 + im^2, re/im = frame . cos/sin
// column k of the hann-folded DFT matrices (ops/mel_pallas.py::_dft_mats),
// and each row's max; log_mel_clamp_kernel then applies the clamp in place:
// (max(L, max_b - 8) + 4) / 4.
//
// Replaces the TPU kernel norma_tpu/ops/mel_pallas.py::log_mel_pallas (:88;
// body _mel_block_kernel at :69, pl.pallas_call at :117), which runs the
// DFT as two HIGHEST-precision MXU matmuls over frames gathered outside the
// kernel and leaves the clamp to XLA.
//
// What bounds it on the H100: the DFT's operations.  At B = 8 x 30 s it is
// 24000 frames x 400 samples x 402 columns (cos and sin of 201 bins) x 2 x 3
// passes = 23.2 GFLOP on TF32 tensor cores, 0.047 ms at 495 TFLOP/s,
// against 27.7 MB of PCM in and log-mel out, 0.0083 ms at 3.35 TB/s.
//
// Why three TF32 passes.  TF32 keeps 10 mantissa bits, and log10
// magnifies the error of low-power bins: one pass is 0.076 whisper units
// from log_mel_dft on chip_smoke's batch, far past the 5e-4 the frontend is
// held to.  Each operand is split into a TF32 high part and the
// TF32-rounded remainder, x = hi + lo, and the product taken as lo.hi +
// hi.lo + hi.hi (lo.lo, ~2^-22 relative, is dropped): 1.8e-4 from
// log_mel_dft on the card (chip_smoke phase 12).  An f32 emulation of this
// arithmetic through the kernel's own tables and index formulas is held
// to JAX's log_mel_dft within 5e-4 on three signals, and one pass is shown
// to miss it (tests/test_torch_mel_pallas.py).  The power, mel, log and
// max stay f32.
//
// Design: one block of 13 warps per 64 frames of one row.
//   - The block reads its 64 * 160 + 240 samples once, by stride, splits
//     each into hi/lo (cvt.rna.tf32) and keeps both in shared memory in
//     chunks of one hop (160 samples) at a pitch of 164 floats: sample k of
//     frame f is chunk f + k / 160, offset k % 160, and no frame matrix is
//     ever written.  A k8 step never crosses a chunk (160 % 8 == 0).
//   - The DFT is mma.sync.m16n8k8 TF32: frames x [cos | sin].  Warp w owns
//     bins 16w .. 16w + 15 (13 warps: 208 bins, 201 of them real) for all
//     64 frames: 4 frame tiles x (2 cos + 2 sin) bin tiles, so a thread's
//     re and im of the same (frame, bin) sit in the same accumulator slot
//     and the power is formed in registers.
//   - A thread's A fragment is four 32-bit shared loads straight into the
//     registers the mma takes (frame g or g + 8, sample t or t + 4 of the k
//     step); the 164-float pitch puts a warp's 32 loads on 32 banks.
//   - The matrices are read once per block, each entry by the one warp that
//     owns its bins: ops/mel_pallas.py stores them f32 in fragment order
//     ([warp][k step][half][lane][4]), so a thread's B fragments of a k step
//     are two 16-byte cp.async copies, each warp's 512 contiguous bytes,
//     into its own slots of a 4-step ring in shared memory, issued three k
//     steps ahead (a thread reads back only what it copied: no barrier).
//     They are split into hi/lo in registers as they are used (the load
//     path), rounded as cvt.rna rounds, in integer instructions.  (Stored
//     split, the table's bytes double; an f32 table read with two lanes to a
//     32-byte sector reads every sector twice: the L2 then bounds the
//     kernel at B = 8 at ~3 TB/s of sectors.)
//   - Each k step's three passes start from zero and are added to the f32
//     sums on the CUDA cores (dft_step).
//   - The power [64, 208] then overlays the signal in shared memory.  The
//     mel projection runs over each filter's own bin range (at most 2
//     filters touch a bin; a table of first bin, count and mel_p's weights
//     per mel, ascending bins), a lane per frame, so the log-mel is stored
//     along T, coalesced.  Each row's max goes through an atomicMax on
//     order-preserving bits into a [B] scratch the launcher zeroes: the
//     result does not depend on the blocks' order.
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "common.cuh"
#include "wstream.cuh"

namespace {

constexpr int NFFT = 400, HOP = 160;
constexpr int TF = 64;                                // frames per block
constexpr int WARPS = 13;                             // 16 bins each
constexpr int THREADS = 32 * WARPS;
constexpr int KSTEPS = NFFT / 8;                      // k8 steps
constexpr int CHUNKS = TF + (NFFT + HOP - 1) / HOP - 1;  // hops the block's frames span
constexpr int CP = 164;                               // chunk pitch (floats): 4g + t, distinct banks
constexpr int SIGF = CHUNKS * CP;                     // one of hi / lo
constexpr int PW = 16 * WARPS + 1;                    // power row pitch (odd: lanes = frames)
constexpr int MAIN_FLOATS = 2 * SIGF > TF * PW ? 2 * SIGF : TF * PW;
constexpr int STAGES = 4;                             // B ring depth (k steps)
constexpr int RING_FLOATS = STAGES * 2 * THREADS * 4;  // [stage][half][thread] float4
constexpr int SMEM_BYTES = (MAIN_FLOATS + RING_FLOATS + 32) * 4;
constexpr float INV_LN10 = 0.43429448190325176f;
static_assert(HOP % 8 == 0, "a k8 step must not cross a hop chunk");

__device__ __forceinline__ uint32_t tf32_bits(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// cvt.rna.tf32.f32 for finite x in two integer instructions (ptxas expands
// the cvt into nine): the magnitude rounded half away from zero at bit 13.
__device__ __forceinline__ uint32_t tf32_bits_finite(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
      "{%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Order-preserving f32 <-> u32 (0 is below every number's key).
__device__ __forceinline__ unsigned order_key(float v) {
  const unsigned u = __float_as_uint(v);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}
__device__ __forceinline__ float key_value(unsigned k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

// One k8 step of the block's 64 frames against the warp's 16 bins: the B
// fragments bh / bl (hi and lo parts; cos tile 0, cos tile 1, sin tile 0,
// sin tile 1, each as (b0, b1)), then per frame tile the three passes into
// a fresh accumulator d, added to acc with an f32 add.  The tensor core
// aligns and truncates the products to its accumulator's exponent, so a k
// step's 24 products are summed against d's own size and only 50 rounded
// adds reach acc (one accumulator over all 150 passes read 4.0e-4 from
// log_mel_dft on the card in chip_smoke phase 12, this way 1.8e-4).  Each
// tile's four bin tiles go pass by pass, so no two consecutive mma share
// an accumulator.
__device__ __forceinline__ void dft_step(float (&acc)[4][4][4], const uint32_t (&bh)[8], const uint32_t (&bl)[8],
                                         const float* sig_hi, const float* sig_lo, int ks, int g, int t4) {
  const int k0 = ks * 8;
  const int base = (g + k0 / HOP) * CP + k0 % HOP + t4;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt) {
    // a0 (frame g, sample t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4).
    const int r0 = base + mt * 16 * CP, r1 = r0 + 8 * CP;
    const uint32_t ah[4] = {__float_as_uint(sig_hi[r0]), __float_as_uint(sig_hi[r1]),
                            __float_as_uint(sig_hi[r0 + 4]), __float_as_uint(sig_hi[r1 + 4])};
    const uint32_t al[4] = {__float_as_uint(sig_lo[r0]), __float_as_uint(sig_lo[r1]),
                            __float_as_uint(sig_lo[r0 + 4]), __float_as_uint(sig_lo[r1 + 4])};
    float d[4][4] = {};
#pragma unroll
    for (int n = 0; n < 4; ++n) mma_tf32(d[n], al, bh[2 * n], bh[2 * n + 1]);
#pragma unroll
    for (int n = 0; n < 4; ++n) mma_tf32(d[n], ah, bl[2 * n], bl[2 * n + 1]);
#pragma unroll
    for (int n = 0; n < 4; ++n) mma_tf32(d[n], ah, bh[2 * n], bh[2 * n + 1]);
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][n][i] += d[n][i];
  }
}

__global__ void __launch_bounds__(THREADS, 1) log_mel_kernel(
    const float* __restrict__ audio, long long stride, long long nsamp, const float4* __restrict__ frags,
    const int* __restrict__ mel_start, const int* __restrict__ mel_count, const float* __restrict__ mel_w,
    int max_w, unsigned* __restrict__ row_max, float* __restrict__ out, int T, int n_mels) {
  extern __shared__ __align__(16) float sm[];
  float* sig_hi = sm;         // [CHUNKS][CP]
  float* sig_lo = sm + SIGF;  // [CHUNKS][CP]
  float* pw = sm;             // [TF][PW], after the DFT
  float4* ring = reinterpret_cast<float4*>(sm + MAIN_FLOATS);  // [STAGES][2][THREADS]
  float* red = sm + MAIN_FLOATS + RING_FLOATS;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, g = lane >> 2, t4 = lane & 3;
  const int b = blockIdx.y, t0 = blockIdx.x * TF;

  // This thread's B fragments of k step ks are two 16-byte pieces of the
  // fragment table (a warp's pieces contiguous); it copies them into its
  // own slots of a ring of STAGES k steps and reads back only those, so a
  // cp.async wait is all the sync it needs.
  const float4* fq = frags + (size_t)warp * KSTEPS * 64 + lane;
  auto issue = [&](int ks) {
    if (ks < KSTEPS) {
      float4* st = ring + (ks % STAGES) * 2 * THREADS + tid;
      norma::wstream::cp16(norma::wstream::smem_addr(st), fq + ks * 64, true);
      norma::wstream::cp16(norma::wstream::smem_addr(st + THREADS), fq + ks * 64 + 32, true);
    }
    norma::wstream::cp_commit();  // an empty group past the end keeps the count
  };
#pragma unroll
  for (int ks = 0; ks < STAGES - 1; ++ks) issue(ks);

  // The block's samples, 16 bytes at a time where the row allows it.
  const float* row = audio + (size_t)b * stride;
  const long long s0 = (long long)t0 * HOP;
  const bool vec = ((uintptr_t)(row + s0) & 15) == 0;
#pragma unroll 4
  for (int i4 = tid; i4 < CHUNKS * HOP / 4; i4 += THREADS) {
    const int i = 4 * i4;
    float x[4];
    if (vec && s0 + i + 4 <= nsamp) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(row + s0 + i));
      x[0] = v.x, x[1] = v.y, x[2] = v.z, x[3] = v.w;
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) x[e] = s0 + i + e < nsamp ? __ldg(row + s0 + i + e) : 0.f;
    }
    const int o = (i / HOP) * CP + i % HOP;  // a hop holds whole groups of 4
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float hi = __uint_as_float(tf32_bits(x[e]));
      sig_hi[o + e] = hi;
      sig_lo[o + e] = __uint_as_float(tf32_bits(x[e] - hi));
    }
  }
  __syncthreads();

  float acc[4][4][4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][n][i] = 0.f;
  for (int ks = 0; ks < KSTEPS; ++ks) {
    norma::wstream::cp_wait<STAGES - 2>();  // k step ks has landed
    const float4* st = ring + (ks % STAGES) * 2 * THREADS + tid;
    const float4 q0 = st[0], q1 = st[THREADS];
    issue(ks + STAGES - 1);  // into the slot k step ks - 1 was read from
    const float v[8] = {q0.x, q0.y, q0.z, q0.w, q1.x, q1.y, q1.z, q1.w};
    uint32_t bh[8], bl[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      bh[i] = tf32_bits_finite(v[i]);
      bl[i] = tf32_bits_finite(v[i] - __uint_as_float(bh[i]));
    }
    dft_step(acc, bh, bl, sig_hi, sig_lo, ks, g, t4);
  }
  __syncthreads();  // every warp is done with the samples: the power overlays them

  // acc[mt][n][i]: frame mt * 16 + g + 8 (i >> 1), bin 16 warp + 8 (n & 1)
  // + 2 t4 + (i & 1); n = 0, 1 the cos tiles, 2, 3 the sin tiles.
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int tile = 0; tile < 2; ++tile)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float re = acc[mt][tile][i], im = acc[mt][2 + tile][i];
        pw[(mt * 16 + g + 8 * (i >> 1)) * PW + 16 * warp + 8 * tile + 2 * t4 + (i & 1)] = re * re + im * im;
      }
  __syncthreads();

  const int nf = min(TF, T - t0);
  float* orow = out + (size_t)b * n_mels * T + t0;
  float vmax = -CUDART_INF_F;
  for (int i = tid; i < n_mels * TF; i += THREADS) {
    const int m = i / TF, f = i % TF;
    if (f >= nf) continue;
    const int s = __ldg(mel_start + m), cnt = __ldg(mel_count + m);
    const float* p = pw + f * PW + s;
    const float* w = mel_w + (size_t)m * max_w;
    float mel = 0.f;
    for (int j = 0; j < cnt; ++j) mel = fmaf(p[j], __ldg(w + j), mel);
    const float v = logf(fmaxf(mel, 1e-10f)) * INV_LN10;
    orow[(size_t)m * T + f] = v;
    vmax = fmaxf(vmax, v);
  }
  vmax = norma::warp_max(vmax);
  if (lane == 0) red[warp] = vmax;
  __syncthreads();
  if (tid == 0) {
    float mx = red[0];
    for (int w = 1; w < WARPS; ++w) mx = fmaxf(mx, red[w]);
    atomicMax(row_max + b, order_key(mx));
  }
}

// out[b] = (max(out[b], max_b - 8) + 4) / 4 in place, VEC floats a thread.
template <int VEC>
__global__ void __launch_bounds__(256) log_mel_clamp_kernel(float* __restrict__ out,
                                                            const unsigned* __restrict__ row_max,
                                                            long long per_row) {
  const int b = blockIdx.y;
  const float lo = key_value(row_max[b]) - 8.f;
  const long long n = per_row / VEC;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += (long long)gridDim.x * blockDim.x) {
    if constexpr (VEC == 4) {
      float4* p = reinterpret_cast<float4*>(out + (size_t)b * per_row) + i;
      float4 v = *p;
      v.x = (fmaxf(v.x, lo) + 4.f) * 0.25f;
      v.y = (fmaxf(v.y, lo) + 4.f) * 0.25f;
      v.z = (fmaxf(v.z, lo) + 4.f) * 0.25f;
      v.w = (fmaxf(v.w, lo) + 4.f) * 0.25f;
      *p = v;
    } else {
      float* p = out + (size_t)b * per_row + i;
      *p = (fmaxf(*p, lo) + 4.f) * 0.25f;
    }
  }
}

}  // namespace

// audio: B rows of nsamp f32 samples at row stride `stride` (frames past
// nsamp read zeros); frags: the hann-folded cos/sin in fragment order
// [13][50][2][32][4] f32; mel_start / mel_count [n_mels] int32 and mel_w
// [n_mels, max_w] f32: each filter's bin range and weights; row_max [B]
// u32 scratch (zeroed here); out [B, n_mels, T] f32 contiguous.  Two
// launches: the log-mel with each row's max, then the clamp.
extern "C" int norma_log_mel(const void* audio, long long stride, long long nsamp, const void* frags,
                             const void* mel_start, const void* mel_count, const void* mel_w, int max_w,
                             void* row_max, void* out, int B, int T, int n_mels, void* stream) {
  if (B <= 0 || T <= 0 || n_mels <= 0 || B > 65535 || stride < nsamp || max_w <= 0 || max_w > 16 * WARPS)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e = cudaFuncSetAttribute(log_mel_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (e != cudaSuccess) return (int)e;
  e = cudaMemsetAsync(row_max, 0, (size_t)B * sizeof(unsigned), s);
  if (e != cudaSuccess) return (int)e;
  log_mel_kernel<<<dim3((T + TF - 1) / TF, B), THREADS, SMEM_BYTES, s>>>(
      (const float*)audio, stride, nsamp, (const float4*)frags, (const int*)mel_start, (const int*)mel_count,
      (const float*)mel_w, max_w, (unsigned*)row_max, (float*)out, T, n_mels);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const long long per_row = (long long)n_mels * T;
  const bool vec = per_row % 4 == 0 && ((uintptr_t)out & 15) == 0;
  const long long n = vec ? per_row / 4 : per_row;
  const dim3 grid((unsigned)((n + 255) / 256 < 65535 ? (n + 255) / 256 : 65535), B);
  if (vec)
    log_mel_clamp_kernel<4><<<grid, 256, 0, s>>>((float*)out, (const unsigned*)row_max, per_row);
  else
    log_mel_clamp_kernel<1><<<grid, 256, 0, s>>>((float*)out, (const unsigned*)row_max, per_row);
  return (int)cudaGetLastError();
}
