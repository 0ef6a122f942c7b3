// Fused log-mel frontend: padded PCM [B, S] f32 -> log10(max(mel, 1e-10))
// [B, T, n_mels] f32, frame t being samples t * 160 .. t * 160 + 400 of its
// row.  out[b, t, m] = log10(max(sum_k P[t, k] * mel[k, m], 1e-10)) with
// P[t, k] = re^2 + im^2, re/im = frame . cos/sin column k of the
// hann-folded DFT matrices (ops/mel_pallas.py::_dft_mats).  The global
// clamp (max - 8, + 4, / 4) stays in PyTorch, as it stays in XLA.
//
// Replaces the TPU kernel norma_tpu/ops/mel_pallas.py::log_mel_pallas
// (pl.pallas_call at :117, body _mel_block_kernel at :69), which runs the
// DFT as two HIGHEST-precision MXU matmuls over frames the TPU gathers
// outside the kernel.
//
// What bounds it on the H100: f32 arithmetic, ~1.1 GFLOP per 30 s window
// (3000 frames x 201 bins x 400 samples x 2 products, plus the mel
// matrix).  It must be exact f32: near-silent bins go through the log, and
// TF32's ~3 digits would move them (the JAX kernel insists on HIGHEST,
// mel_pallas.py:74-76), so no tensor cores: CUDA-core fmaf.
//
// Design: one block per TF = 16 frames of one row.  The block's samples
// (TF * 160 + 240 of them) are read once into shared memory by stride, so
// no [B, T, 400] frame matrix is ever written.  The cos/sin columns stream
// through shared memory 32 bins at a time; lane = bin, each warp = two
// frames, so a frame sample is a broadcast read and a matrix entry a
// conflict-free one.  The power spectrum [TF, 201] stays in shared memory
// for the mel product; the mel matrix is read through the read-only cache.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NFFT = 400, HOP = 160, NFREQ = 201, KP = 256;  // KP: padded bins of the matrices
constexpr int TF = 16;                                        // frames per block
constexpr int KB = 32;                                        // bins per shared tile
constexpr int NKT = (NFREQ + KB - 1) / KB;                    // 7 tiles (224 bins)
constexpr int PP = NKT * KB;                                  // power row pitch
constexpr int THREADS = 32 * (TF / 2);
constexpr int SIG = TF * HOP + NFFT - HOP;
constexpr int SMEM_FLOATS = SIG + 2 * NFFT * KB + TF * PP;
constexpr float INV_LN10 = 0.43429448190325176f;

__global__ void __launch_bounds__(THREADS) log_mel_kernel(
    const float* __restrict__ audio, long long stride, long long nsamp, const float* __restrict__ cosm,
    const float* __restrict__ sinm, const float* __restrict__ melp, float* __restrict__ out, int T,
    int n_mels) {
  extern __shared__ __align__(16) float sm[];
  float* sig = sm;                 // [SIG]
  float* cs = sig + SIG;           // [NFFT][KB]
  float* sn = cs + NFFT * KB;      // [NFFT][KB]
  float* pw = sn + NFFT * KB;      // [TF][PP]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.y, t0 = blockIdx.x * TF;
  const float* row = audio + (size_t)b * stride;

  const long long s0 = (long long)t0 * HOP;
  for (int i = tid; i < SIG; i += THREADS) sig[i] = s0 + i < nsamp ? row[s0 + i] : 0.f;

  const int f0 = 2 * warp;  // this warp's two frames
  for (int kt = 0; kt < NKT; ++kt) {
    __syncthreads();  // the previous tile's columns are no longer read
    for (int i = tid; i < NFFT * KB; i += THREADS) {
      const int j = i / KB, kk = i % KB;
      cs[i] = cosm[j * KP + kt * KB + kk];
      sn[i] = sinm[j * KP + kt * KB + kk];
    }
    __syncthreads();
    float re0 = 0.f, im0 = 0.f, re1 = 0.f, im1 = 0.f;
    const float* a0 = sig + f0 * HOP;
    const float* a1 = a0 + HOP;
#pragma unroll 8
    for (int j = 0; j < NFFT; ++j) {
      const float c = cs[j * KB + lane], s = sn[j * KB + lane];
      const float x0 = a0[j], x1 = a1[j];
      re0 = fmaf(x0, c, re0);
      im0 = fmaf(x0, s, im0);
      re1 = fmaf(x1, c, re1);
      im1 = fmaf(x1, s, im1);
    }
    const int k = kt * KB + lane;
    pw[f0 * PP + k] = re0 * re0 + im0 * im0;
    pw[(f0 + 1) * PP + k] = re1 * re1 + im1 * im1;
  }
  __syncthreads();

  for (int i = tid; i < TF * n_mels; i += THREADS) {
    const int f = i / n_mels, m = i % n_mels;
    if (t0 + f >= T) continue;
    const float* p = pw + f * PP;
    float acc = 0.f;
    for (int k = 0; k < NFREQ; ++k) acc = fmaf(p[k], __ldg(melp + k * n_mels + m), acc);
    out[((size_t)b * T + t0 + f) * n_mels + m] = logf(fmaxf(acc, 1e-10f)) * INV_LN10;
  }
}

}  // namespace

// audio: B rows of nsamp f32 samples at row stride `stride` (frames past
// nsamp read zeros); cosm/sinm [400, 256] and melp [256, n_mels] f32
// contiguous; out [B, T, n_mels] f32.
extern "C" int norma_log_mel(const void* audio, long long stride, long long nsamp, const void* cosm,
                             const void* sinm, const void* melp, void* out, int B, int T, int n_mels,
                             void* stream) {
  if (B <= 0 || T <= 0 || n_mels <= 0 || B > 65535 || stride < nsamp) return (int)cudaErrorInvalidValue;
  const size_t smem = SMEM_FLOATS * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(log_mel_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((T + TF - 1) / TF, B);
  log_mel_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      (const float*)audio, stride, nsamp, (const float*)cosm, (const float*)sinm, (const float*)melp,
      (float*)out, T, n_mels);
  return (int)cudaGetLastError();
}
