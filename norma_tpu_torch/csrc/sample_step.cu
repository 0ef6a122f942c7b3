// Fused grammar + sampling step of the Whisper decode loop.
//
// Replaces the TPU kernel norma_tpu/ops/sample_step.py::sample_step_pallas
// (pl.pallas_call at :305, body _make_kernel at :147): one decode step's
// post-logits work -- softmax over the vocab, the timestamp-grammar masks
// (suppress, first-token at step 0, timestamp pair rule, sum-of-timestamps
// vs max-text, monotonic past timestamps), the deadlock flag, greedy
// first-index argmax (NaN as +inf), a Gumbel-max draw at t>0, and the
// chosen token's masked probability.  Same contract as the plain PyTorch
// version ops/sample_step.py::sample_step_torch, except that t>0 draws
// come from Philox4x32-10 keyed by (seed) with counter (group, row, step),
// so only the sampling law matches other generators.  The step (step_rows)
// and the seed (seed_ptr) may come from device memory, so that a captured
// CUDA graph replays one launch at successive steps and for other windows.
//
// What bounds it on the H100: not bytes (a 51866-entry f32 row is 207 KB;
// 6-48 rows are 1-10 MB, a few microseconds of HBM time) but launch
// latency and the block reductions between passes.  It replaces ~20
// separate elementwise/reduction launches per decode step with one.
//
// Design: one CTA of 512 threads per row.  The block walks the row in four
// strided passes -- max, sum of exp, (sum_ts, max_txt) over the suppressed
// probabilities, then the masked value computed on the fly for the argmax,
// the draw and the deadlock max -- with a block reduction after each.  The
// row stays L2-resident between passes (nothing is staged in shared
// memory), and the four [V] masks are shared by every row, so they stay in
// L2 too.  Masks are additive -inf in PROBABILITY space, exactly as in the
// reference; the masked value at any index is recomputed by one formula
// (masked_at) so the chosen token's probability equals the value the
// argmax saw, bit for bit.
#include "common.cuh"

namespace {

constexpr int kThreads = 512;

struct Row {
  const float* x;  // raw logits
  float m, s;      // row max (NaN if any NaN) and sum of exp(x - m)
  const float *msup, *mnts, *mts, *mfirst;
  int p1, p2, lts, step, eot, no_ts;
  bool force_ts;

  __device__ __forceinline__ float prob(int j) const { return expf(x[j] - m) / s; }

  __device__ __forceinline__ float masked(int j) const {
    const float pr = prob(j);
    if (step == 0) return pr + mfirst[j];
    const float base = pr + msup[j];
    const float past = (j > no_ts && j <= lts) ? -CUDART_INF_F : 0.f;
    float extra;
    if (p1 > no_ts) {
      extra = (p2 >= eot) ? mts[j] : mnts[j] + past;
    } else {
      extra = force_ts ? mnts[j] + past : past;
    }
    return base + extra;
  }
};

__device__ __forceinline__ float nan_as_inf(float v) { return isnan(v) ? CUDART_INF_F : v; }

__global__ void __launch_bounds__(kThreads) sample_step_kernel(
    const float* __restrict__ ll, const float* __restrict__ msup,
    const float* __restrict__ mnts, const float* __restrict__ mts,
    const float* __restrict__ mfirst, const int* __restrict__ prev1,
    const int* __restrict__ prev2, const int* __restrict__ last_ts, int step,
    const int* __restrict__ step_rows, const float* __restrict__ temp,
    unsigned long long seed_val, const unsigned long long* __restrict__ seed_ptr, int V,
    int eot, int no_ts, int greedy_only,
    int* __restrict__ nxt, float* __restrict__ prob,
    unsigned char* __restrict__ deadlock) {
  __shared__ float shf[32];
  __shared__ int shi[32];
  const int r = blockIdx.x, tid = threadIdx.x;
  const unsigned long long seed = seed_ptr != nullptr ? *seed_ptr : seed_val;

  Row row;
  row.x = ll + (size_t)r * V;
  row.msup = msup;
  row.mnts = mnts;
  row.mts = mts;
  row.mfirst = mfirst;
  row.p1 = prev1[r];
  row.p2 = prev2[r];
  row.lts = last_ts[r];
  row.step = step_rows ? step_rows[r] : step;
  row.eot = eot;
  row.no_ts = no_ts;

  // Pass 1: row max, NaN-propagating like jnp.max / torch.amax.
  float m = -CUDART_INF_F;
  int has_nan = 0;
  for (int j = tid; j < V; j += kThreads) {
    const float v = row.x[j];
    if (isnan(v)) has_nan = 1; else m = fmaxf(m, v);
  }
  m = norma::block_max(m, shf);
  has_nan = norma::block_or(has_nan, shi);
  row.m = has_nan ? CUDART_NAN_F : m;

  // Pass 2: softmax denominator.
  float s = 0.f;
  for (int j = tid; j < V; j += kThreads) s += expf(row.x[j] - row.m);
  row.s = norma::block_sum(s, shf);

  // Pass 3 (only where the rule applies): timestamp mass vs best text token
  // over base = probs + suppress.
  row.force_ts = false;
  if (row.step != 0 && row.p1 <= no_ts) {
    float sum_ts = 0.f, max_txt = -CUDART_INF_F;
    int txt_nan = 0;
    for (int j = tid; j < V; j += kThreads) {
      const float base = row.prob(j) + msup[j];
      if (j > no_ts) sum_ts += base;
      if (j < no_ts) {
        if (isnan(base)) txt_nan = 1; else max_txt = fmaxf(max_txt, base);
      }
    }
    sum_ts = norma::block_sum(sum_ts, shf);
    max_txt = norma::block_max(max_txt, shf);
    txt_nan = norma::block_or(txt_nan, shi);
    row.force_ts = !txt_nan && sum_ts >= max_txt;
  }

  // Pass 4: masked values -> deadlock max, greedy argmax and (t>0) the
  // Gumbel-max draw argmax(masked / t + G), G = -log(-log(u)).
  const float t = temp[r];
  const bool sample = !greedy_only && t > 0.f;
  float mmax = -CUDART_INF_F, gk = -CUDART_INF_F, zk = -CUDART_INF_F;
  int mnan = 0, gi = V, zi = V;
  if (!sample) {
    for (int j = tid; j < V; j += kThreads) {
      const float v = row.masked(j);
      if (isnan(v)) mnan = 1; else mmax = fmaxf(mmax, v);
      norma::argmax_combine(gk, gi, nan_as_inf(v), j);
    }
  } else {
    const float tsafe = fmaxf(t, 1e-6f);
    const uint2 key = make_uint2((uint32_t)seed, (uint32_t)(seed >> 32));
    const int groups = (V + 3) / 4;
    for (int c = tid; c < groups; c += kThreads) {
      const uint4 bits = norma::philox4x32_10(
          make_uint4((uint32_t)c, (uint32_t)r, (uint32_t)row.step, 0u), key);
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        const int j = 4 * c + w;
        if (j >= V) break;
        const float v = row.masked(j);
        if (isnan(v)) mnan = 1; else mmax = fmaxf(mmax, v);
        norma::argmax_combine(gk, gi, nan_as_inf(v), j);
        const float u = norma::uniform_from_bits(norma::word(bits, w));
        const float z = v / tsafe - logf(-logf(u));
        norma::argmax_combine(zk, zi, nan_as_inf(z), j);
      }
    }
  }
  mmax = norma::block_max(mmax, shf);
  mnan = norma::block_or(mnan, shi);
  const int greedy_i = norma::block_argmax(gk, gi, shf, shi);
  int sample_i = greedy_i;
  if (sample) sample_i = norma::block_argmax(zk, zi, shf, shi);

  if (tid == 0) {
    // Deadlock == no finite masked weight (all -inf, or a NaN present).
    const bool dead = mnan || !isfinite(mmax);
    // Greedy in a deadlock: the reference's max_by keeps the LAST of the
    // equal -inf maxima, the highest vocab id.  t>0 pushes EOT instead.
    int choice = dead ? V - 1 : greedy_i;
    if (sample) choice = dead ? eot : sample_i;
    nxt[r] = choice;
    prob[r] = row.masked(choice);
    deadlock[r] = dead ? 1 : 0;
  }
}

// The uniform draws the sampler uses for (seed, step, row r, token j): the
// port of tools/verify_sample_kernel_tpu.py's u_kernel probe.
__global__ void philox_uniform_kernel(unsigned long long seed, int step, int V,
                                      float* __restrict__ out) {
  const int r = blockIdx.x;
  const uint2 key = make_uint2((uint32_t)seed, (uint32_t)(seed >> 32));
  const int groups = (V + 3) / 4;
  for (int c = threadIdx.x; c < groups; c += blockDim.x) {
    const uint4 bits = norma::philox4x32_10(
        make_uint4((uint32_t)c, (uint32_t)r, (uint32_t)step, 0u), key);
    for (int w = 0; w < 4; ++w) {
      const int j = 4 * c + w;
      if (j < V) out[(size_t)r * V + j] = norma::uniform_from_bits(norma::word(bits, w));
    }
  }
}

}  // namespace

extern "C" int norma_sample_step(
    const float* ll, const float* msup, const float* mnts, const float* mts,
    const float* mfirst, const int* prev1, const int* prev2, const int* last_ts,
    int step, const int* step_rows, const float* temp, unsigned long long seed,
    const unsigned long long* seed_ptr, int B, int V, int eot, int no_ts, int greedy_only,
    int* nxt, float* prob, unsigned char* deadlock, void* stream) {
  sample_step_kernel<<<B, kThreads, 0, (cudaStream_t)stream>>>(
      ll, msup, mnts, mts, mfirst, prev1, prev2, last_ts, step, step_rows, temp,
      seed, seed_ptr, V, eot, no_ts, greedy_only, nxt, prob, deadlock);
  return (int)cudaGetLastError();
}

extern "C" int norma_philox_uniform(unsigned long long seed, int step, int rows,
                                    int V, float* out, void* stream) {
  philox_uniform_kernel<<<rows, 256, 0, (cudaStream_t)stream>>>(seed, step, V, out);
  return (int)cudaGetLastError();
}

extern "C" const char* norma_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
