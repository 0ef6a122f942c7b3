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
// 6-48 rows are 1-10 MB, a few microseconds of HBM time) but latency: the
// reductions between passes and the launch.  One CTA walking a row four
// times (the first design) took ~75 us at 8 rows on 8 of the 132 SMs.
//
// Design: each row is served by a thread-block cluster of C CTAs (1-16,
// ops/sample_step.py::sample_step_plan: B x C CTAs cover the SMs).  CTA k
// loads its slice of the row, vocab ids [k L, (k + 1) L) (L a multiple of 4,
// so Philox groups never straddle two CTAs), from device memory once into
// shared memory, where the slice's exp(x - max) then replaces the logits.
// After each pass a block reduction (warp shuffles, then shared memory)
// gives the CTA's part; the cluster's parts meet through distributed shared
// memory (each CTA publishes its part, cluster.sync(), and warp 0 of every
// CTA combines the C parts, lane k holding rank k's, in a fixed shuffle
// order, so every CTA gets the same value):
//   1. the row max with the NaN flag;
//   2. the sum of exp(x - max);
//   3. (sum_ts, max_txt, txt_nan) over the suppressed probabilities, only
//      where the rule applies (a row-uniform test, so the cluster agrees);
//   4. the masked values: their max and NaN flag (the deadlock test), the
//      greedy (value, first index) and the Gumbel (value, first index).
// The first-index rule and NaN-as-+inf are order-free, so greedy tokens are
// exact against the plain version.  Masks are additive -inf in PROBABILITY
// space, as in the reference; rank 0 writes the outputs and computes the
// chosen token's probability by the one formula (masked_at) from the row's
// max and sum, so it equals the value the argmax saw, bit for bit.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kMaxCluster = 16;
constexpr int kMaxSliceBytes = 229376;  // shared memory for the slice (of 232448 a block may use)

struct Row {
  float m, s;  // row max (NaN if any NaN) and sum of exp(x - m)
  const float *msup, *mnts, *mts, *mfirst;
  int p1, p2, lts, step, eot, no_ts;
  bool force_ts;

  // The masked value at vocab id j whose probability is pr.
  __device__ __forceinline__ float masked(int j, float pr) const {
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

__device__ __forceinline__ float shfl(float v, int o) { return __shfl_xor_sync(0xffffffffu, v, o); }
__device__ __forceinline__ int shfl(int v, int o) { return __shfl_xor_sync(0xffffffffu, v, o); }

// The parts each pass reduces: none() is the identity, add() the
// combination (commutative, so a butterfly gives every lane the same value).
struct MaxNan {  // pass 1: the row max (NaN excluded) and the NaN flag
  float m;
  int nan;
  __device__ static MaxNan none() { return {-CUDART_INF_F, 0}; }
  __device__ MaxNan xor_lane(int o) const { return {shfl(m, o), shfl(nan, o)}; }
  __device__ void add(const MaxNan& o) {
    m = fmaxf(m, o.m);
    nan |= o.nan;
  }
};
struct Sum {  // pass 2: the softmax denominator
  float s;
  __device__ static Sum none() { return {0.f}; }
  __device__ Sum xor_lane(int o) const { return {shfl(s, o)}; }
  __device__ void add(const Sum& o) { s += o.s; }
};
struct TsRule {  // pass 3: timestamp mass, best text probability, text NaN flag
  float sum_ts, max_txt;
  int nan;
  __device__ static TsRule none() { return {0.f, -CUDART_INF_F, 0}; }
  __device__ TsRule xor_lane(int o) const { return {shfl(sum_ts, o), shfl(max_txt, o), shfl(nan, o)}; }
  __device__ void add(const TsRule& o) {
    sum_ts += o.sum_ts;
    max_txt = fmaxf(max_txt, o.max_txt);
    nan |= o.nan;
  }
};
struct Pick {  // pass 4: masked max and NaN flag, greedy and Gumbel (value, first index)
  float mmax, gk, zk;
  int mnan, gi, zi;
  __device__ static Pick none() { return {-CUDART_INF_F, -CUDART_INF_F, -CUDART_INF_F, 0, 0x7fffffff, 0x7fffffff}; }
  __device__ Pick xor_lane(int o) const {
    return {shfl(mmax, o), shfl(gk, o), shfl(zk, o), shfl(mnan, o), shfl(gi, o), shfl(zi, o)};
  }
  __device__ void add(const Pick& o) {
    mmax = fmaxf(mmax, o.mmax);
    mnan |= o.mnan;
    norma::argmax_combine(gk, gi, o.gk, o.gi);
    norma::argmax_combine(zk, zi, o.zk, o.zi);
  }
};

template <typename P>
__device__ __forceinline__ P warp_all(P v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v.add(v.xor_lane(o));
  return v;
}

// The cluster's value of a pass's part v: the block's warps meet in warp 0
// (one barrier), which publishes the CTA's part; after cluster.sync() warp 0
// of every CTA (of rank 0 only, with !every) combines the C parts, lane k
// holding rank k's, and the block reads the value back (one barrier).  Every
// step is a fixed tree, so the value is the same on every CTA and every run.
// wp holds >= 32 parts; pub is this pass's own slot (a CTA may still read
// another's slot of an earlier pass); bc is the block's copy of the value.
template <typename P>
__device__ __forceinline__ P cluster_reduce(P v, P* wp, P* pub, P* bc, cg::cluster_group& cluster, bool every) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  const int C = (int)cluster.num_blocks();
  v = warp_all(v);
  if (lane == 0) wp[warp] = v;
  __syncthreads();
  if (warp == 0) {
    const P b = warp_all(lane < nw ? wp[lane] : P::none());
    if (lane == 0) *pub = b;
  }
  cluster.sync();
  if (warp == 0 && (every || cluster.block_rank() == 0)) {
    const P c = warp_all(lane < C ? *cluster.map_shared_rank(pub, lane) : P::none());
    if (lane == 0) *bc = c;
  }
  __syncthreads();
  return *bc;
}

__global__ void __launch_bounds__(kThreads) sample_step_kernel(
    const float* __restrict__ ll, const float* __restrict__ msup,
    const float* __restrict__ mnts, const float* __restrict__ mts,
    const float* __restrict__ mfirst, const int* __restrict__ prev1,
    const int* __restrict__ prev2, const int* __restrict__ last_ts, int step,
    const int* __restrict__ step_rows, const float* __restrict__ temp,
    unsigned long long seed_val, const unsigned long long* __restrict__ seed_ptr, int V, int L,
    int eot, int no_ts, int greedy_only,
    int* __restrict__ nxt, float* __restrict__ prob,
    unsigned char* __restrict__ deadlock) {
  extern __shared__ float xs[];  // the slice: logits, then exp(x - m)
  __shared__ Pick wp[32];        // the warps' parts (as any pass's type)
  __shared__ Pick bc;            // the cluster's value, for the block
  __shared__ MaxNan pub1;        // this CTA's part of each pass, for the cluster
  __shared__ Sum pub2;
  __shared__ TsRule pub3;
  __shared__ Pick pub4;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int r = blockIdx.y, tid = threadIdx.x;
  const int j0 = min(rank * L, V), n = min(j0 + L, V) - j0;
  const float* x = ll + (size_t)r * V;
  auto as = [](Pick* p, auto none) { return reinterpret_cast<decltype(none)*>(p); };

  Row row;
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

  // Pass 1: the slice into shared memory; row max, NaN-propagating like
  // jnp.max / torch.amax.
  MaxNan p1 = MaxNan::none();
#pragma unroll 4
  for (int i = tid; i < n; i += kThreads) {
    const float v = x[j0 + i];
    xs[i] = v;
    if (isnan(v)) p1.nan = 1; else p1.m = fmaxf(p1.m, v);
  }
  p1 = cluster_reduce(p1, as(wp, p1), &pub1, as(&bc, p1), cluster, true);
  row.m = p1.nan ? CUDART_NAN_F : p1.m;

  // Pass 2: exp(x - m) in place, and the softmax denominator.
  Sum p2 = Sum::none();
  for (int i = tid; i < n; i += kThreads) {
    const float e = expf(xs[i] - row.m);
    xs[i] = e;
    p2.s += e;
  }
  row.s = cluster_reduce(p2, as(wp, p2), &pub2, as(&bc, p2), cluster, true).s;

  // Pass 3 (only where the rule applies, the same on every CTA of the
  // row): timestamp mass vs best text token over base = probs + suppress.
  row.force_ts = false;
  if (row.step != 0 && row.p1 <= no_ts) {
    TsRule p3 = TsRule::none();
    for (int i = tid; i < n; i += kThreads) {
      const int j = j0 + i;
      const float base = xs[i] / row.s + msup[j];
      if (j > no_ts) p3.sum_ts += base;
      if (j < no_ts) {
        if (isnan(base)) p3.nan = 1; else p3.max_txt = fmaxf(p3.max_txt, base);
      }
    }
    p3 = cluster_reduce(p3, as(wp, p3), &pub3, as(&bc, p3), cluster, true);
    row.force_ts = !p3.nan && p3.sum_ts >= p3.max_txt;
  }

  // Pass 4: masked values -> deadlock max, greedy argmax and (t>0) the
  // Gumbel-max draw argmax(masked / t + G), G = -log(-log(u)).
  const float t = temp[r];
  const bool sample = !greedy_only && t > 0.f;
  Pick p4 = Pick::none();
  p4.gi = p4.zi = V;
  if (!sample) {
    for (int i = tid; i < n; i += kThreads) {
      const int j = j0 + i;
      const float v = row.masked(j, xs[i] / row.s);
      if (isnan(v)) p4.mnan = 1; else p4.mmax = fmaxf(p4.mmax, v);
      norma::argmax_combine(p4.gk, p4.gi, nan_as_inf(v), j);
    }
  } else {
    const unsigned long long seed = seed_ptr != nullptr ? *seed_ptr : seed_val;
    const float tsafe = fmaxf(t, 1e-6f);
    const uint2 key = make_uint2((uint32_t)seed, (uint32_t)(seed >> 32));
    for (int c = j0 / 4 + tid; 4 * c < j0 + n; c += kThreads) {
      const uint4 bits = norma::philox4x32_10(
          make_uint4((uint32_t)c, (uint32_t)r, (uint32_t)row.step, 0u), key);
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        const int j = 4 * c + w;
        if (j >= j0 + n) break;
        const float v = row.masked(j, xs[j - j0] / row.s);
        if (isnan(v)) p4.mnan = 1; else p4.mmax = fmaxf(p4.mmax, v);
        norma::argmax_combine(p4.gk, p4.gi, nan_as_inf(v), j);
        const float u = norma::uniform_from_bits(norma::word(bits, w));
        const float z = v / tsafe - logf(-logf(u));
        norma::argmax_combine(p4.zk, p4.zi, nan_as_inf(z), j);
      }
    }
  }
  p4 = cluster_reduce(p4, wp, &pub4, &bc, cluster, false);
  if (rank == 0 && tid == 0) {
    // Deadlock == no finite masked weight (all -inf, or a NaN present).
    const bool dead = p4.mnan || !isfinite(p4.mmax);
    // Greedy in a deadlock: the reference's max_by keeps the LAST of the
    // equal -inf maxima, the highest vocab id.  t>0 pushes EOT instead.
    int choice = dead ? V - 1 : p4.gi;
    if (sample) choice = dead ? eot : p4.zi;
    nxt[r] = choice;
    prob[r] = row.masked(choice, expf(x[choice] - row.m) / row.s);
    deadlock[r] = dead ? 1 : 0;
  }
  cluster.sync();  // no CTA leaves while rank 0 reads its parts
}

// The uniform draws the sampler uses for (seed, step, row r, token j):
// u[r, j] = uniform_from_bits(word j % 4 of Philox4x32-10 at counter
// (j / 4, r, step, 0), key (seed bits 0-31, 32-63)), as pass 4 above draws
// them.  Replaces the TPU probe tools/verify_sample_kernel_tpu.py:120
// (u_kernel, pl.pallas_call at :128).  Bound by its [rows, V] f32 store:
// 1.24 MB at 6 x 51866, ~0.4 us at 3.35 TB/s, so at that shape the launch
// dominates.  Design: one Philox group per thread over rows x ceil(V / 4)
// groups (6 x 12967 threads: ~300 blocks, all of the card), each group's
// four uniforms in the widest store the row's alignment allows (16 bytes
// where r * V is a multiple of 4, else two 8-byte stores where it is even,
// else four scalar ones; the ragged end of a row scalar).
__global__ void __launch_bounds__(256) philox_uniform_kernel(unsigned long long seed, int step, int V,
                                                            float* __restrict__ out) {
  const int r = blockIdx.y;
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  const int j = 4 * c;
  if (j >= V) return;
  const uint4 bits = norma::philox4x32_10(make_uint4((uint32_t)c, (uint32_t)r, (uint32_t)step, 0u),
                                          make_uint2((uint32_t)seed, (uint32_t)(seed >> 32)));
  const float u0 = norma::uniform_from_bits(bits.x), u1 = norma::uniform_from_bits(bits.y);
  const float u2 = norma::uniform_from_bits(bits.z), u3 = norma::uniform_from_bits(bits.w);
  float* p = out + (size_t)r * V + j;
  const uintptr_t a = (uintptr_t)p;
  if (j + 4 <= V && (a & 15) == 0) {
    *reinterpret_cast<float4*>(p) = make_float4(u0, u1, u2, u3);
  } else if (j + 4 <= V && (a & 7) == 0) {
    reinterpret_cast<float2*>(p)[0] = make_float2(u0, u1);
    reinterpret_cast<float2*>(p)[1] = make_float2(u2, u3);
  } else {
    const float u[4] = {u0, u1, u2, u3};
#pragma unroll
    for (int w = 0; w < 4; ++w)
      if (j + w < V) p[w] = u[w];
  }
}

}  // namespace

// ll [B, V] f32 contiguous; masks [V] f32; prev1 / prev2 / last_ts [B]
// int32; step_rows [B] int32 or NULL (then `step` for every row); temp [B]
// f32; seed_ptr one 64-bit seed on the device or NULL (then `seed`).  Each
// row runs on a cluster of `cluster` CTAs (1-16) of slices of L vocab ids
// (L a multiple of 4, cluster * L >= V).
extern "C" int norma_sample_step(
    const float* ll, const float* msup, const float* mnts, const float* mts,
    const float* mfirst, const int* prev1, const int* prev2, const int* last_ts,
    int step, const int* step_rows, const float* temp, unsigned long long seed,
    const unsigned long long* seed_ptr, int B, int V, int cluster, int L, int eot, int no_ts,
    int greedy_only, int* nxt, float* prob, unsigned char* deadlock, void* stream) {
  if (B <= 0 || V <= 0 || cluster < 1 || cluster > kMaxCluster || L <= 0 || L % 4 ||
      (long long)cluster * L < V || (long long)L * 4 > kMaxSliceBytes || B > 65535)
    return (int)cudaErrorInvalidValue;
  const int smem = L * 4;
  static norma::FuncAttrs attrs;  // set per device (the first launches are eager)
  if (const cudaError_t e = attrs.ensure(sample_step_kernel, smem, cluster > 8); e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)cluster, (unsigned)B, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, sample_step_kernel, ll, msup, mnts, mts, mfirst, prev1, prev2,
                                           last_ts, step, step_rows, temp, seed, seed_ptr, V, L, eot, no_ts,
                                           greedy_only, nxt, prob, deadlock);
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}

extern "C" int norma_philox_uniform(unsigned long long seed, int step, int rows,
                                    int V, float* out, void* stream) {
  if (rows <= 0 || rows > 65535 || V <= 0) return (int)cudaErrorInvalidValue;
  const int groups = (V + 3) / 4;
  philox_uniform_kernel<<<dim3((groups + 255) / 256, rows), 256, 0, (cudaStream_t)stream>>>(seed, step, V, out);
  return (int)cudaGetLastError();
}

extern "C" const char* norma_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

extern "C" const char* norma_error_name(int code) {
  return cudaGetErrorName((cudaError_t)code);
}
