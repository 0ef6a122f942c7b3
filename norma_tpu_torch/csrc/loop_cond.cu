// The token loop's stop test on the device, and the WHILE nodes that run
// the loop inside one CUDA graph.
//
// Replaces no TPU kernel: it is the condition of the JAX package's
// `lax.while_loop` per cache crop (norma_tpu/decode/engine.py:459, :572,
// "any row unfinished and the next row fits in this crop"), which XLA
// evaluates on the TPU.  Here it runs as one tiny kernel that reads the
// finished flags and the position and sets a CUDA graph conditional handle
// (CUDA 12.4+), so a window's token loops run without a host read.
//
// Bound: launch latency.  It reads B bools and one int64 (B <= a few
// hundred rows) with one block; its design is one block of 128 threads,
// one __syncthreads_or, and thread 0 writing the handle.
//
// Host side (plain C, called through ctypes while a stream captures):
// norma_while_begin adds, after the capturing stream's current nodes, the
// condition's kernel and a WHILE node whose body graph the given body
// stream then captures into; norma_while_end puts the condition's kernel at
// the end of that body (it also counts the iteration) and ends the body's
// capture; norma_capture_nodes counts a capture's nodes and
// norma_graph_census a graph's nodes by type (what a failed body holds:
// a WHILE body admits kernel, memcpy, memset, empty, child-graph and
// conditional nodes only).  norma_loop_cond runs the condition alone,
// outside any graph, writing the predicate: its check against the plain
// version.

#include <cuda_runtime.h>
#include <stdint.h>

#include <vector>

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads) loop_cond_kernel(
    cudaGraphConditionalHandle handle, int set_handle, const bool* __restrict__ fin, int B,
    const int64_t* __restrict__ pos, int64_t pos_end, int64_t* __restrict__ iters,
    unsigned char* __restrict__ out) {
  int live = 0;
  for (int i = threadIdx.x; i < B; i += kThreads) live |= !fin[i];
  live = __syncthreads_or(live);
  if (threadIdx.x != 0) return;
  const unsigned int go = (live && pos[0] < pos_end) ? 1u : 0u;
  if (set_handle) cudaGraphSetConditional(handle, go);
  if (iters) iters[0] += 1;
  if (out) out[0] = (unsigned char)go;
}

cudaError_t launch_cond(cudaStream_t s, cudaGraphConditionalHandle h, int set_handle, const bool* fin, int B,
                        const int64_t* pos, int64_t pos_end, int64_t* iters, unsigned char* out) {
  loop_cond_kernel<<<1, kThreads, 0, s>>>(h, set_handle, fin, B, pos, pos_end, iters, out);
  return cudaGetLastError();
}

#define NT_TRY(x)                              \
  do {                                         \
    const cudaError_t e_ = (x);                \
    if (e_ != cudaSuccess) return (int)e_;     \
  } while (0)

}  // namespace

// The predicate alone: out[0] = any(!fin[0:B]) && pos[0] < pos_end.
extern "C" int norma_loop_cond(const bool* fin, int B, const int64_t* pos, long long pos_end, unsigned char* out,
                               void* stream) {
  if (B <= 0) return (int)cudaErrorInvalidValue;
  return (int)launch_cond((cudaStream_t)stream, 0, 0, fin, B, pos, pos_end, nullptr, out);
}

// While `stream` captures: a conditional handle on its graph, the
// condition's kernel after its current nodes, then a WHILE node after that
// kernel; `stream` continues after the node, and `body` starts capturing
// into the node's body graph.  The handle goes to *handle_out, the body
// graph to *body_out.
extern "C" int norma_while_begin(const bool* fin, int B, const int64_t* pos, long long pos_end, void* body,
                                 unsigned long long* handle_out, void** body_out, void* stream) {
  if (B <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  cudaStreamCaptureStatus status;
  cudaGraph_t graph;
  const cudaGraphNode_t* deps = nullptr;
  size_t n_deps = 0;
  NT_TRY(cudaStreamGetCaptureInfo(s, &status, nullptr, &graph, &deps, &n_deps));
  if (status != cudaStreamCaptureStatusActive) return (int)cudaErrorIllegalState;
  cudaGraphConditionalHandle h;
  NT_TRY(cudaGraphConditionalHandleCreate(&h, graph, 0, 0));
  NT_TRY(launch_cond(s, h, 1, fin, B, pos, pos_end, nullptr, nullptr));
  NT_TRY(cudaStreamGetCaptureInfo(s, &status, nullptr, &graph, &deps, &n_deps));
  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = h;
  params.conditional.type = cudaGraphCondTypeWhile;
  params.conditional.size = 1;
  cudaGraphNode_t node;
  NT_TRY(cudaGraphAddNode(&node, graph, deps, n_deps, &params));
  NT_TRY(cudaStreamUpdateCaptureDependencies(s, &node, 1, cudaStreamSetCaptureDependencies));
  NT_TRY(cudaStreamBeginCaptureToGraph((cudaStream_t)body, params.conditional.phGraph_out[0], nullptr, nullptr, 0,
                                       cudaStreamCaptureModeThreadLocal));
  *handle_out = h;
  *body_out = (void*)params.conditional.phGraph_out[0];
  return (int)cudaSuccess;
}

// The nodes of the graph `stream` is capturing into, so far.
extern "C" int norma_capture_nodes(void* stream, unsigned long long* n_out) {
  cudaStreamCaptureStatus status;
  cudaGraph_t graph;
  NT_TRY(cudaStreamGetCaptureInfo((cudaStream_t)stream, &status, nullptr, &graph, nullptr, nullptr));
  if (status != cudaStreamCaptureStatusActive) return (int)cudaErrorIllegalState;
  size_t n = 0;
  NT_TRY(cudaGraphGetNodes(graph, nullptr, &n));
  *n_out = n;
  return (int)cudaSuccess;
}

// `graph`'s nodes by type: counts[t] += the nodes of cudaGraphNodeType t
// (a type at or past n_types counts in counts[n_types - 1]).
extern "C" int norma_graph_census(void* graph, unsigned long long* counts, int n_types) {
  if (n_types <= 0) return (int)cudaErrorInvalidValue;
  cudaGraph_t g = (cudaGraph_t)graph;
  size_t n = 0;
  NT_TRY(cudaGraphGetNodes(g, nullptr, &n));
  std::vector<cudaGraphNode_t> nodes(n);
  if (n) NT_TRY(cudaGraphGetNodes(g, nodes.data(), &n));
  for (size_t i = 0; i < n; ++i) {
    cudaGraphNodeType t;
    NT_TRY(cudaGraphNodeGetType(nodes[i], &t));
    const int k = (int)t;
    counts[(k >= 0 && k < n_types) ? k : n_types - 1] += 1;
  }
  return (int)cudaSuccess;
}

// The end of a WHILE body captured on `body` into `body_graph`: the
// condition's kernel sets the handle for the next iteration and adds one
// to iters[0]; the body's nodes by type go to counts (norma_graph_census);
// then the body's capture ends (the body graph belongs to its node).
extern "C" int norma_while_end(unsigned long long handle, const bool* fin, int B, const int64_t* pos,
                               long long pos_end, int64_t* iters, void* body_graph, unsigned long long* counts,
                               int n_types, void* body) {
  cudaStream_t s = (cudaStream_t)body;
  cudaError_t e = launch_cond(s, handle, 1, fin, B, pos, pos_end, iters, nullptr);
  if (e == cudaSuccess) e = (cudaError_t)norma_graph_census(body_graph, counts, n_types);
  cudaGraph_t g;
  const cudaError_t ended = cudaStreamEndCapture(s, &g);
  return (int)(e != cudaSuccess ? e : ended);
}

// End a body's capture after an error in it (the outer capture is then
// invalid and its end reports the failure); returns the end's error.
extern "C" int norma_capture_abort(void* stream) {
  cudaGraph_t g = nullptr;
  const cudaError_t e = cudaStreamEndCapture((cudaStream_t)stream, &g);
  cudaGetLastError();
  return (int)e;
}
