// A time mark: one thread writes the card's %globaltimer (ns) into a slot.
//
// Replaces no TPU kernel.  The window graph's regions (front, each token
// loop, finish) are timed by these marks at the graph's top level, between
// the work they bound (norma_tpu_torch/tracing.py::region); a timing event
// cannot serve there, since an event recorded inside a graph is one fixed
// event per capture and a later replay records it again before an earlier
// one's fetch reads it.  The slots are copied to the host with the
// program's pass counters (decode/engine.py::_Program.iters).
//
// Bound: launch latency (one 8-byte store).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void mark_kernel(int64_t* __restrict__ slot) {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  slot[0] = (int64_t)t;
}

}  // namespace

extern "C" int norma_mark(int64_t* slot, void* stream) {
  mark_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(slot);
  return (int)cudaGetLastError();
}
