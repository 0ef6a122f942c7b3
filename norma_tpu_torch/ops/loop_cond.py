"""The token loop's stop test on the device (``csrc/loop_cond.cu``) and the
WHILE nodes that run a loop inside one CUDA graph.

The JAX package runs each cache crop's token loop as a ``lax.while_loop``
whose condition, "any row unfinished and the next row fits in this crop"
(``norma_tpu/decode/engine.py:459``, ``:572``), XLA evaluates on the TPU.
The port evaluates it with a small kernel that sets a CUDA graph
conditional handle (CUDA 12.4+), so a window captured as one graph runs its
token loops with no host read:

  - :func:`loop_cond_torch` -- the plain version of the predicate;
  - :func:`loop_cond` -- the wrapper: the kernel on CUDA tensors (alone, it
    writes the predicate: its check against the plain version), the plain
    version on CPU tensors.  ``loop_cond.launches`` counts kernel launches,
    those inside captured WHILE nodes included;
  - :func:`while_node` -- while a stream captures a CUDA graph: the
    condition's kernel and a WHILE node after the captured work so far,
    whose body is ``body()`` (captured on a stream of its own, its memory
    from the graph's pool) followed by the condition's kernel again, which
    also counts the body's iterations on the device; :func:`capture_nodes`
    counts a capture's nodes, and a WHILE body's nodes by type come back
    with it (what a failed body holds is in its error).
"""

from __future__ import annotations

import ctypes

import torch

from . import _build


def _check(fin: torch.Tensor, pos: torch.Tensor) -> None:
    if fin.dtype != torch.bool or fin.dim() != 1 or fin.numel() < 1 or not fin.is_contiguous():
        raise ValueError(f"loop_cond: fin must be a contiguous [B] bool tensor, got {fin.dtype} {tuple(fin.shape)}")
    if pos.dtype != torch.int64 or pos.numel() != 1 or pos.device != fin.device:
        raise ValueError(f"loop_cond: pos must be one int64 on {fin.device}")


def loop_cond_torch(fin: torch.Tensor, pos: torch.Tensor, pos_end: int) -> torch.Tensor:
    """[1] uint8: any(~fin) and pos[0] < pos_end."""
    return ((~fin).any() & (pos.reshape(-1)[0] < pos_end)).to(torch.uint8).reshape(1)


def loop_cond(fin: torch.Tensor, pos: torch.Tensor, pos_end: int) -> torch.Tensor:
    """:func:`loop_cond_torch` through the kernel on CUDA tensors."""
    _check(fin, pos)
    if fin.device.type == "cpu":
        return loop_cond_torch(fin, pos, pos_end)
    out = torch.empty(1, dtype=torch.uint8, device=fin.device)
    _build.launch("norma_loop_cond", loop_cond, fin.device, fin.data_ptr(), fin.numel(), pos.data_ptr(),
                  int(pos_end), out.data_ptr())
    return out


loop_cond.launches = 0


def capture_nodes(stream) -> int:
    """The nodes so far of the graph ``stream`` (a ``torch.cuda.Stream``)
    is capturing into."""
    n = ctypes.c_uint64()
    _build.check(_build.lib().norma_capture_nodes(stream.cuda_stream, ctypes.byref(n)), "capture_nodes")
    return n.value


# cudaGraphNodeType by value (CUDA 12.4+; 12 is the driver's batch of
# memory operations, which the runtime's enum does not name), and the types
# a conditional node's body admits.
NODE_TYPES = ("kernel", "memcpy", "memset", "host", "graph", "empty", "wait_event", "event_record",
              "ext_semaphore_signal", "ext_semaphore_wait", "mem_alloc", "mem_free", "batch_mem_op",
              "conditional", "other")
BODY_TYPES = frozenset({"kernel", "memcpy", "memset", "graph", "empty", "conditional"})


def _census(counts) -> dict:
    """``norma_graph_census``'s counts as ``{type name: nodes}``."""
    return {name: int(n) for name, n in zip(NODE_TYPES, counts) if n}


def census_text(census: dict) -> str:
    """A census, with the types a WHILE body does not admit named."""
    bad = sorted(set(census) - BODY_TYPES)
    return f"{census}" + (f", not admitted in a WHILE body: {bad}" if bad else "")


def while_node(fin: torch.Tensor, pos: torch.Tensor, pos_end: int, body, *, pool, body_stream, iters):
    """Capture ``while loop_cond(fin, pos, pos_end): body()`` into the graph
    the current stream is capturing, as one WHILE node; ``iters`` (one
    int64 on the device) gains one per iteration when the graph runs.

    ``body`` runs once, now, on ``body_stream`` (a stream of ``fin``'s
    device that nothing else uses while this runs), its allocations routed
    to the capture's memory ``pool``.  Returns (the kernel launches the
    body recorded, ``{counter: launches per iteration}``, which the caller
    adds once per iteration it learns of; the body graph's nodes by type,
    ``{type name: nodes}``).  The condition's two launches are counted: one
    in the graph, one in the body's tally.  A failure raises, naming the
    CUDA error and the body's nodes by type so far; the graph's capture is
    then invalid."""
    _check(fin, pos)
    dev = fin.device
    lib = _build.lib()
    outer = torch.cuda.current_stream(dev)
    handle, body_graph = ctypes.c_uint64(), ctypes.c_void_p()
    args = (fin.data_ptr(), fin.numel(), pos.data_ptr(), int(pos_end))
    _build.check(lib.norma_while_begin(*args, body_stream.cuda_stream, ctypes.byref(handle),
                                       ctypes.byref(body_graph), outer.cuda_stream), "while_begin")
    _build.count(loop_cond)
    counts = (ctypes.c_uint64 * len(NODE_TYPES))()
    # The caching allocator sends one stream's allocations to a capture's
    # pool at a time: the body's stream takes it over while the body is
    # captured, then the outer stream takes it back.  Each begin adds a
    # user of the pool, which the release after it removes again.
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    torch._C._cuda_endAllocateToPool(idx, pool)
    try:
        with torch.cuda.stream(body_stream), _build.recording_launches() as tally:
            torch._C._cuda_beginAllocateCurrentStreamToPool(idx, pool)
            try:
                try:
                    body()
                except Exception as e:
                    counts_so_far = (ctypes.c_uint64 * len(NODE_TYPES))()
                    lib.norma_graph_census(body_graph, counts_so_far, len(NODE_TYPES))
                    code = lib.norma_capture_abort(body_stream.cuda_stream)
                    raise RuntimeError(
                        f"a WHILE body's capture failed: {type(e).__name__}: {e}; ending it: CUDA error "
                        f"{_build.error_text(code)}; the body's nodes so far: {census_text(_census(counts_so_far))}"
                    ) from e
                except BaseException:
                    lib.norma_capture_abort(body_stream.cuda_stream)
                    raise
                code = lib.norma_while_end(handle.value, *args, iters.data_ptr(), body_graph, counts,
                                           len(NODE_TYPES), body_stream.cuda_stream)
                if code:
                    raise RuntimeError(f"a WHILE body's capture failed at its end: CUDA error "
                                       f"{_build.error_text(code)}; the body's nodes: {census_text(_census(counts))}")
                _build.count(loop_cond)
            finally:
                torch._C._cuda_endAllocateToPool(idx, pool)
                torch._C._cuda_releasePool(idx, pool)
    finally:
        torch._C._cuda_beginAllocateCurrentStreamToPool(idx, pool)
        torch._C._cuda_releasePool(idx, pool)
    return tally, _census(counts)
