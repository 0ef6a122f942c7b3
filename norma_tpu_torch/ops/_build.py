"""Build and load the package's CUDA kernels (``csrc/*.cu``).

Each source compiles in its own ``nvcc`` process, all started together,
and one more ``nvcc`` links the objects into a shared library with a plain
C interface, loaded with ``ctypes`` (no PyTorch headers, so a build takes
seconds, not minutes).  The TMA kernels encode their tensor maps through
the CUDA runtime's driver entry point (``csrc/hopper.cuh``), so nothing
links libcuda itself and no CUTLASS headers are needed.  The library
lands in ``build/norma_tpu_torch/`` beside the package, named by a hash
of the sources and flags: it is built on first use and again whenever a
source changes.  Every C entry point
returns ``cudaGetLastError()`` after its launch; :func:`check` raises on a
non-zero code.  Nothing here runs at import time.

Every wrapper launches through :func:`launch`, which is safe with several
devices and several threads: the launch runs with its tensors' device
current (a kernel launches, and its function attributes are set, on the
current device; ``csrc/common.cuh::FuncAttrs`` keeps them per device), on
that device's current stream, and its count is taken under a lock
(:func:`count`).  :func:`lib` builds and loads under a lock, so two
threads that reach it first at once run one build.
"""

from __future__ import annotations

import contextlib
import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Optional

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "norma_tpu_torch")
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

P = ctypes.c_void_p
I = ctypes.c_int
I64 = ctypes.c_int64
U64 = ctypes.c_uint64
F32 = ctypes.c_float

# C entry points: name -> argtypes.  Pointers and the stream are c_void_p.
SIGNATURES = {
    "norma_sample_step": [
        P, P, P, P, P,  # ll, m_suppress, m_non_ts, m_ts, m_first
        P, P, P,  # prev1, prev2, last_ts
        I, P,  # step (shared), step_rows (per-row or NULL)
        P, U64, P,  # temp, seed (by value), seed (device 64-bit, or NULL)
        I, I, I, I,  # B, V, cluster size, slice length
        I, I, I,  # eot, no_timestamps, greedy_only
        P, P, P,  # nxt, prob, deadlock
        P,  # stream
    ],
    "norma_philox_uniform": [U64, I, I, I, P, P],  # seed, step, rows, V, out, stream
    "norma_self_decode": [
        P, P, P, P, P, P,  # q, k_new, v_new, cache_k, cache_v, out
        I64, I64, I64,  # row strides of q, k_new, v_new
        I64, I64, I64, I64,  # cache_k strides (layer, batch), cache_v strides
        I, I, P,  # li, pos (by value), pos (device int64, or NULL)
        I, I, I, I,  # B, H, dh, T
        I, I, F32,  # is_bf16, cluster size, scale (dh**-0.5)
        P,  # stream
    ],
    "norma_cross_decode": [
        P, I64,  # q, q row stride
        P, P, I64, I64,  # k codes, v codes, codes layer / stream strides
        P, P, I64, I64,  # k scales, v scales, scales layer / stream strides
        P, I64,  # out, out row stride
        I, I, I, I, I, I,  # li, B, H, dh, G, Ta
        I, I,  # is_bf16, is_int4
        I, I, F32,  # cluster size, logits pitch, scale (dh**-0.5)
        P,  # stream
    ],
    "norma_flash_encoder": [
        P, P, P,  # q, k, v
        I64, I64, I64, I64, I64, I64,  # batch / row strides of q, k, v
        P, I, I, I, I,  # out, B, T, H, dh
        I, F32,  # is_bf16, scale (dh**-0.5)
        P,  # stream
    ],
    "norma_q8a8": [
        P, P, P, P, P, P,  # xq, xs, wq ([N, K] storage), ws, bias (or NULL), out
        I, I, I,  # M, N, K
        I, I,  # output tile width (64 or 128), bf16 output
        P,  # stream
    ],
    "norma_w8_matmul": [
        P, P, P, P,  # x, q, scale, out
        I, I, I, I64,  # M, N, K, code row pitch
        I, I, I,  # row tiles of 8, cluster size, is_bf16
        P,  # stream
    ],
    "norma_w4_matmul": [
        P, P, P, P,  # x, q, scale, out
        I, I, I, I64, I,  # M, N, K, code row pitch, blk
        I, I, I, I,  # row tiles of 8, cluster size, warps, is_bf16
        P,  # stream
    ],
    "norma_loop_cond": [P, I, P, I64, P, P],  # fin, B, pos, pos_end, out, stream
    "norma_mark": [P, P],  # slot, stream (tracing.py::device_mark)
    # While a stream captures (ops/loop_cond.py::while_node): fin, B, pos,
    # pos_end, the body's stream, the handle (out), the body graph (out),
    # the capturing stream; the handle, fin, B, pos, pos_end, iterations,
    # the body graph, its node counts by type (out) and their length, the
    # body's stream; a capturing stream and its nodes so far (out); a graph,
    # its node counts by type (out) and their length.
    "norma_while_begin": [P, I, P, I64, P, P, P, P],
    "norma_while_end": [U64, P, I, P, I64, P, P, P, I, P],
    "norma_capture_nodes": [P, P],
    "norma_graph_census": [P, P, I],
    "norma_capture_abort": [P],
    "norma_log_mel": [
        P, I64, I64,  # audio, row stride, samples per row
        P, P, P, P, I,  # cos/sin fragments, mel start, count, weights, weights per mel
        P, P,  # row max scratch, out
        I, I, I,  # B, T, n_mels
        P,  # stream
    ],
}

_lib: Optional[ctypes.CDLL] = None
_lock = threading.RLock()  # build() and lib(): one build at a time
build_info: dict = {}
# Launch counts: each wrapper's ``.launches`` changes under this lock.  A
# thread recording a CUDA graph capture tallies its launches in
# ``_capture.tally`` instead (:func:`recording_launches`).
_count_lock = threading.Lock()
_capture = threading.local()


def _sources():
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")) + glob.glob(os.path.join(CSRC, "*.cuh")))


def _nvcc() -> str:
    cands = [shutil.which("nvcc")]
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root:
            cands.append(os.path.join(root, "bin", "nvcc"))
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found (looked on PATH, $CUDA_HOME and /usr/local/cuda)")


def library_path() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in _sources():
        with open(s, "rb") as f:
            h.update(os.path.basename(s).encode())
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"libnorma_kernels_{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile the kernels if the current sources have no library yet;
    return the library's path.  Records nvcc's version line, the build
    seconds and ptxas' resource report in :data:`build_info`.  Under a
    lock: a second caller waits for the first one's build."""
    with _lock:
        return _build()


def _build() -> str:
    path = library_path()
    if os.path.exists(path):
        build_info.setdefault("seconds", 0.0)
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    ver = subprocess.run([nvcc, "--version"], capture_output=True, text=True, check=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    cu = [s for s in _sources() if s.endswith(".cu")]
    t0 = time.perf_counter()
    objs = [f"{tmp}.{os.path.basename(s)}.o" for s in cu]
    procs = [
        subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-I", CSRC, "-c", "-o", o, s],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )
        for s, o in zip(cu, objs)
    ]
    logs = [p.communicate() for p in procs]
    bad = [(s, p.returncode, out, err) for s, p, (out, err) in zip(cu, procs, logs) if p.returncode]
    if bad:
        raise RuntimeError(
            "nvcc failed:\n" + "\n".join(f"{s} ({rc}):\n{out}\n{err}" for s, rc, out, err in bad)
        )
    r = subprocess.run([nvcc, *ARCH, "-shared", "-o", tmp, *objs], capture_output=True, text=True)
    for o in objs:
        os.remove(o)
    if r.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({r.returncode}):\n{r.stdout}\n{r.stderr}")
    os.replace(tmp, path)
    build_info.update(
        nvcc=ver.stdout.strip().splitlines()[-1],
        seconds=time.perf_counter() - t0,
        ptxas="".join(err for _, err in logs),
    )
    return path


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first use, under a lock)."""
    global _lib
    with _lock:
        if _lib is None:
            cdll = ctypes.CDLL(build())
            for name, argtypes in SIGNATURES.items():
                fn = getattr(cdll, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            for name in ("norma_error_string", "norma_error_name"):
                getattr(cdll, name).argtypes = [I]
                getattr(cdll, name).restype = ctypes.c_char_p
            _lib = cdll
    return _lib


def check(code: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if code != 0:
        raise RuntimeError(f"{what}: CUDA error {error_text(code)} at launch")


def error_text(code: int) -> str:
    """A CUDA error code as ``<code> (<name>: <description>)``."""
    return f"{code} ({lib().norma_error_name(code).decode()}: {lib().norma_error_string(code).decode()})"


def launch(entry: str, counter, device, *args) -> None:
    """Call the C entry point ``entry`` with ``args`` and the current stream
    of ``device``, with ``device`` the current device, then raise on its
    error code (:func:`check`) and count one launch on ``counter``.  The
    device is switched, and switched back, only when another one is
    current, so a launch on the current card pays nothing for it."""
    import torch

    fn = getattr(lib(), entry)
    idx = device.index
    if idx is None or idx == torch.cuda.current_device():
        code = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    else:
        with torch.cuda.device(idx):
            code = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    check(code, f"{entry[len('norma_'):]} kernel")
    count(counter)


def count(counter, n: int = 1) -> None:
    """Add ``n`` launches to ``counter.launches`` under the counters' lock;
    in a thread recording a capture (:func:`recording_launches`), to the
    capture's tally instead."""
    tally = getattr(_capture, "tally", None)
    if tally is not None:
        tally[counter] = tally.get(counter, 0) + n
        return
    with _count_lock:
        counter.launches += n


def count_all(tally) -> None:
    """Add a tally ``{counter: launches}`` to the counters (a graph replay
    adds the launches its capture recorded)."""
    with _count_lock:
        for counter, n in tally.items():
            counter.launches += n


@contextlib.contextmanager
def recording_launches():
    """Within the block, this thread's launches go to the yielded tally
    ``{counter: launches}``, not to the counters: a CUDA graph capture
    records its launches once and adds them at each replay
    (:func:`count_all`).  Other threads keep counting as before."""
    prev = getattr(_capture, "tally", None)
    _capture.tally = tally = {}
    try:
        yield tally
    finally:
        _capture.tally = prev
