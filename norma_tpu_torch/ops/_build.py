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
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
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
    "norma_log_mel": [
        P, I64, I64,  # audio, row stride, samples per row
        P, P, P, P,  # cos, sin, mel matrices, out
        I, I, I,  # B, T, n_mels
        P,  # stream
    ],
}

_lib: Optional[ctypes.CDLL] = None
build_info: dict = {}


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
    seconds and ptxas' resource report in :data:`build_info`."""
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
    """The loaded kernel library (built on first use)."""
    global _lib
    if _lib is None:
        cdll = ctypes.CDLL(build())
        for name, argtypes in SIGNATURES.items():
            fn = getattr(cdll, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        cdll.norma_error_string.argtypes = [I]
        cdll.norma_error_string.restype = ctypes.c_char_p
        _lib = cdll
    return _lib


def check(code: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if code != 0:
        msg = lib().norma_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg}) at launch")


def stream_ptr(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream
