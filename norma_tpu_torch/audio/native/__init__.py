"""Native audio runtime: build-on-demand ctypes binding (a copy of
``norma_tpu/audio/native``).

The C++ source (``norma_audio.cpp``, the JAX package's verbatim, with the
same C ABI and the same ``NTA_ALSA_LIB`` override) lives beside this file.
The shared library is compiled with g++ at first use (plain C ABI + ctypes,
no pybind11) into ``build/norma_tpu_torch/`` beside the package, named by a
hash of the source and flags, as the CUDA kernels are (``ops/_build.py``).
Every entry degrades gracefully: if no toolchain is available, ``load()``
returns None and callers fall back to the pure-Python implementations.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import threading
from typing import Optional

logger = logging.getLogger(__name__)

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "norma_audio.cpp")
_PKG = os.path.dirname(os.path.dirname(_DIR))
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "norma_tpu_torch")
CXX_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def library_path() -> str:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    with open(_SRC, "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR, f"libnorma_audio_{h.hexdigest()[:16]}.so")


def build() -> Optional[str]:
    """Compile the shared library if the source has none yet; returns its
    path or None."""
    path = library_path()
    if os.path.exists(path):
        return path
    tmp = f"{path}.{os.getpid()}.tmp"
    cmd = ["g++", *CXX_FLAGS, "-o", tmp, _SRC, "-ldl", "-lpthread"]
    try:
        os.makedirs(BUILD_DIR, exist_ok=True)
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, path)  # atomic: a concurrent build never sees half a file
        return path
    except (OSError, subprocess.SubprocessError) as e:
        logger.warning("native audio build failed: %s", e)
        return None
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def load() -> Optional[ctypes.CDLL]:
    """Build (if needed) and load the native library; None on failure."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        path = build()
        if path is None:
            return None
        lib = ctypes.CDLL(path)

        c = ctypes
        fp = c.POINTER(c.c_float)
        lib.nta_ring_new.restype = c.c_void_p
        lib.nta_ring_new.argtypes = [c.c_int64, c.c_int64]
        lib.nta_ring_try_send.restype = c.c_int
        lib.nta_ring_try_send.argtypes = [c.c_void_p, fp, c.c_int64]
        lib.nta_ring_recv.restype = c.c_int64
        lib.nta_ring_recv.argtypes = [c.c_void_p, fp, c.c_int]
        lib.nta_ring_close.argtypes = [c.c_void_p]
        lib.nta_ring_dropped.restype = c.c_uint64
        lib.nta_ring_dropped.argtypes = [c.c_void_p]
        lib.nta_ring_chunk_len.restype = c.c_int64
        lib.nta_ring_chunk_len.argtypes = [c.c_void_p]
        lib.nta_ring_free.argtypes = [c.c_void_p]

        lib.nta_resampler_new.restype = c.c_void_p
        lib.nta_resampler_new.argtypes = [c.c_double, c.c_double]
        lib.nta_resampler_process.restype = c.c_int64
        lib.nta_resampler_process.argtypes = [c.c_void_p, fp, c.c_int64, fp, c.c_int64]
        lib.nta_resampler_free.argtypes = [c.c_void_p]

        lib.nta_mixdown.argtypes = [c.c_void_p, c.c_int64, c.c_int, c.c_int, fp]

        lib.nta_packer_new.restype = c.c_void_p
        lib.nta_packer_new.argtypes = [c.c_void_p]
        lib.nta_packer_append.argtypes = [c.c_void_p, fp, c.c_int64]
        lib.nta_packer_close.argtypes = [c.c_void_p]
        lib.nta_packer_free.argtypes = [c.c_void_p]

        lib.nta_alsa_available.restype = c.c_int
        lib.nta_alsa_devices.restype = c.c_int64
        lib.nta_alsa_devices.argtypes = [c.c_char_p, c.c_int64]
        lib.nta_alsa_query_configs.restype = c.c_int64
        lib.nta_alsa_query_configs.argtypes = [c.c_char_p, c.c_char_p, c.c_int64]
        lib.nta_alsa_start.restype = c.c_void_p
        lib.nta_alsa_start.argtypes = [
            c.c_char_p, c.c_uint, c.c_uint, c.c_uint, c.c_void_p,
        ]
        lib.nta_alsa_start_fmt.restype = c.c_void_p
        lib.nta_alsa_start_fmt.argtypes = [
            c.c_char_p, c.c_uint, c.c_uint, c.c_int, c.c_uint, c.c_void_p,
        ]
        lib.nta_alsa_stop.argtypes = [c.c_void_p]

        _lib = lib
        return _lib
