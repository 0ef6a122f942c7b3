"""Pythonic wrappers over the native audio runtime (ctypes; a copy of
``norma_tpu/audio/native/wrappers.py``)."""

from __future__ import annotations

import queue
from typing import Optional

import numpy as np

from ...runtime.channels import Chunk
from . import load


class NativeUnavailable(RuntimeError):
    pass


# C++ SampleFmt enum values (norma_audio.cpp) by sample-format string.
# Single source of truth for the Python side — alsa.py and native_mixdown
# both map through this table.
FMT_CODES = {
    "i8": 0, "i16": 1, "i32": 2, "f32": 3, "f64": 4,
    "u8": 5, "u16": 6, "u32": 7, "i64": 8, "u64": 9,
}


def _lib():
    lib = load()
    if lib is None:
        raise NativeUnavailable("native audio library not available")
    return lib


class NativeRing:
    """Lock-free native ring with the Python RecycledRing interface."""

    def __init__(self, n_slots: int, chunk_len: int, out_dtype=np.float32) -> None:
        self._lib = _lib()
        self._ptr = self._lib.nta_ring_new(n_slots, chunk_len)
        self._chunk_len = chunk_len
        self._out_dtype = np.dtype(out_dtype)
        self._free: "queue.Queue[np.ndarray]" = queue.Queue()
        for _ in range(max(n_slots, 2)):
            self._free.put(np.zeros(chunk_len, self._out_dtype))
        self._scratch = np.zeros(chunk_len, np.float32)

    @property
    def ptr(self):
        return self._ptr

    @property
    def chunk_len(self) -> int:
        return self._chunk_len

    @property
    def dropped(self) -> int:
        return int(self._lib.nta_ring_dropped(self._ptr))

    def try_send(self, data: np.ndarray, length: int) -> bool:
        arr = np.ascontiguousarray(data[:length], np.float32)
        return bool(
            self._lib.nta_ring_try_send(
                self._ptr, arr.ctypes.data_as(_FP), length
            )
        )

    def recv(self, timeout: Optional[float] = None) -> Optional[Chunk]:
        ms = -1 if timeout is None else int(timeout * 1000)
        while True:
            n = self._lib.nta_ring_recv(
                self._ptr, self._scratch.ctypes.data_as(_FP), 200 if ms < 0 else ms
            )
            if n == -2:
                return None
            if n == -1:
                if ms >= 0:
                    return None
                continue  # poll again (blocking semantics)
            try:
                buf = self._free.get_nowait()
            except queue.Empty:
                buf = np.zeros(self._chunk_len, self._out_dtype)
            buf[: int(n)] = self._scratch[: int(n)]
            return Chunk(buf, int(n))

    def poll(self):
        """Non-blocking receive: (status, chunk), status in
        {'chunk', 'empty', 'closed'}."""
        n = self._lib.nta_ring_recv(self._ptr, self._scratch.ctypes.data_as(_FP), 0)
        if n == -2:
            return "closed", None
        if n == -1:
            return "empty", None
        try:
            buf = self._free.get_nowait()
        except queue.Empty:
            buf = np.zeros(self._chunk_len, self._out_dtype)
        buf[: int(n)] = self._scratch[: int(n)]
        return "chunk", Chunk(buf, int(n))

    def release(self, chunk: Chunk) -> None:
        self._free.put(chunk.buf)

    def close(self) -> None:
        self._lib.nta_ring_close(self._ptr)

    def __del__(self):
        # NativeMicPipeline holds a strong reference to this ring and joins
        # its capture worker in its own finalizer, so by the time the ring
        # is collectable no C++ thread can still touch the SpscRing.
        try:
            if self._ptr:
                self._lib.nta_ring_free(self._ptr)
                self._ptr = None
        except Exception:
            pass


class NativeResampler:
    """Drop-in for audio.resample.StreamingResampler backed by C++."""

    def __init__(self, src_hz: float, dst_hz: float) -> None:
        self._lib = _lib()
        self._ptr = self._lib.nta_resampler_new(float(src_hz), float(dst_hz))
        self._ratio = dst_hz / src_hz

    def process(self, block: np.ndarray) -> np.ndarray:
        x = np.ascontiguousarray(block, np.float32)
        max_out = int(len(x) * self._ratio) + 256
        out = np.zeros(max_out, np.float32)
        n = self._lib.nta_resampler_process(
            self._ptr, x.ctypes.data_as(_FP), len(x), out.ctypes.data_as(_FP), max_out
        )
        if n < 0:  # capacity bound tripped (nothing consumed on the C side)
            raise RuntimeError(
                f"native resampler output exceeded buffer ({max_out} samples)"
            )
        return out[: int(n)].astype(np.float64)

    def __del__(self):
        try:
            self._lib.nta_resampler_free(self._ptr)
        except Exception:
            pass


def native_mixdown(raw: np.ndarray, channels: int, fmt: str) -> np.ndarray:
    """Interleaved native-format frames -> mono f32 via C++."""
    lib = _lib()
    frames = len(raw) // channels
    out = np.zeros(frames, np.float32)
    raw = np.ascontiguousarray(raw)
    import ctypes

    lib.nta_mixdown(
        raw.ctypes.data_as(ctypes.c_void_p),
        frames,
        channels,
        FMT_CODES[fmt],
        out.ctypes.data_as(_FP),
    )
    return out


import ctypes as _ct  # noqa: E402

_FP = _ct.POINTER(_ct.c_float)
