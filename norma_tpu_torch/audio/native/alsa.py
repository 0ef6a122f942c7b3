"""Native microphone pipeline: ALSA capture -> C++ DSP -> native ring (a
copy of ``norma_tpu/audio/native/alsa.py``).

Full-native real-time path: the capture thread, mixdown, sinc resampling and
chunk packing all run in C++ (reference: cpal's C-API callback +
dasp/thingbuf, lib.rs:159-262); Python only consumes finished chunks.  On
hosts without libasound the loader reports no devices and the caller raises
DeviceError, exactly like the reference's StartError::DeviceError.

Stream-config negotiation follows the reference (lib.rs:527-541): the C++
layer enumerates the device's supported (sample format x channel count)
ranges via snd_pcm_hw_params, ``rank_configs`` orders them by
``cmp_mic_config`` (model-rate support > format match > f64 > float > mono,
lib.rs:559-600), and the best config is opened — at the model rate when the
range covers it, else the range's max rate with native sinc resampling
(lib.rs:538-541).  All 8 ALSA-reachable sample formats are captured natively
(the reference's 10 cpal formats minus i64/u64, which ALSA has no PCM
encoding for); mixdown handles every format in C++.
"""

from __future__ import annotations

import ctypes
import logging
from typing import List, Tuple

import numpy as np

from ...errors import BuildStreamError, DeviceError
from ...tracing import instrument
from ...input import Settings
from ..device import SupportedConfig, rank_configs, select_device
from . import load
from .wrappers import FMT_CODES, NativeRing

logger = logging.getLogger(__name__)

_FMT_NAMES = {v: k for k, v in FMT_CODES.items()}


def list_devices(lib=None) -> List[str]:
    lib = lib if lib is not None else load()
    if lib is None or not lib.nta_alsa_available():
        return []
    cbuf = ctypes.create_string_buffer(65536)
    n = lib.nta_alsa_devices(cbuf, len(cbuf))
    if n <= 0:
        return []
    return [d for d in cbuf.value.decode("utf-8", "replace").split("\n") if d]


def query_configs(lib, device: str) -> List[SupportedConfig]:
    """Enumerate the device's supported stream-config ranges (the cpal
    ``supported_input_configs`` equivalent).  Empty when the device cannot
    be queried (negotiation then falls back to blind probing)."""
    cbuf = ctypes.create_string_buffer(65536)
    n = lib.nta_alsa_query_configs(device.encode(), cbuf, len(cbuf))
    if n <= 0:
        return []
    out = []
    for line in cbuf.value.decode("utf-8", "replace").splitlines():
        try:
            fmt, rmin, rmax, ch = (int(x) for x in line.split(","))
            out.append(
                SupportedConfig(
                    min_sample_rate=rmin,
                    max_sample_rate=rmax,
                    sample_format=_FMT_NAMES[fmt],
                    channels=ch,
                )
            )
        except (ValueError, KeyError):
            logger.warning("unparseable native config line: %r", line)
    return out


class NativeMicPipeline:
    """StreamPipeline-compatible owner of a native ALSA capture."""

    def __init__(self, lib, handle, ring: NativeRing) -> None:
        self._lib = lib
        self._handle = handle
        self.ring = ring
        self._stopped = False

    def stop(self) -> None:
        if self._stopped:
            return
        self._stopped = True
        # Joins the capture thread; the native side flushes the final short
        # chunk and closes the ring (end-of-stream protocol).
        self._lib.nta_alsa_stop(self._handle)

    def __del__(self):
        # A dropped-without-stop pipeline must join the C++ capture worker
        # BEFORE the ring it writes to can be freed.  This object holds the
        # only strong reference chain to the NativeRing from the capture
        # side, so refcount collection runs this finalizer first; without
        # it, NativeRing.__del__ would delete the SpscRing under a live
        # writer thread (use-after-free).
        try:
            self.stop()
        except Exception:
            pass


@instrument(
    fields={"model_rate": lambda a: a["model_rate"], "chunk_len": lambda a: a["chunk_len"]}
)  # reference create_stream, lib.rs:502
def open_native_mic(
    settings: Settings,
    model_rate: int,
    model_dtype,
    n_slots: int,
    chunk_len: int,
    lib=None,
) -> Tuple[NativeMicPipeline, NativeRing]:
    """Open the best-ranked mic config (reference: create_stream,
    lib.rs:502-557).  ``lib`` is injectable for hermetic tests."""
    lib = lib if lib is not None else load()
    if lib is None or not lib.nta_alsa_available():
        raise DeviceError()

    devices = list_devices(lib)
    # ALSA always exposes the "default" PCM even when enumeration is empty.
    name = select_device(devices, settings, "default")

    ring = NativeRing(n_slots, chunk_len, out_dtype=model_dtype)

    configs = query_configs(lib, name)
    if configs:
        ranked = rank_configs(configs, model_rate, model_dtype)
        # Best config last (the reference pops from the sorted tail,
        # lib.rs:530-533).  The reference builds only the best and errors on
        # failure; trying the rest in rank order is a robustness extension.
        for pos, cfg in enumerate(reversed(ranked), start=1):
            rate = cfg.pick_rate(model_rate)
            handle = lib.nta_alsa_start_fmt(
                name.encode(),
                rate,
                cfg.channels,
                FMT_CODES[cfg.sample_format],
                model_rate,
                ring.ptr,
            )
            if handle:
                logger.info(
                    "native mic open: %s @ %d Hz x%d ch %s (ranked %d/%d)",
                    name, rate, cfg.channels, cfg.sample_format,
                    pos, len(ranked),
                )
                return NativeMicPipeline(lib, handle, ring), ring
        raise BuildStreamError(
            f"all {len(ranked)} negotiated configs failed for {name!r}"
        )

    # Device not queryable: blind-probe common rates/channels at S16
    # (pre-negotiation fallback path).
    for rate in (model_rate, 48_000, 44_100):
        for channels in (1, 2):
            handle = lib.nta_alsa_start(
                name.encode(), rate, channels, model_rate, ring.ptr
            )
            if handle:
                logger.info(
                    "native mic open (blind): %s @ %d Hz x%d ch",
                    name, rate, channels,
                )
                return NativeMicPipeline(lib, handle, ring), ring
    raise BuildStreamError(f"failed to open ALSA device {name!r}")
