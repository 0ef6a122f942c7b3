"""Capture-side DSP pipeline: mixdown, sample conversion, resample, pack.

Re-creation of the reference's cpal-callback hot loop and Packer
(``src/lib.rs:159-262``):

  fast path (device rate == model rate):  mono mixdown -> convert -> pack
  resample path:                          mono mixdown -> sinc resample ->
                                          convert -> pack

The Packer fills a buffer to exactly ``max_chunk_len`` samples and pushes it
into the recycled ring with NON-BLOCKING lossy semantics (drop + warn on a
full ring, lib.rs:248-252).  Closing the packer pops one sample and flushes,
guaranteeing the last chunk has ``len < capacity`` — the end-of-stream
signal (lib.rs:256-262 + :463).

Deviation: mixdown averages in float, not in the source integer type (the
reference sums in the device format, lib.rs:178, which can wrap for loud
multi-channel int inputs).
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Optional

import numpy as np

from ..runtime.channels import RecycledRing
from .resample import StreamingResampler
from .sources import AudioSource

logger = logging.getLogger(__name__)


def to_float(data: np.ndarray) -> np.ndarray:
    """Convert any native sample format to f64 in [-1, 1) (dasp to_sample)."""
    if np.issubdtype(data.dtype, np.floating):
        return data.astype(np.float64)
    info = np.iinfo(data.dtype)
    scale = float(1 << (info.bits - 1))
    x = data.astype(np.float64)
    if info.min == 0:  # unsigned: midpoint is silence
        x = x - scale
    return x / scale


class Packer:
    """Zero-alloc chunk accumulator (reference: Packer, lib.rs:224-262).

    ``first_flush_len``: optionally flush the FIRST chunk early, at this
    many samples instead of a full ``chunk_len`` — the first-partial
    latency lever (VERDICT r4 #7): a stream's first decodable audio
    reaches the scheduler after ``first_flush_len/SR`` seconds instead of
    a full chunk period, at the cost of ONE extra (small-window) decode
    round per stream lifetime.  The early chunk is sent with an explicit
    ``final=False`` so its short length doesn't read as the reference's
    capacity-based EOS signal.  Steady-state cadence is unchanged.

    Each chunk carries the time its last sample came in
    (``perf_counter_ns``, :attr:`Chunk.stamp`): a full buffer is sent when
    the next sample arrives, or at close, and keeps the time it filled.
    """

    def __init__(
        self,
        ring: RecycledRing,
        dtype=np.float32,
        first_flush_len: Optional[int] = None,
    ) -> None:
        self.ring = ring
        self.buf = np.zeros(ring.chunk_len, dtype)
        self.fill = 0
        self.first_flush_len = (
            min(int(first_flush_len), ring.chunk_len)
            if first_flush_len
            else None
        )
        self._flushed_once = False
        self._full_ns = 0  # when the buffer last filled

    def append(self, data: np.ndarray) -> None:
        pos = 0
        n = len(data)
        while pos < n:
            space = len(self.buf) - self.fill
            if space == 0:
                self.flush()
                continue
            take = min(space, n - pos)
            self.buf[self.fill : self.fill + take] = data[pos : pos + take]
            self.fill += take
            pos += take
            if self.fill == len(self.buf):
                self._full_ns = time.perf_counter_ns()
            if (
                not self._flushed_once
                and self.first_flush_len is not None
                and self.fill >= self.first_flush_len
            ):
                self.flush(final=False)

    def flush(self, final: Optional[bool] = None) -> None:
        stamp = self._full_ns if self.fill == len(self.buf) else time.perf_counter_ns()
        self.ring.try_send(self.buf, self.fill, final=final, stamp=stamp)
        self._flushed_once = True
        self.fill = 0

    def close(self) -> None:
        """Final flush: drop one sample so length < capacity (EOS signal)."""
        logger.info("closing packer; flushing final chunk")
        if self.fill > 0:
            self.fill -= 1
        self.flush()


class StreamPipeline:
    """Owns a running source and feeds the ring until stopped.

    This plays the role of the reference's stream-owner thread + cpal stream
    (lib.rs:408-423): constructing it starts capture; ``stop()`` tears down
    the source, emits the final short chunk, and closes the ring.
    """

    def __init__(
        self,
        source: AudioSource,
        model_sample_rate: int,
        model_dtype,
        ring: RecycledRing,
        first_flush_len: Optional[int] = None,
    ) -> None:
        self.source = source
        self.ring = ring
        self.packer = Packer(ring, model_dtype, first_flush_len=first_flush_len)
        self.model_dtype = model_dtype
        if source.sample_rate != model_sample_rate:
            self.resampler: Optional[StreamingResampler] = StreamingResampler(
                source.sample_rate, model_sample_rate
            )
        else:
            self.resampler = None
        self._stopped = False
        self._lock = threading.Lock()  # source thread vs control thread
        self._carry: Optional[np.ndarray] = None  # mid-frame block split

    def start(self) -> None:
        self.source.start(self._on_data, on_end=self._on_source_end)

    def _finalize_once(self) -> bool:
        """Claim finalization exactly once (EOF callback on the source
        thread can race a concurrent ``stop()`` from the control thread —
        a double ``packer.close()`` would drop an extra sample and emit a
        second spurious EOS chunk)."""
        with self._lock:
            if self._stopped:
                return False
            self._stopped = True
            return True

    def _on_source_end(self) -> None:
        """Source ended on its own (file EOF / fixed duration): finalize."""
        if not self._finalize_once():
            return
        self._flush_resampler_tail()
        self.packer.close()
        self.ring.close()

    def _flush_resampler_tail(self) -> None:
        """At end of stream, push the resampler's pending history through.

        The sinc filter holds ~taps/2 input samples of latency; on a finite
        source (file / fixed duration) those are real received audio that
        would otherwise never be emitted.  Feeding half a filter of silence
        flushes them.  (A real mic never ends, so this matches the
        reference, whose dasp ring simply stops, lib.rs:189-216.)
        """
        if self.resampler is None:
            return
        pad = np.zeros(self.resampler.taps // 2, np.float64)
        tail = self.resampler.process(pad)
        if len(tail):
            self.packer.append(tail.astype(self.model_dtype))

    def _on_data(self, frames: np.ndarray) -> None:
        ch = self.source.channels
        if self._carry is not None and len(self._carry):
            frames = np.concatenate([self._carry, frames])
            self._carry = None
        usable = (len(frames) // ch) * ch
        if usable < len(frames):
            # A block split mid-frame: carry the partial frame into the
            # next block — truncating it would desynchronize the channel
            # interleave for the whole rest of the stream.
            self._carry = np.array(frames[usable:])
            frames = frames[:usable]
        mono = to_float(frames).reshape(-1, ch).mean(axis=1)
        if self.resampler is not None:
            mono = self.resampler.process(mono)
            if len(mono) == 0:
                return
        self.packer.append(mono.astype(self.model_dtype))

    def stop(self) -> None:
        # Always stop the source — even after a natural end (EOF) the
        # source still owns a worker thread / file handle to release
        # (``AudioSource.stop`` is idempotent).  Never called from the
        # source thread itself, so joining the worker here cannot deadlock.
        finalize = self._finalize_once()
        self.source.stop()
        if finalize:
            self.packer.close()
            self.ring.close()
