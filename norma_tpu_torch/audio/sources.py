"""Audio sources.

The reference's only source is a cpal microphone stream built inside the
Transcriber (``src/lib.rs:502-557``), which makes its own
integration tests require real hardware (tests/transcriber.rs is
``#[ignore]``-d).  This framework fixes that gap (SURVEY.md §4): capture is
an ``AudioSource`` interface with microphone, file, and synthetic
implementations, so the full pipeline runs hermetically in CI.

A source delivers interleaved frames in its native sample format on its own
thread; the ``StreamPipeline`` (pipeline.py) does mixdown / conversion /
resampling / packing exactly like the reference's cpal callback.
"""

from __future__ import annotations

import abc
import logging
import threading
import time
import wave
from typing import Callable, Optional

import numpy as np

OnData = Callable[[np.ndarray], None]


class AudioSource(abc.ABC):
    """A stream of interleaved PCM frames.

    ``on_end`` (optional) fires when the source ends on its own (file EOF,
    fixed duration) — real microphones never call it.
    """

    sample_rate: int
    channels: int
    dtype: np.dtype  # native sample format of the source

    @abc.abstractmethod
    def start(self, on_data: OnData, on_end=None) -> None: ...

    @abc.abstractmethod
    def stop(self) -> None: ...


class _ThreadedSource(AudioSource):
    """Base for sources that generate/read blocks on a worker thread."""

    def __init__(self, block_frames: int = 1600, realtime: bool = False) -> None:
        self.block_frames = block_frames
        self.realtime = realtime
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    @abc.abstractmethod
    def _next_block(self) -> Optional[np.ndarray]:
        """Produce the next interleaved block, or None at end of stream."""

    def start(self, on_data: OnData, on_end=None) -> None:
        self._stop.clear()

        def run() -> None:
            period = self.block_frames / self.sample_rate
            ended = False
            try:
                while not self._stop.is_set():
                    t0 = time.monotonic()
                    block = self._next_block()
                    if block is None:
                        ended = True
                        break
                    on_data(block)
                    if self.realtime:
                        delay = period - (time.monotonic() - t0)
                        if delay > 0:
                            self._stop.wait(delay)
            except Exception:
                # A raising source (truncated file, failing callback) must
                # still END the stream: without on_end the pipeline never
                # closes the ring and the consumer blocks forever.
                logging.getLogger("norma_tpu_torch.audio").exception(
                    "audio source failed; ending stream"
                )
                ended = True
            if ended and on_end is not None and not self._stop.is_set():
                on_end()

        self._thread = threading.Thread(target=run, daemon=True, name="audio-src")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None


class SyntheticSource(_ThreadedSource):
    """Deterministic tone+noise generator for tests and benchmarks."""

    def __init__(
        self,
        sample_rate: int = 48_000,
        channels: int = 2,
        dtype=np.float32,
        freq: float = 440.0,
        amplitude: float = 0.3,
        noise: float = 0.0,
        duration: Optional[float] = None,
        block_frames: int = 1600,
        realtime: bool = False,
        seed: int = 0,
    ) -> None:
        super().__init__(block_frames, realtime)
        self.sample_rate = sample_rate
        self.channels = channels
        self.dtype = np.dtype(dtype)
        self.freq = freq
        self.amplitude = amplitude
        self.noise = noise
        self.duration = duration
        self._pos = 0
        self._rng = np.random.default_rng(seed)

    def _next_block(self) -> Optional[np.ndarray]:
        if self.duration is not None:
            total = int(self.duration * self.sample_rate)
            if self._pos >= total:
                return None
            # Clamp the final block so the stream is EXACTLY `duration`
            # long (a full-block overshoot skews length-sensitive tests).
            n = min(self.block_frames, total - self._pos)
        else:
            n = self.block_frames
        t = (self._pos + np.arange(n)) / self.sample_rate
        mono = self.amplitude * np.sin(2 * np.pi * self.freq * t)
        if self.noise > 0:
            mono = mono + self.noise * self._rng.standard_normal(n)
        self._pos += n
        frames = np.repeat(mono[:, None], self.channels, axis=1).reshape(-1)
        if np.issubdtype(self.dtype, np.integer):
            info = np.iinfo(self.dtype)
            scale = float(1 << (info.bits - 1))
            offset = 0.0 if info.min < 0 else scale
            frames = np.clip(frames * scale + offset, info.min, info.max)
        return frames.astype(self.dtype)


class FileSource(_ThreadedSource):
    """WAV-file source (PCM 8/16/24/32-bit int) via the stdlib wave module."""

    def __init__(
        self, path: str, block_frames: int = 1600, realtime: bool = False
    ) -> None:
        super().__init__(block_frames, realtime)
        self._wav = wave.open(path, "rb")
        self.sample_rate = self._wav.getframerate()
        self.channels = self._wav.getnchannels()
        width = self._wav.getsampwidth()
        dtypes = {
            1: np.dtype(np.uint8),
            2: np.dtype(np.int16),
            3: np.dtype(np.int32),  # 24-bit PCM widened in _next_block
            4: np.dtype(np.int32),
        }
        if width not in dtypes:
            raise ValueError(
                f"{path}: unsupported WAV sample width {width} bytes "
                "(supported: 1/2/3/4-byte integer PCM)"
            )
        self._width = width
        self.dtype = dtypes[width]

    def _next_block(self) -> Optional[np.ndarray]:
        raw = self._wav.readframes(self.block_frames)
        if not raw:
            return None
        if self._width == 3:
            # 24-bit little-endian PCM: place the 3 bytes in an int32's
            # top bytes (value << 8), so the full int32 range is used and
            # the sign comes from the sample's own top byte.
            u = np.frombuffer(raw, np.uint8).astype(np.uint32).reshape(-1, 3)
            x = (u[:, 0] << 8) | (u[:, 1] << 16) | (u[:, 2] << 24)
            return x.view(np.int32)
        return np.frombuffer(raw, dtype=self.dtype)

    def stop(self) -> None:
        super().stop()
        try:
            self._wav.close()
        except Exception:
            pass
