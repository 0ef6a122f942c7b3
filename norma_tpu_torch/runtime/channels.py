"""Data-plane channels.

Re-creation of the reference's channel architecture
(``src/lib.rs:157,396-404``):

  - ``RecycledRing``  — thingbuf-style bounded channel of preallocated,
    recycled fixed-capacity audio buffers with NON-BLOCKING lossy send
    (``try_send_ref``; a full ring drops the chunk with a warning,
    lib.rs:243-253).  A chunk shorter than its capacity is the
    end-of-stream signal (lib.rs:463).
  - ``StringChannel``  — bounded blocking channel for transcripts (tokio
    mpsc semantics: send blocks when full, fails when the receiver is
    closed).
  - control/oneshot channels are plain ``queue.Queue`` instances.

Both are built on ``threading.Condition`` so waits are REAL blocking waits
woken by send/close notifications — the reference's tokio/thingbuf channels
never poll, and neither do these (no internal wake-up ticks).

(A copy of ``norma_tpu/runtime/channels.py``.)  A C++ lock-free SPSC ring
(``audio/native``) backs the real-time microphone path; this Python
implementation serves every other source and is the portable fallback.
"""

from __future__ import annotations

import logging
import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Deque, Optional

import numpy as np

logger = logging.getLogger(__name__)


@dataclass
class Chunk:
    """A filled ring slot: ``data[:length]`` is valid PCM."""

    buf: np.ndarray
    length: int
    # End-of-stream override: None keeps the reference's capacity-based
    # protocol (a non-full chunk is the last one, lib.rs:256-262 + :463);
    # an explicit False lets the Packer emit a deliberately SHORT non-final
    # chunk (the first-partial-latency early flush) without it reading as
    # EOS.
    final_flag: Optional[bool] = None
    # When its producer completed it (its last sample in), on
    # ``time.perf_counter_ns()``: the due time of its audio at the source.
    stamp: Optional[int] = None

    @property
    def data(self) -> np.ndarray:
        return self.buf[: self.length]

    @property
    def is_final(self) -> bool:
        if self.final_flag is not None:
            return self.final_flag
        return self.length < self.buf.shape[0]


class RecycledRing:
    """Bounded MPSC channel with slot recycling and drop-on-full send."""

    def __init__(
        self,
        capacity: int,
        chunk_len: int,
        dtype=np.float32,
        wakeup: Optional[threading.Event] = None,
    ) -> None:
        # The reference's thingbuf needs >= 2 slots of slack; callers pass
        # the already-adjusted CommonModelParams.data_buffer_size.
        # ``wakeup``: an external event additionally signaled on send/close —
        # lets a scheduler multiplexing many rings block on ONE event
        # instead of polling each ring.
        self._cond = threading.Condition()
        self._wakeup = wakeup
        self._free: Deque[np.ndarray] = deque(
            np.zeros(chunk_len, dtype) for _ in range(max(capacity, 2))
        )
        self._full: Deque[Chunk] = deque()
        self._chunk_len = chunk_len
        self._closed = False
        self.dropped = 0

    @property
    def chunk_len(self) -> int:
        return self._chunk_len

    def try_send(
        self, data: np.ndarray, length: int, final: Optional[bool] = None, stamp: Optional[int] = None
    ) -> bool:
        """Non-blocking lossy send (reference: try_send_ref, lib.rs:244).

        Copies ``data[:length]`` into a recycled slot.  Returns False (chunk
        dropped) when no slot is free or the channel is closed.  ``final``
        overrides the capacity-based EOS rule (see :class:`Chunk`);
        ``stamp`` is the chunk's completion time (``perf_counter_ns``; the
        send's time when None).
        """
        if stamp is None:
            stamp = time.perf_counter_ns()
        with self._cond:
            if self._closed:
                return False
            if not self._free:
                self.dropped += 1
                logger.warning(
                    "audio ring full; dropping chunk of %d samples", length
                )
                return False
            slot = self._free.popleft()
        # Copy outside the lock: this runs on the audio-callback thread and
        # the slot is exclusively ours until it re-enters a deque.
        slot[:length] = data[:length]
        with self._cond:
            if self._closed:
                # close() interleaved between slot claim and commit: a
                # blocked receiver already saw empty+closed and returned
                # None, so appending now would report success for a chunk
                # nobody will ever read.  Recycle the slot and fail the
                # send — WITHOUT counting ``dropped``: that counter means
                # lossy backpressure (ring full), and a send racing
                # teardown is not a loss event (the first-check closed
                # path doesn't count one either; the churn soaks assert
                # dropped == 0 across nominal stop()s).
                self._free.append(slot)
                return False
            self._full.append(Chunk(slot, length, final, stamp))
            self._cond.notify()
        if self._wakeup is not None:
            self._wakeup.set()
        return True

    def recv(self, timeout: Optional[float] = None) -> Optional[Chunk]:
        """Blocking receive; None once closed and drained (or on timeout)."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cond:
            while True:
                if self._full:
                    return self._full.popleft()
                if self._closed:
                    return None
                if deadline is None:
                    self._cond.wait()
                else:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0 or not self._cond.wait(remaining):
                        return None

    def poll(self):
        """Non-blocking receive: (status, chunk) with status in
        {'chunk', 'empty', 'closed'}."""
        with self._cond:
            if self._full:
                return "chunk", self._full.popleft()
            if self._closed:
                return "closed", None
            return "empty", None

    def release(self, chunk: Chunk) -> None:
        """Recycle a consumed slot."""
        with self._cond:
            self._free.append(chunk.buf)

    def close(self) -> None:
        with self._cond:
            self._closed = True
            self._cond.notify_all()
        if self._wakeup is not None:
            self._wakeup.set()


class ReceiverClosed(Exception):
    pass


class StringReceiver:
    """Receiving half of a transcript channel.

    ``blocking_recv`` mirrors tokio's: returns None when the channel is
    closed AND drained.  Closing the receiver makes subsequent sends fail,
    which tears the stream down (reference: lib.rs:479-489).
    """

    def __init__(self, chan: "StringChannel") -> None:
        self._chan = chan

    def blocking_recv(self, timeout: Optional[float] = None) -> Optional[str]:
        """Next segment, or None when the stream has ended — or, with a
        ``timeout``, when it elapses on a live-but-silent stream.  The two
        Nones are distinguished by :attr:`is_closed`."""
        return self._chan._recv(timeout)

    @property
    def is_closed(self) -> bool:
        """True once no segment can ever be returned again (either half
        closed AND the buffered queue drained) — lets a
        ``blocking_recv(timeout=...)`` caller tell end-of-stream None from
        a timeout None."""
        return self._chan._ended()

    async def recv(self) -> Optional[str]:
        import asyncio

        return await asyncio.to_thread(self._chan._recv, None)

    def close(self) -> None:
        self._chan.close_receiver()

    def __iter__(self):
        while True:
            s = self.blocking_recv()
            if s is None:
                return
            yield s


class StringChannel:
    def __init__(self, maxsize: int) -> None:
        self._cond = threading.Condition()
        self._q: Deque[str] = deque()
        self._maxsize = max(maxsize, 1)
        self._sender_closed = False
        self._receiver_closed = False
        # Transcripts dropped by try_send on a full channel.  Surfaced so
        # the lossy-batched-path tradeoff vs the reference's always-blocking
        # StringChannel is MEASURED, not assumed (zero under nominal load —
        # pinned by the churn soak tests).
        self.dropped = 0

    def send(self, s: str) -> None:
        """Blocking send; raises ReceiverClosed if the receiver is gone."""
        with self._cond:
            while True:
                if self._receiver_closed:
                    raise ReceiverClosed()
                if len(self._q) < self._maxsize:
                    self._q.append(s)
                    self._cond.notify_all()
                    return
                self._cond.wait()

    def try_send(self, s: str, timeout: float = 0.2) -> bool:
        """Bounded-wait send for the batched scheduler: dropping beats
        stalling the shared decode loop.  Raises ReceiverClosed."""
        deadline = time.monotonic() + timeout
        with self._cond:
            while True:
                if self._receiver_closed:
                    raise ReceiverClosed()
                if len(self._q) < self._maxsize:
                    self._q.append(s)
                    self._cond.notify_all()
                    return True
                remaining = deadline - time.monotonic()
                if remaining <= 0 or not self._cond.wait(remaining):
                    self.dropped += 1
                    logger.warning("transcript channel full; dropping segment")
                    return False

    def close_sender(self) -> None:
        with self._cond:
            self._sender_closed = True
            self._cond.notify_all()

    def close_receiver(self) -> None:
        with self._cond:
            self._receiver_closed = True
            self._cond.notify_all()

    def _recv(self, timeout: Optional[float]) -> Optional[str]:
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cond:
            while True:
                if self._q:
                    s = self._q.popleft()
                    self._cond.notify_all()  # wake senders blocked on full
                    return s
                if self._sender_closed:
                    return None
                if self._receiver_closed:
                    # The consumer closed its own half (tokio: drain buffered
                    # messages, then None).  Without this check an iterating
                    # thread on a silent stream would block forever — silence
                    # produces no send() to trip ReceiverClosed.
                    return None
                if deadline is None:
                    self._cond.wait()
                else:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0 or not self._cond.wait(remaining):
                        return None

    def _ended(self) -> bool:
        # Buffered segments are still deliverable after EITHER half closes
        # (_recv drains the queue before checking the closed flags), so the
        # stream has only ended once a close flag is set AND the queue is
        # empty — otherwise a `while not rx.is_closed` poller would exit
        # early and silently lose the buffered tail.
        with self._cond:
            return (
                self._receiver_closed or self._sender_closed
            ) and not self._q

    def receiver(self) -> StringReceiver:
        return StringReceiver(self)
