"""The Transcriber actor and its handle (``norma_tpu/runtime/transcriber.py``).

The reference's runtime core (``src/lib.rs:301-695``) with the same API
shape and semantics:

  - 4 construction variants: blocking_new / new (async) / blocking_spawn /
    spawn (lib.rs:316-391)
  - ``run()`` control loop: wait for a start request, build the audio
    stream, pull chunks from the lossy recycled ring, call
    ``Model.transcribe``, push non-empty strings (lib.rs:394-495)
  - end-of-stream protocol: a chunk shorter than max_chunk_len is final
    (lib.rs:463)
  - teardown mirrors the reference: transcribe error => drop stream and
    surface the error through join(); closed string receiver => drop stream
    and keep serving new starts; stream-build error => reply with the error
    and terminate the run loop (lib.rs:432)

The reference's poisoned-mutex self-healing (lib.rs:436-442 etc.) has no
Python analogue — locks cannot poison here.

``Settings.source=None`` (the default) captures the microphone through the
native ALSA runtime (``audio/native``: the device ranked and opened as the
reference's ``create_stream`` does, lib.rs:502-557).  Extension over the
reference: ``Settings.source`` may inject any ``AudioSource``
(file/synthetic) instead.
"""

from __future__ import annotations

import logging
import queue
import threading
import time
from typing import TYPE_CHECKING, Optional, Tuple

if TYPE_CHECKING:  # avoid the audio<->runtime package import cycle
    from ..audio.pipeline import StreamPipeline

from ..errors import (
    DeviceError,
    NoStreamRunning,
    StartError,
    TranscriberDown,
    TranscriberRunning,
)
from ..input import Settings
from ..tracing import instrument
from ..models import CommonModelParams, Model, ModelDefinition
from .channels import (
    ReceiverClosed,
    RecycledRing,
    StringChannel,
    StringReceiver,
)

logger = logging.getLogger(__name__)


class JoinHandle:
    """Thread join handle surfacing the run loop's terminal error."""

    def __init__(self) -> None:
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def join(self, timeout: Optional[float] = None) -> None:
        if self._thread is not None:
            self._thread.join(timeout)
            if self._thread.is_alive():
                raise TimeoutError("transcriber thread still running")
        if self._error is not None:
            raise self._error


class _StreamState:
    """Shared keepalive slot (reference: MicStreamState, lib.rs:292).

    ``down`` is the Python stand-in for the reference's closed control
    channel: tokio's mpsc errors a send the moment ``run()`` drops its
    receiver (lib.rs:636,668), but ``queue.Queue`` cannot close — so
    ``run()`` raises this event on every exit path and the handle checks
    it to fail starts against a dead transcriber immediately instead of
    hanging (or silently burning its whole timeout).
    """

    def __init__(self) -> None:
        self.lock = threading.Lock()
        self.pipeline: Optional[StreamPipeline] = None
        self.down = threading.Event()

    def take(self) -> Optional["StreamPipeline"]:
        """Atomically pop the keepalive pipeline (one source of truth for
        the swap-and-clear protocol shared by stop()/teardown)."""
        with self.lock:
            pipeline, self.pipeline = self.pipeline, None
        return pipeline


class _StartReply:
    """Atomic reply slot for a start request (oneshot + abandonment).

    The reference's ``blocking_start`` blocks forever on its oneshot
    (lib.rs:670); ours takes a timeout, which opens a race the reference
    can't hit: the caller gives up while ``run()`` is still opening the
    stream, and the stream would then run with a receiver nobody owns —
    its first full transcript buffer would block the run loop forever.
    Exactly one side wins here: either the caller gets the receiver, or
    ``reply()`` returns False and run() tears the orphan stream down.
    """

    def __init__(self) -> None:
        self._q: "queue.Queue" = queue.Queue(maxsize=1)
        self._lock = threading.Lock()
        self._abandoned = False

    def reply(self, value) -> bool:
        """Deliver the reply; False if the caller already gave up."""
        with self._lock:
            if self._abandoned:
                return False
            self._q.put(value)
            return True

    def abandoned(self) -> bool:
        with self._lock:
            return self._abandoned

    def wait(self, timeout: Optional[float], down=None):
        """Wait for the reply; marks the request abandoned on timeout.

        ``down``: the transcriber-exited event.  The wait polls it so a
        start against a transcriber that died mid-request fails promptly
        (and a ``timeout=None`` wait cannot hang forever on a thread that
        will never reply) — the reference gets this for free from its
        dropped oneshot sender (lib.rs:670-672)."""
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            step = 0.1 if down is not None else timeout
            if deadline is not None:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                step = remaining if step is None else min(step, remaining)
            try:
                return self._q.get(timeout=step)
            except queue.Empty:
                if down is not None and down.is_set():
                    break  # final re-check under the lock below
                if deadline is None and down is None:
                    continue
        with self._lock:
            # A reply may have landed between the timeout and the lock.
            try:
                return self._q.get_nowait()
            except queue.Empty:
                self._abandoned = True
        raise TranscriberDown()


class Transcriber:
    def __init__(
        self,
        model: Model,
        common_params: CommonModelParams,
        stream_state: _StreamState,
        ctrl: "queue.Queue",
    ) -> None:
        self._model = model
        self._params = common_params
        self._stream_state = stream_state
        self._ctrl = ctrl

    # ------------------------------------------------------------------
    # Construction (reference: lib.rs:316-391)
    # ------------------------------------------------------------------

    @classmethod
    @instrument  # reference #[instrument], lib.rs:315-391
    def blocking_new(
        cls, definition: ModelDefinition
    ) -> Tuple["Transcriber", "TranscriberHandle"]:
        state = _StreamState()
        params = definition.common_params()
        ctrl: "queue.Queue" = queue.Queue(maxsize=1)
        model = definition.blocking_try_to_model()
        return cls(model, params, state, ctrl), TranscriberHandle(state, ctrl)

    @classmethod
    @instrument  # reference #[instrument], lib.rs:315-391
    async def new(
        cls, definition: ModelDefinition
    ) -> Tuple["Transcriber", "TranscriberHandle"]:
        state = _StreamState()
        params = definition.common_params()
        ctrl: "queue.Queue" = queue.Queue(maxsize=1)
        model = await definition.try_to_model()
        return cls(model, params, state, ctrl), TranscriberHandle(state, ctrl)

    @classmethod
    @instrument  # reference #[instrument], lib.rs:315-391
    def blocking_spawn(
        cls, definition: ModelDefinition
    ) -> Tuple[JoinHandle, "TranscriberHandle"]:
        transcriber, handle = cls.blocking_new(definition)
        return cls._spawn_thread(transcriber), handle

    @classmethod
    @instrument  # reference #[instrument], lib.rs:315-391
    async def spawn(
        cls, definition: ModelDefinition
    ) -> Tuple[JoinHandle, "TranscriberHandle"]:
        transcriber, handle = await cls.new(definition)
        return cls._spawn_thread(transcriber), handle

    @staticmethod
    def _spawn_thread(transcriber: "Transcriber") -> JoinHandle:
        jh = JoinHandle()

        def run() -> None:
            try:
                transcriber.run()
            except BaseException as e:  # surfaced via join()
                jh._error = e

        t = threading.Thread(target=run, name="transcriber", daemon=True)
        jh._thread = t
        t.start()
        return jh

    # ------------------------------------------------------------------
    # Control loop (reference: run(), lib.rs:394-495)
    # ------------------------------------------------------------------

    @instrument(name="create_stream")  # reference lib.rs:502
    def _open_stream(self, settings: Settings):
        """Build the capture pipeline; returns (pipeline, ring).

        Injected sources run the Python DSP pipeline; the microphone
        (``settings.source is None``) is fully native: C++ ALSA
        capture/mixdown/resample/pack into a lock-free ring
        (``audio/native``).
        """
        if settings.source is None:
            from ..audio.native.alsa import open_native_mic

            return open_native_mic(
                settings,
                self._model.SAMPLE_RATE,
                self._model.dtype,
                self._params.data_buffer_size,
                self._params.get_max_chunk_len(),
            )

        from ..audio.pipeline import StreamPipeline

        ring = RecycledRing(
            self._params.data_buffer_size,
            self._params.get_max_chunk_len(),
            self._model.dtype,
        )
        pipeline = StreamPipeline(
            settings.source, self._model.SAMPLE_RATE, self._model.dtype, ring
        )
        pipeline.start()
        return pipeline, ring

    @instrument  # reference #[instrument], lib.rs:393
    def run(self) -> None:
        try:
            self._run()
        finally:
            # The Python stand-in for the reference's control channel
            # closing on run-loop exit (lib.rs:494): mark the transcriber
            # down, then fail every queued start so its waiter returns
            # immediately instead of timing out (or hanging at
            # timeout=None).  Order matters: down is visible BEFORE the
            # drain, so a request enqueued after the drain sees the event
            # from its polling wait.
            self._stream_state.down.set()
            while True:
                try:
                    stale = self._ctrl.get_nowait()
                except queue.Empty:
                    break
                if stale is not None:
                    stale[1].reply(TranscriberDown())

    def _run(self) -> None:
        while True:
            msg = self._ctrl.get()
            if msg is None:  # handle dropped -> terminate (lib.rs:494)
                return
            settings, res_q = msg
            if res_q.abandoned():  # caller timed out while queued
                continue

            schan = StringChannel(self._params.string_buffer_size)

            try:
                pipeline, ring = self._open_stream(settings)
            except StartError as e:
                res_q.reply(e)
                # The reference terminates the run loop on stream-build
                # failure (lib.rs:432 break).
                return
            except Exception as e:
                err = DeviceError()
                err.__cause__ = e  # preserve the underlying failure
                res_q.reply(err)
                return

            with self._stream_state.lock:
                self._stream_state.pipeline = pipeline
            if not res_q.reply(schan.receiver()):
                # Caller gave up mid-open: nobody owns the receiver, so the
                # stream must not run (its first full transcript buffer
                # would block this loop forever).
                self._teardown_stream()
                continue

            # Reject starts that raced in while we were setting up
            # (lib.rs:454-460).
            shutdown = False
            while True:
                try:
                    stale = self._ctrl.get_nowait()
                except queue.Empty:
                    break
                if stale is None:
                    shutdown = True
                else:
                    stale[1].reply(TranscriberRunning())

            while True:
                chunk = ring.recv()
                if chunk is None:
                    break
                final = chunk.is_final
                try:
                    text = self._model.transcribe(chunk.data, final)
                except Exception as err:
                    logger.error("transcriber hit an unrecoverable error: %s", err)
                    self._teardown_stream()
                    schan.close_sender()
                    raise
                finally:
                    ring.release(chunk)
                if text:
                    try:
                        schan.send(text)
                    except ReceiverClosed:
                        self._teardown_stream()
                        break
            schan.close_sender()
            # Stream ended (stop() or source EOF): clear the keepalive so a
            # new start is accepted.
            self._teardown_stream()
            if shutdown:
                return
            # loop back: wait for the next start request

    def _teardown_stream(self) -> None:
        pipeline = self._stream_state.take()
        if pipeline is not None:
            pipeline.stop()


class TranscriberHandle:
    """Cloneable remote control (reference: TranscriberHandle, lib.rs:603-695)."""

    def __init__(self, stream_state: _StreamState, ctrl: "queue.Queue") -> None:
        self._stream_state = stream_state
        self._ctrl = ctrl
        self._closed = False

    # -- start ----------------------------------------------------------

    @instrument(
        fields={"timeout": lambda a: a.get("timeout")}
    )  # reference lib.rs:644
    def blocking_start(
        self, settings: Optional[Settings] = None, timeout: Optional[float] = 30.0
    ) -> StringReceiver:
        settings = settings if settings is not None else Settings()
        with self._stream_state.lock:
            running = self._stream_state.pipeline is not None
        if running:
            raise TranscriberRunning()

        down = self._stream_state.down
        if down.is_set():
            raise TranscriberDown()
        deadline = None if timeout is None else time.monotonic() + timeout
        res_q = _StartReply()
        try:
            self._ctrl.put((settings, res_q), timeout=timeout)
        except queue.Full:
            # put can only time out while the run loop is alive and busy
            # (a dead loop's exit drain frees the slot) — unless it died
            # while we waited.  Report which.
            raise TranscriberDown() if down.is_set() else TranscriberRunning()
        # ONE deadline across enqueue + reply: put and wait each consuming
        # the full timeout would let blocking_start(30) block ~60 s.
        remaining = (
            None if deadline is None else max(deadline - time.monotonic(), 0.0)
        )
        res = res_q.wait(remaining, down=down)  # TranscriberDown on timeout
        if isinstance(res, Exception):
            raise res
        return res

    @instrument  # reference lib.rs:612
    async def start(self, settings: Optional[Settings] = None) -> StringReceiver:
        import asyncio

        return await asyncio.to_thread(self.blocking_start, settings)

    # -- stop -----------------------------------------------------------

    @instrument  # reference lib.rs:678
    def stop(self) -> None:
        """Stop the running stream (reference: stop(), lib.rs:678-694)."""
        pipeline = self._stream_state.take()
        if pipeline is None:
            raise NoStreamRunning()
        pipeline.stop()

    # -- drop semantics --------------------------------------------------

    def close(self) -> None:
        """Equivalent of dropping the handle: terminates the transcriber.

        The shutdown sentinel must actually land: if the 1-slot ctrl queue
        holds a pending start (raced in during a previous stream's
        teardown), silently dropping the sentinel would leave the run loop
        alive forever.  Displace pending starts with TranscriberDown until
        the sentinel fits.
        """
        if self._closed:
            return
        self._closed = True
        while True:
            try:
                self._ctrl.put_nowait(None)
                return
            except queue.Full:
                pass
            try:
                stale = self._ctrl.get_nowait()
            except queue.Empty:
                continue  # run() consumed the blocker; retry the sentinel
            if stale is None:
                # Another closer's sentinel: we just CONSUMED it, so
                # returning here would leave no sentinel in the queue and
                # the run loop alive forever — loop back and re-enqueue
                # one (the slot we freed is available).
                continue
            stale[1].reply(TranscriberDown())

    def __enter__(self) -> "TranscriberHandle":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
