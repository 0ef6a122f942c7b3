"""Multi-stream continuous batching scheduler (``norma_tpu/runtime/batching.py``).

The reference serves strictly ONE stream per Transcriber (a second start is
rejected, lib.rs:640).  This is the capability the TPU build adds (SURVEY.md
§2c): N concurrent audio streams share one model on one chip; their ready
windows are padded into a fixed batch and every engine call — log-mel,
encoder, prefill, the on-device token loop — runs ONCE for the whole batch.
The batch dimension is padded to ``max_streams`` so exactly one program is
compiled per model (no recompilation as streams come and go).

Per-stream state (long-form buffers, drain accounting, language detection,
temperature fallback) stays isolated: the LongFormDecoder state machine is
driven window-by-window by the scheduler instead of its own loop.  Each
round is ONE fused device dispatch (engine.transcribe_window) covering
per-stream language detection, the no-speech gate and the full temperature
ladder in lockstep — a gated stream never serializes the round on the
scheduler thread.

Port notes: one card only (``mesh=`` raises; multi-GPU is ROADMAP queue 1
item 12); round windows go to the engine's device as tensors; the SLA round
cap counts streams, not bucket widths; there is no ``from_definition``
(the port has no checkpoint loader yet).  The engine's window splits into
dispatch and fetch, so rounds pipeline as in the JAX package, but the
eager token loop finishes the window's device work inside the dispatch.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Dict, List

import numpy as np
import torch

from ..constants import TEMPERATURES
from ..decode.longform import LanguageState, LongFormDecoder
from ..errors import NormaError, StartError
from ..frontend.mel import prepare_audio
from ..input import Settings
from ..models.whisper.model import WhisperModel
from ..tracing import instrument
from .channels import ReceiverClosed, RecycledRing, StringChannel, StringReceiver

logger = logging.getLogger(__name__)


class TooManyStreams(StartError):
    def __init__(self, limit: int) -> None:
        super().__init__(f"all {limit} stream slots are busy")


class BatchedStreamHandle:
    def __init__(self, owner: "BatchedTranscriber", sid: int, receiver: StringReceiver):
        self._owner = owner
        self._sid = sid
        self.receiver = receiver

    def stop(self) -> None:
        self._owner._stop_stream(self._sid)


class _Stream:
    def __init__(self, sid, pipeline, ring, state: LongFormDecoder, schan):
        self.sid = sid
        self.pipeline = pipeline
        self.ring = ring
        self.state = state
        self.schan = schan
        self.final = False  # final chunk seen
        self.want_decode = False
        self.source_closed = False
        self.dead = False
        self.seed = sid * 100_003
        # Latency bookkeeping (metrics()): admission time, when the
        # current ready period began (want_decode False->True), and
        # whether the first partial has been emitted.
        self.t_admit = time.monotonic()
        self.t_ready: float | None = None
        self.first_emit_done = False
        # True while this stream's window is inside a dispatched round
        # whose results have not been applied yet (round pipelining).
        self.in_flight = False


class BatchedTranscriber:
    """Serve up to ``max_streams`` concurrent streams with one model."""

    def __init__(
        self,
        model: WhisperModel,
        max_streams: int = 8,
        mesh=None,
        max_round_streams: int | None = None,
        target_p99_ms: float | None = None,
        first_partial_seconds: float | None = None,
    ) -> None:
        """``mesh``: not supported (one card); passing one raises.

        ``max_round_streams`` caps how many ready streams one fused round
        takes — a LATENCY knob: worst-case admission latency is one round's
        program duration, which shrinks with the round's batch size.  Rounds
        rotate through ready streams so a cap never starves anyone.
        None (default) = one round serves every ready stream (max
        throughput).

        ``target_p99_ms``: a ready->applied latency SLA that sizes rounds
        AUTOMATICALLY from the measured cost model: the
        scheduler tracks an EMA of each batch bucket's dispatch->applied
        wall cost and caps round width at the widest bucket whose
        predicted worst-case wait (~2 rounds: finish the in-flight round,
        then run your own) stays under the target.  Replaces hand-tuning
        ``max_round_streams``; both given = the tighter cap wins.
        Unmeasured buckets are allowed optimistically (the first rounds
        calibrate the EMA; ``warmup()`` pre-compiles every bucket).

        ``first_partial_seconds``: flush each stream's FIRST audio chunk
        early, after this many seconds of capture: the
        first decodable window reaches the scheduler ~this soon instead
        of after a full chunk period, cutting admission->first-partial
        latency by roughly the difference, at the cost of one extra
        small-window decode round per stream lifetime.  Off (None) by
        default: the early partial window decodes with less context, so
        its drained text can differ from the chunk-cadence decode of the
        same audio (the same latency/quality trade the reference's
        ``set_responsiveness`` makes, monolingual.rs:146-156) — serving
        deployments should set ~0.3-0.5 (docs/serving.md)."""
        if mesh is not None:
            raise NormaError(
                "BatchedTranscriber(mesh=...) is not supported by the PyTorch port "
                "(one card; multi-GPU is ROADMAP queue 1 item 12)"
            )
        if not isinstance(model, WhisperModel):
            raise NormaError("BatchedTranscriber requires a WhisperModel")
        self.model = model
        self.engine = model.engine
        self.tokenizer = model.tokenizer
        self.max_streams = max_streams
        if max_round_streams is not None and max_round_streams < 1:
            raise NormaError("max_round_streams must be >= 1")
        self.max_round_streams = max_round_streams
        if target_p99_ms is not None and target_p99_ms <= 0:
            raise NormaError("target_p99_ms must be > 0")
        self.target_p99_ms = target_p99_ms
        # Per-bucket EMA of a round's dispatch->applied wall seconds — the
        # cost model behind the SLA round sizing (and a metrics() column).
        self._round_cost_ema: Dict[int, float] = {}
        self.first_partial_samples = (
            int(first_partial_seconds * model.SAMPLE_RATE)
            if first_partial_seconds
            else None
        )
        self._round_rr = 0  # rotation cursor for capped rounds
        self._base_lang = model.longform.lang
        self._language_tokens = model.longform.language_tokens
        self._streams: Dict[int, _Stream] = {}
        self._lock = threading.Lock()
        # Signaled (under _lock) whenever a slot frees: retirement and
        # close().  blocking_start(timeout=...) waits on it for admission.
        self._slot_cond = threading.Condition(self._lock)
        self._next_sid = 0
        # Loss accounting for retired streams (live streams are added on
        # top in metrics()): the batched path's lossy sends are a
        # deliberate tradeoff vs the reference's blocking channel — these
        # counters make the tradeoff observable (zero under nominal load).
        self._retired_transcript_drops = 0
        self._retired_audio_drops = 0
        # Latency sample series (seconds), bounded so a long-lived server
        # keeps a sliding window: admission -> first emitted partial, and
        # window-ready -> results-applied per dispatched stream-round
        # (the scheduler's queueing + round latency — the number the
        # max_round_streams knob trades against throughput).
        from collections import deque

        self._lat_admit = deque(maxlen=4096)
        self._lat_round = deque(maxlen=4096)
        # Round pipelining: dispatch round N+1 before blocking on round
        # N's device->host fetch.  Only an engine whose window splits into
        # dispatch and fetch supports it.
        self.pipeline_rounds = bool(
            getattr(self.engine, "supports_async_window", False)
        )
        self._closed = threading.Event()
        # Signaled by every stream ring on send/close: the scheduler blocks
        # on this single event when idle instead of polling (the reference's
        # transcriber thread blocks on its channel the same way, lib.rs:462).
        self._wake = threading.Event()
        self._thread = threading.Thread(
            target=self._run, name="batch-scheduler", daemon=True
        )
        self._thread.start()

    @classmethod
    def from_definition(cls, definition, max_streams: int = 8, **kwargs) -> "BatchedTranscriber":
        """Build the model and the scheduler in one call; ``kwargs`` pass
        through to the constructor."""
        return cls(definition.blocking_try_to_model(), max_streams, **kwargs)

    # ------------------------------------------------------------------

    @instrument
    def blocking_start(
        self, settings: Settings, timeout: float = 0.0
    ) -> BatchedStreamHandle:
        """Admit a stream.  ``timeout`` bounds how long to wait for a free
        slot: 0 (default, reference-shaped — lib.rs:649-661 rejects a busy
        transcriber immediately) raises ``TooManyStreams`` at once; > 0
        waits up to that many seconds for a retirement to free a slot
        (streams retire asynchronously at round boundaries, so a serving
        loop admitting at capacity should pass a small timeout)."""
        if settings.source is None:
            raise NormaError(
                "BatchedTranscriber requires an injected AudioSource per "
                "stream (microphone multiplexing is host-specific)"
            )
        deadline = time.monotonic() + timeout
        with self._lock:
            while True:
                if self._closed.is_set():
                    # The scheduler thread is gone (close() or a fatal decode
                    # error): a stream admitted now would capture forever and
                    # its receiver would block forever.
                    raise NormaError("BatchedTranscriber is closed")
                if len(self._streams) < self.max_streams:
                    break
                remaining = deadline - time.monotonic()
                if remaining <= 0 or not self._slot_cond.wait(remaining):
                    raise TooManyStreams(self.max_streams)
            sid = self._next_sid
            self._next_sid += 1

            # Imported here: audio.pipeline imports runtime.channels.
            from ..audio.pipeline import StreamPipeline

            chunk_len = max(
                self.model.SAMPLE_RATE, self.model.longform.window_samples // 25
            )
            ring = RecycledRing(8, chunk_len, self.model.dtype, wakeup=self._wake)
            pipeline = StreamPipeline(
                settings.source, self.model.SAMPLE_RATE, self.model.dtype, ring,
                first_flush_len=self.first_partial_samples,
            )
            lang = LanguageState(const=self._base_lang.const)
            # No seed= here: the batched path never calls the decoder's own
            # transcribe loop — the live per-stream seed is _Stream.seed,
            # passed to engine.transcribe_window by _decode_round.
            state = LongFormDecoder(
                self.engine,
                self.tokenizer,
                lang,
                language_tokens=self._language_tokens,
                timestamps=self.model.longform.timestamps,
            )
            schan = StringChannel(8)
            stream = _Stream(sid, pipeline, ring, state, schan)
            self._streams[sid] = stream
        # Source start — arbitrary, possibly blocking user I/O — runs
        # OUTSIDE the lock: the scheduler's drain/retire steps and close()
        # need _lock, so a slow or hung start() under it would stall every
        # live stream and wedge shutdown.  The slot above is already
        # reserved, so capacity accounting stays correct meanwhile (the
        # scheduler skips the empty-ring, want_decode=False stream).
        try:
            pipeline.start()
        except Exception:
            # A source that fails to start must not leak its slot (the
            # caller gets no handle, so nothing could ever stop it and
            # repeated failures would exhaust max_streams) — and a
            # blocked admission waiter must see the freed slot.
            with self._lock:
                self._streams.pop(sid, None)
                self._slot_cond.notify_all()
            raise
        closed_raced = retired = False
        with self._lock:
            if self._closed.is_set():
                # close() or a fatal round raced the unlocked start: its
                # snapshot may have stopped the pipeline BEFORE start() ran
                # (stop-then-start leaves the source's worker live behind a
                # closed transcriber), so stop again — idempotent — outside
                # the lock (it joins the worker thread).
                closed_raced = True
                # A stream the teardown already retired was served: its
                # sender is closed, so its handle's receiver ends (a fast
                # source can fill the ring and a fatal round retire the
                # stream before start() returns).  One still registered was
                # never seen by the teardown: it is refused.
                retired = sid not in self._streams
                self._streams.pop(sid, None)
        if closed_raced:
            pipeline.stop()
            if not retired:
                raise NormaError("BatchedTranscriber is closed")
        return BatchedStreamHandle(self, sid, schan.receiver())

    def _stop_stream(self, sid: int) -> None:
        with self._lock:
            s = self._streams.get(sid)
        if s is not None:
            s.pipeline.stop()  # flushes final chunk, closes ring

    def warmup(self) -> None:
        """Run one silent window at every batch bucket this scheduler can
        dispatch (one per power-of-two bucket), so no live round pays a
        first-use cost (the kernel build, CUDA context and library
        initialization, allocator growth at a new batch width) mid-stream.
        """
        # Rounds never take more than max_round_streams ready streams, so
        # larger buckets would be compiled and never dispatched.
        n_max = self.max_streams
        if self.max_round_streams is not None:
            n_max = min(n_max, self.max_round_streams)
        buckets = sorted({self._round_batch(n) for n in range(1, n_max + 1)})
        for b in buckets:
            self.model.warmup(batch=b)

    def close(self) -> None:
        # _closed must be set INSIDE the lock, before the snapshot: a
        # blocking_start racing between snapshot and set would admit a
        # stream close() never stops, and the scheduler (whose shutdown
        # condition needs every source closed) would never exit.
        with self._lock:
            self._closed.set()
            # Waiters in blocking_start must observe the close, not block
            # out their full admission timeout.
            self._slot_cond.notify_all()
            streams = list(self._streams.values())
        for s in streams:
            s.pipeline.stop()
        self._wake.set()
        self._thread.join(timeout=30)

    # ------------------------------------------------------------------

    def _drain_rings(self) -> bool:
        got = False
        with self._lock:
            streams = list(self._streams.values())
        for s in streams:
            while True:
                status, chunk = s.ring.poll()
                if status == "chunk":
                    s.state.feed(chunk.data)
                    if chunk.is_final:
                        s.final = True
                    s.ring.release(chunk)
                    if not s.want_decode:
                        s.t_ready = time.monotonic()
                    s.want_decode = True
                    got = True
                elif status == "closed":
                    # Closed AND drained == no more audio can ever arrive.
                    # This is the final-chunk condition even when the
                    # is_final chunk itself was dropped by the lossy ring
                    # (a full ring at stop() time): without this, the
                    # stream never satisfies the retire condition and its
                    # receiver blocks forever while the slot leaks.  Also
                    # re-arm want_decode once: a stream that was holding
                    # buffered audio for more data ("Transcribed, waiting"
                    # path => want_decode False) must get one final round
                    # with final=True to drain, or it would likewise never
                    # retire.
                    if not s.source_closed:
                        s.source_closed = True
                        s.final = True
                        if s.state.next_window() is not None:
                            if not s.want_decode:
                                s.t_ready = time.monotonic()
                            s.want_decode = True
                    break
                else:
                    break
        return got

    def _ready(self) -> List[_Stream]:
        with self._lock:
            streams = list(self._streams.values())
        ready = [
            s
            for s in streams
            if not s.dead
            and not s.in_flight
            and s.want_decode
            and s.state.next_window() is not None
        ]
        cap = self.max_round_streams
        if self.target_p99_ms is not None:
            sla = self._sla_round_cap()
            cap = sla if cap is None else min(cap, sla)
        if cap is not None and len(ready) > cap:
            # Capped round: rotate the slice so successive rounds cycle
            # through all ready streams (no starvation under a permanent
            # backlog).
            ready.sort(key=lambda s: s.sid)
            start = self._round_rr % len(ready)
            ready = (ready + ready)[start : start + cap]
            self._round_rr += cap
        return ready

    def _sla_round_cap(self) -> int:
        """Most streams one round may take so that its predicted worst-case
        wait meets ``target_p99_ms``.

        A stream that becomes ready just after a dispatch waits for the
        in-flight round to finish and then for its own round: predicted
        wait ~= 2 x the measured round cost (EMA of dispatch->applied wall)
        of the bucket that round dispatches.  The cap is a stream COUNT,
        checked against the bucket each count actually dispatches
        (``_round_batch``).  Buckets without a measurement yet are allowed
        optimistically so warm-up rounds calibrate the model; the cap never
        drops below one stream (the SLA may then be unachievable — the
        metrics expose both numbers).
        """
        target_s = self.target_p99_ms / 1e3
        best = 1
        for n in range(1, self.max_streams + 1):
            ema = self._round_cost_ema.get(self._round_batch(n))
            if ema is not None and 2.0 * ema > target_s:
                break  # round cost grows with the bucket: more can only be worse
            best = n
        return best

    @staticmethod
    def _batch_size(n: int, cap: int) -> int:
        """Pad to the next power of two (<= cap): low-occupancy rounds skip
        the full-width batch while keeping compiled variants to log2(cap)."""
        b = 1
        while b < n:
            b *= 2
        return min(b, cap)

    def _round_batch(self, n: int) -> int:
        """The exact batch width a round with ``n`` ready streams dispatches:
        the power-of-two bucket, capped at max_streams.  Single source of
        truth for _dispatch_round, warmup and the SLA cap."""
        return self._batch_size(n, self.max_streams)

    @instrument(
        fields={"n_ready": lambda a: len(a["ready"])}
    )
    def _dispatch_round(self, ready: List[_Stream]):
        """Build and DISPATCH one fused round; returns the pending handle.

        The program covers mel, encoder, per-stream language detection
        (lang slot -1), prefill, the no-speech gate and the FULL
        temperature-fallback ladder for every stream in lockstep — so one
        stream's rare t>0 fallback no longer serializes the round on the
        scheduler thread, and detection costs no
        extra encoder pass.

        With ``pipeline_rounds`` the dispatch returns before the
        device->host fetch and `_apply_round` fetches later.
        """
        n = len(ready)
        B = self._round_batch(n)
        lf0 = ready[0].state
        n_frames = lf0.n_frames

        windows = np.zeros((B, (n_frames - 1) * 160 + 400), np.float32)
        for i, s in enumerate(ready):
            windows[i] = prepare_audio(s.state.next_window(), n_frames=n_frames)
        if n < B:
            # Pad rows: content is irrelevant (n_active marks them inert in
            # the ladder program — born-finished, zero decode steps); row 0
            # is copied only to keep the mel/encoder numerics on well-formed
            # audio.
            windows[n:] = windows[0]

        langs = np.zeros(B, np.int32)
        for i, s in enumerate(ready):
            tok = s.state.lang.token
            langs[i] = tok if tok is not None else -1  # -1: detect in-graph
        if n < B:
            langs[n:] = self.engine.st.sot  # pad rows skip detection

        # Seed cadence matches LongFormDecoder._next_seed (bump, then use),
        # so a single batched stream samples bit-identically to the
        # single-stream path.
        for s in ready:
            s.seed += len(TEMPERATURES)
            s.in_flight = True

        audio_t = torch.from_numpy(windows).to(self.engine.device)
        t_dispatch = time.monotonic()
        if self.pipeline_rounds:
            pending = self.engine.transcribe_window_async(
                audio_t, langs, seed=ready[0].seed, n_active=n
            )
        else:
            pending = self.engine.transcribe_window(
                audio_t, langs, seed=ready[0].seed, n_active=n
            )
        return ready, pending, B, t_dispatch

    def _apply_round(self, round_) -> None:
        """Fetch a dispatched round's results and apply them per stream."""
        ready, pending, B, t_dispatch = round_
        try:
            if self.pipeline_rounds:
                drs, info = self.engine.transcribe_window_fetch(pending)
            else:
                drs, info = pending
        finally:
            for s in ready:
                s.in_flight = False

        now = time.monotonic()
        # Cost-model EMA for the SLA round sizing (also a metrics column).
        dt = now - t_dispatch
        prev = self._round_cost_ema.get(B)
        self._round_cost_ema[B] = dt if prev is None else 0.7 * prev + 0.3 * dt
        for i, s in enumerate(ready):
            if s.t_ready is not None:
                self._lat_round.append(now - s.t_ready)
                s.t_ready = None
            if s.state.lang.needs_detection:
                s.state.lang.set_detected(int(info["langs"][i]))
            cont = s.state.apply_result(drs[i], s.final)
            s.want_decode = bool(cont)
            if cont:
                # The next window is already buffered: its ready period
                # starts now.
                s.t_ready = now
            self._emit(s)

    def _decode_round(self, ready: List[_Stream]) -> None:
        self._apply_round(self._dispatch_round(ready))

    def _emit(self, s: _Stream) -> None:
        text = s.state.finish_call(final_chunk=False)
        if text:
            if not s.first_emit_done:
                s.first_emit_done = True
                self._lat_admit.append(time.monotonic() - s.t_admit)
            try:
                s.schan.try_send(text)
            except ReceiverClosed:
                s.dead = True
                s.pipeline.stop()

    def _finish_stream(self, s: _Stream) -> None:
        s.state.finish_call(final_chunk=True)  # clears detected language
        s.schan.close_sender()
        with self._lock:
            self._streams.pop(s.sid, None)
            self._retired_transcript_drops += s.schan.dropped
            self._retired_audio_drops += s.ring.dropped
            self._slot_cond.notify_all()

    def metrics(self) -> Dict[str, object]:
        """Loss counters and latency percentiles.

        ``transcript_drops``: segments discarded by the bounded-wait
        ``StringChannel.try_send`` (a consumer stalled > 0.2 s);
        ``audio_drops``: chunks discarded by the lossy audio ring
        (reference semantics, lib.rs:248-252).  Both are 0 under nominal
        load (pinned by the churn soaks).

        ``latency``: sliding-window (last 4096 samples) percentiles in
        milliseconds over two series — ``admit_to_first_partial`` (stream
        admission to its first emitted text) and ``ready_to_applied``
        (a window becoming decodable to its round's results applied: the
        scheduler queueing + round latency that ``max_round_streams``
        and round pipelining trade against throughput).
        """
        with self._lock:
            live = list(self._streams.values())
            t = self._retired_transcript_drops + sum(
                s.schan.dropped for s in live
            )
            a = self._retired_audio_drops + sum(s.ring.dropped for s in live)
            lat_admit = list(self._lat_admit)
            lat_round = list(self._lat_round)

        def pct(samples):
            if not samples:
                return None
            arr = np.asarray(samples) * 1e3
            return {
                "n": len(samples),
                "p50_ms": round(float(np.percentile(arr, 50)), 1),
                "p90_ms": round(float(np.percentile(arr, 90)), 1),
                "p99_ms": round(float(np.percentile(arr, 99)), 1),
                "max_ms": round(float(arr.max()), 1),
            }

        out = {
            "transcript_drops": t,
            "audio_drops": a,
            "latency": {
                "admit_to_first_partial": pct(lat_admit),
                "ready_to_applied": pct(lat_round),
            },
            # Measured per-bucket round cost (the SLA sizing's model).
            "round_cost_ema_ms": {
                B: round(v * 1e3, 1)
                for B, v in sorted(self._round_cost_ema.items())
            },
        }
        if self.target_p99_ms is not None:
            out["sla"] = {
                "target_p99_ms": self.target_p99_ms,
                "round_cap": self._sla_round_cap(),
            }
        return out

    def _run(self) -> None:
        pending = None  # dispatched round awaiting fetch/apply
        while True:
            # Clear before draining: data arriving after the drain re-sets
            # the event, so the idle wait below never misses a wakeup.
            self._wake.clear()
            if self._closed.is_set():
                if pending is not None:
                    try:
                        self._apply_round(pending)
                    except Exception:
                        logger.exception("in-flight round failed during close")
                    pending = None
                with self._lock:
                    remaining = list(self._streams.values())
                if not remaining or all(
                    s.source_closed and s.state.next_window() is None
                    for s in remaining
                ):
                    for s in remaining:
                        self._finish_stream(s)
                    return
            got = self._drain_rings()
            ready = self._ready()
            try:
                if ready and self.pipeline_rounds:
                    # Round pipelining: dispatch the NEXT round before
                    # applying the previous round's results.  _ready()
                    # excludes in-flight streams, so consecutive rounds
                    # are always disjoint.
                    nxt = self._dispatch_round(ready)
                    if pending is not None:
                        self._apply_round(pending)
                    pending = nxt
                elif ready:
                    # Synchronous engine (no async dispatch/fetch split):
                    # _dispatch_round blocks for the full round compute, so
                    # deferring the apply to the next iteration would leave
                    # fetched results sitting a whole extra round while
                    # excluding their streams from it.  Apply
                    # immediately; pending stays None on this path.
                    self._decode_round(ready)
                elif pending is not None:
                    self._apply_round(pending)
                    pending = None
            except Exception:
                # Fatal (e.g. a device error): tear the transcriber
                # down like close() would — stop capture pipelines so
                # threads/rings don't leak, mark closed so late
                # blocking_start calls are refused, and retire every
                # stream (closes senders so receivers unblock, pops the
                # slot, folds its drop counters into the retired totals
                # — zombie entries would otherwise report as 'live'
                # behind a dead scheduler forever).
                logger.exception("batched decode round failed")
                with self._lock:
                    self._closed.set()
                    self._slot_cond.notify_all()
                    streams = list(self._streams.values())
                for s in streams:
                    s.pipeline.stop()
                    self._finish_stream(s)
                raise
            # Retire streams whose source ended and buffer drained.  A
            # stream inside the in-flight round is never retired here:
            # its results are still pending and apply would touch a
            # finished state machine.
            with self._lock:
                done = [
                    s
                    for s in self._streams.values()
                    if not s.in_flight
                    and (
                        s.dead
                        or (
                            s.source_closed
                            and s.final
                            and (
                                s.state.next_window() is None
                                or not s.want_decode
                            )
                        )
                    )
                ]
            for s in done:
                # With final=True the hold paths never trigger, so a
                # remaining buffer means want_decode stayed True and the
                # next round drains it; only finish when empty.
                if s.dead or s.state.next_window() is None:
                    self._finish_stream(s)
            if not got and not ready and pending is None:
                # Event-driven idle: woken by any ring's send/close or by
                # close(); the timeout is only a liveness backstop.
                self._wake.wait(timeout=0.5)
