"""The ``live`` traffic kind: ``streams`` independent live streams served by
the port's scheduler (``runtime/batching.py::BatchedTranscriber``), open
loop.

One feeder thread pushes every stream's audio in blocks of ``block_s``
seconds on the stream's own real-time schedule, whether or not its
earlier windows are done, and keeps what it pushed.  The streams' start
phases are spread evenly over ``phase_span_s`` seconds, the same phases
for every seed, their assignment to streams shuffled by the seed.  Every
stream lasts the whole run.  The scheduler runs with ``max_streams`` slots
and no other knob unless the mix names it (``max_round_streams``,
``target_p99_ms``, ``first_partial_seconds`` pass through).

A stream-window's latency runs from when the oldest audio it decodes for
the first time was due to when its result was applied.  The program takes
a stream's audio in chunks of ``max(1 s, window / 25)``; a chunk is due
when its last sample is due from the feeder's clock, so the wait for a
chunk to fill is the source's, not counted, while any wait after it is.

The benchmark reads only the program's public calls.  Wrappers around
the engine's ``transcribe_window_async`` and ``transcribe_window_fetch``
stamp each round's dispatch and keep each active row's first and last
samples and its length; a wrapper around ``LongFormDecoder.apply_result``
stamps the applied time.  Once the window has closed, each row is found
in its stream's pushed audio by its first samples, which gives the
window's bounds in the stream.  A window whose audio was all decoded
before (a follow-up window over a buffer that holds more than a window)
is not a stream-window a user waits for, and is counted apart.
"""

from __future__ import annotations

import heapq
import random
import threading
import time
from typing import Dict, List

import numpy as np
import torch

from . import audio, program, stats, trace

EDGE = 16  # samples of a row kept at each end to find it in its stream


class Feeder:
    """Pushes ``len(sources)`` streams' blocks from one thread and keeps
    them; records how late each push ran.  ``pause`` stops the pushes and
    ``resume`` shifts every later due time by the pause."""

    def __init__(self, sources, streams: List[audio.Stream], phases: List[float], block_n: int):
        self.sources, self.streams, self.phases = sources, streams, phases
        self.block_n, self.block_s = block_n, block_n / audio.SAMPLE_RATE
        self.pushed: List[List[np.ndarray]] = [[] for _ in sources]
        self.late_ms: List[float] = []
        self.t0 = None
        self._halt = threading.Event()
        self._paused = threading.Event()
        self._paused_at = None
        self._thread = threading.Thread(target=self._run, name="benchmark-feeder", daemon=True)

    def start(self, t0: float) -> None:
        self.t0 = t0
        self._thread.start()

    def due(self, i: int, sample: int) -> float:
        """When stream ``i``'s ``sample`` is due: its block's end."""
        return self.t0 + self.phases[i] + (sample // self.block_n + 1) * self.block_s

    def audio(self, i: int) -> np.ndarray:
        """Everything pushed to stream ``i`` so far."""
        return np.concatenate(self.pushed[i]) if self.pushed[i] else np.zeros(0, np.float32)

    def _run(self) -> None:
        heap = [(self.phases[i] + self.block_s, i) for i in range(len(self.sources))]
        heapq.heapify(heap)
        while not self._halt.is_set():
            if self._paused.is_set():
                self._halt.wait(0.01)
                continue
            offset, i = heap[0]
            due = self.t0 + offset
            wait = due - time.perf_counter()
            if wait > 0:
                self._halt.wait(min(wait, 0.02))
                continue
            heapq.heapreplace(heap, (offset + self.block_s, i))
            src = self.sources[i]
            if src.on_data is not None and not src.stopped:
                block = self.streams[i].block(self.block_n)
                self.pushed[i].append(block)
                src.on_data(block)
            self.late_ms.append((time.perf_counter() - due) * 1e3)

    def pause(self) -> None:
        self._paused_at = time.perf_counter()
        self._paused.set()

    def resume(self) -> None:
        self.t0 += time.perf_counter() - self._paused_at
        self._paused.clear()

    def close(self) -> None:
        self._halt.set()
        if self._thread.is_alive():
            self._thread.join(timeout=10)


def _source_class():
    from norma_tpu_torch.audio.sources import AudioSource

    class Source(AudioSource):
        sample_rate, channels, dtype = audio.SAMPLE_RATE, 1, np.dtype(np.float32)

        def __init__(self):
            self.on_data, self.stopped = None, False

        def start(self, on_data, on_end=None):
            self.on_data = on_data

        def stop(self):
            self.stopped = True

    return Source


def valid_length(row: np.ndarray) -> int:
    """Samples of a zero-padded row before its padding, by bisection (the
    streams' audio holds noise, so no sample of it is exactly 0)."""
    lo, hi = 0, row.shape[0]  # row[:lo] audio, row[hi:] padding
    while lo < hi:
        mid = (lo + hi) // 2
        if row[mid] != 0.0:
            lo = mid + 1
        else:
            hi = mid
    return lo


def find(stream: np.ndarray, head: np.ndarray, lo: int, hi: int) -> int:
    """The first offset in [lo, hi] at which ``stream`` holds ``head``."""
    seg = stream[lo:hi + len(head)]
    for o in np.flatnonzero(seg[:hi - lo + 1] == head[0]):
        if np.array_equal(seg[o:o + len(head)], head):
            return lo + int(o)
    raise RuntimeError("a served row's audio is not in its stream's pushed audio")


def resolve(records: List[Dict], feeder: Feeder, window_n: int, chunk_n: int, until: float) -> None:
    """Fill each record applied by ``until`` with its ``due`` from its
    bounds in its stream (None
    where it holds no first-time audio), and its ``skipped``: the samples
    between the end of the audio decoded before and its start, which no
    window decoded.  A state's first window starts at its stream's first
    sample, which names the stream; each later window starts where the one
    before it started, or after, by at most a window."""
    audios = [feeder.audio(i) for i in range(len(feeder.sources))]
    by_state: Dict[int, List[Dict]] = {}
    for r in records:
        if r["state"] is not None and r["applied"] <= until:
            by_state.setdefault(r["state"], []).append(r)
    for recs in by_state.values():
        recs.sort(key=lambda r: r["dispatched"])
        first = recs[0]["head"]
        i = next((k for k, a in enumerate(audios) if np.array_equal(a[:EDGE], first)), None)
        if i is None:
            raise RuntimeError("a stream's first window does not start at its first sample")
        a, start, hi = audios[i], 0, 0
        for r in recs:
            start = find(a, r["head"], start, start + window_n)
            n = r["n"]
            end = start + n
            if not np.array_equal(a[end - EDGE:end], r["tail"]):
                raise RuntimeError("a served row's end is not its stream's audio")
            if n < window_n and end % chunk_n:
                raise RuntimeError(f"a whole buffer ends at {end}, not on a chunk of {chunk_n}")
            r["skipped"] = max(0, start - hi)
            if end > hi:
                first_new = max(start, hi)
                r["due"] = feeder.due(i, (first_new // chunk_n + 1) * chunk_n - 1)
            hi = max(hi, end)


class Stamps:
    """The benchmark's wrappers around the program's public calls, and the
    row records they stamp."""

    def __init__(self, engine, keep: int, seed: int):
        from norma_tpu_torch.decode.longform import LongFormDecoder

        self.engine = engine
        self.records: List[Dict] = []
        self.rounds: List[Dict] = []
        self.applied_states = set()
        self.in_flight = 0
        self._fetched: Dict[int, List[Dict]] = {}  # id(result) -> its records, oldest first
        self._fetched_none: List[Dict] = []  # records of rows with no result, in order
        self._by_pending: Dict[int, tuple] = {}
        # A reservoir of ``keep`` records drawn uniformly from those
        # dispatched from ``keep_from`` on, with copies of their audio rows,
        # for the reference to follow.
        self._rng = random.Random(seed)
        self.keep, self.kept, self._seen, self.keep_from = keep, [], 0, None
        self._cls = LongFormDecoder
        self._orig = LongFormDecoder.apply_result
        stamps = self
        inner_async, inner_fetch = engine.transcribe_window_async, engine.transcribe_window_fetch

        def window_async(audio_rows, langs, seed, n_active=None):
            t = time.perf_counter()
            pending = inner_async(audio_rows, langs, seed, n_active)
            B = int(audio_rows.shape[0])
            n = B if n_active is None else int(n_active)
            stamps.rounds.append(dict(B=B, n_active=n, dispatched=t))
            recs = []
            for row in audio_rows[:n]:
                m = valid_length(row)
                r = dict(dispatched=t, applied=None, state=None, due=None, n=m,
                         head=np.array(row[:EDGE], copy=True), tail=np.array(row[m - EDGE:m], copy=True))
                stamps._keep(r, row)
                recs.append(r)
            stamps.records += recs
            stamps.in_flight += n
            stamps._by_pending[id(pending)] = (pending, recs)
            return pending

        def window_fetch(pending):
            out = inner_fetch(pending)
            _, recs = stamps._by_pending.pop(id(pending))
            for r, dr in zip(recs, out[0]):
                if dr is None:
                    stamps._fetched_none.append(r)
                else:
                    stamps._fetched.setdefault(id(dr), []).append(r)
            return out

        def apply_result(state, dr, final_chunk):
            out = stamps._orig(state, dr, final_chunk)
            if dr is None:
                r = stamps._fetched_none.pop(0) if stamps._fetched_none else None
            else:
                q = stamps._fetched.get(id(dr))
                r = q.pop(0) if q else None
                if q is not None and not q:
                    del stamps._fetched[id(dr)]
            if r is not None:
                r["applied"] = time.perf_counter()
                r["state"] = id(state)
                r["tokens"] = None if dr is None else list(dr.tokens)
                stamps.applied_states.add(id(state))
                stamps.in_flight -= 1
            return out

        engine.transcribe_window_async, engine.transcribe_window_fetch = window_async, window_fetch
        LongFormDecoder.apply_result = apply_result

    def _keep(self, r: Dict, row) -> None:
        if self.keep_from is None or r["dispatched"] < self.keep_from:
            return
        self._seen += 1
        j = self._seen - 1 if len(self.kept) < self.keep else self._rng.randrange(self._seen)
        if j >= self.keep:
            return
        r["audio"] = np.array(row, np.float32, copy=True)
        if j < len(self.kept):
            self.kept[j].pop("audio")
            self.kept[j] = r
        else:
            self.kept.append(r)

    def wait_idle(self, quiet_s: float = 0.3, timeout: float = 60.0) -> None:
        """Until no row is in flight and no round was dispatched for
        ``quiet_s`` (the feeder paused, the rings drain)."""
        deadline = time.perf_counter() + timeout
        n, since = len(self.rounds), time.perf_counter()
        while time.perf_counter() < deadline:
            time.sleep(0.02)
            if len(self.rounds) != n or self.in_flight:
                n, since = len(self.rounds), time.perf_counter()
            elif time.perf_counter() - since >= quiet_s:
                return
        raise RuntimeError("the scheduler did not settle")

    def restore(self) -> None:
        self._cls.apply_result = self._orig
        self.engine.__dict__.pop("transcribe_window_async", None)
        self.engine.__dict__.pop("transcribe_window_fetch", None)


def serve(engine, cfg: Dict, mix: Dict, seed: int, seconds: float, run=None, trace_s: float = 0.0) -> Dict:
    """Serve the mix's streams for ``seconds`` after every stream has had a
    window applied; with ``trace_s``, trace that much more serving.
    Returns the measured window's samples and counts."""
    from norma_tpu_torch.input import Settings
    from norma_tpu_torch.runtime.batching import BatchedTranscriber

    n = mix["streams"]
    model = program.build_model(engine, cfg)
    window_n = model.longform.window_samples
    chunk_n = max(audio.SAMPLE_RATE, window_n // 25)  # the program's chunk
    knobs = {k: mix[k] for k in ("max_round_streams", "target_p99_ms", "first_partial_seconds") if k in mix}
    bt = BatchedTranscriber(model, max_streams=mix["max_streams"], **knobs)
    out: Dict = {}
    feeder = stamps = None
    readers = []
    try:
        bt.warmup()  # every bucket's graphs
        rng = random.Random(seed)
        phases = [mix["phase_span_s"] * i / n for i in range(n)]
        rng.shuffle(phases)
        Source = _source_class()
        sources = [Source() for _ in range(n)]
        streams = [audio.Stream(seed, i) for i in range(n)]
        block_n = int(round(mix["block_s"] * audio.SAMPLE_RATE))
        feeder = Feeder(sources, streams, phases, block_n)
        stamps = Stamps(engine, 4 * mix["check_rows"], seed)
        handles = [bt.blocking_start(Settings(source=s)) for s in sources]
        readers = [threading.Thread(target=lambda h=h: list(h.receiver), daemon=True) for h in handles]
        for th in readers:
            th.start()
        feeder.start(time.perf_counter())
        deadline = time.perf_counter() + 120.0
        while len(stamps.applied_states) < n:
            if time.perf_counter() > deadline or not all(th.is_alive() for th in readers):
                raise RuntimeError(f"only {len(stamps.applied_states)} of {n} streams had a window applied")
            time.sleep(0.01)
        t0 = stamps.keep_from = time.perf_counter()
        if run is not None:
            run.setup_done()
        setup_peak = program.reset_peak(engine.device)
        time.sleep(max(0.0, t0 + seconds - time.perf_counter()))
        t1 = time.perf_counter()
        out.update(setup_peak=setup_peak, window_peak=program.peak(engine.device))
        # Due times on the feeder's clock as it ran in the window (a trace
        # below pauses it).
        resolve(list(stamps.records), feeder, window_n, chunk_n, t1)
        if trace_s > 0:
            # A profiler session started or stopped while another thread's
            # graph is on the card has ended in an illegal memory access
            # (H100): the session opens and closes with the scheduler idle.
            def settle():
                feeder.pause()
                stamps.wait_idle()
                torch.cuda.synchronize()

            traced = []
            settle()
            with trace.session(traced, settle=settle):
                feeder.resume()
                time.sleep(trace_s)
            out["trace"] = traced[0]
    finally:
        if feeder is not None:
            feeder.close()
        bt.close()
        if stamps is not None:
            stamps.restore()
        for th in readers:
            th.join(timeout=10)
    metrics = bt.metrics()
    late = sorted(feeder.late_ms)
    lat = stats.window_latencies(stamps.records, t0, t1)
    recs = [r for r in stamps.records if r["applied"] is not None and t0 <= r["applied"] <= t1]
    out.update(
        t0=t0, t1=t1, lat_ms=lat["lat_ms"], wait_ms=lat["wait_ms"], records=recs,
        rounds=[r for r in stamps.rounds if t0 <= r["dispatched"] <= t1],
        no_new_audio=sum(r["due"] is None for r in recs),
        skipped_audio_s=sum(r["skipped"] for r in recs) / audio.SAMPLE_RATE,
        audio_drops=metrics["audio_drops"], transcript_drops=metrics["transcript_drops"],
        feeder_late_ms={"p50": stats.percentile(late, 50), "p99": stats.percentile(late, 99), "max": late[-1]},
    )
    return out


def drive(run) -> None:
    cfg, mix = run.cfg, run.mix
    engine = program.build_engine(cfg, run.seed, run.device)
    trace_s = mix["trace_s"] if run.trace and run.device.type == "cuda" else 0.0  # the CPU has no device trace
    out = serve(engine, cfg, mix, run.seed, run.seconds, run=run, trace_s=trace_s)
    lat = out["lat_ms"]
    if not lat:
        raise RuntimeError("no stream-window was applied in the measured window")
    run.e2e["lat_p95_ms"] = stats.percentile(lat, 95)
    run.e2e["lat_p50_ms"] = stats.percentile(lat, 50)
    run.set_memory(out["setup_peak"], out["window_peak"])
    run.data.update(out, cfg=cfg)
    run.extra["feeder_late_ms"] = out["feeder_late_ms"]
    run.extra["stream_windows"] = len(lat)
    run.extra["no_new_audio"] = out["no_new_audio"]
    # Audio that arrived while its stream's window was in flight and was
    # drained with that window's slice, never decoded (PERF.md, open
    # questions): reported, not judged.
    run.extra["skipped_audio_s"] = out["skipped_audio_s"]
    # Every stream-window of the window answered with its prefix; no audio
    # dropped; the reference follows windows drawn from the seed.
    prefix = [cfg["assumed"]["special_tokens"]["sot"], cfg["assumed"]["language"],
              cfg["assumed"]["special_tokens"]["task"]]
    recs = out["records"]
    missing = sum(1 for r in recs if r["tokens"] is None or r["tokens"][:3] != prefix)
    run.attempted, run.failed = len(recs), missing
    run.checks["rows_missing"] = (missing, 0)
    run.checks["audio_drops"] = (out["audio_drops"], 0)
    kept = [r for r in recs if "audio" in r and r["tokens"] is not None]
    rng = random.Random(run.seed)
    picks = rng.sample(kept, min(mix["check_rows"], len(kept)))
    if kept:
        longest = max(kept, key=lambda r: len(r["tokens"]))
        if all(p is not longest for p in picks):
            picks[-1] = longest
    run.samples = [(r["audio"], r["tokens"]) for r in picks]
    del engine
    run.free()
