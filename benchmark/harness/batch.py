"""The ``batch`` traffic kind: windows of ``rows`` distinct audio rows,
back to back through the engine's window entry
(``transcribe_window_async`` -> ``transcribe_window_fetch``), with
``in_flight`` windows dispatched ahead of the fetch, as the scheduler
pipelines rounds.  The audio comes from a pool made in set-up.

Mix parameters: ``rows`` (rows a window), ``clip_s`` (audio seconds a
row), ``pool_windows`` (distinct windows of audio in the pool),
``in_flight`` (windows dispatched before the oldest is fetched),
``warm_windows`` (windows run in set-up), ``check_rows`` (rows the
reference follows).  A ``--trace 1`` run traces one eager window of the
pool's first rows after the measured window.
"""

from __future__ import annotations

import collections
import random
import time

from . import audio, program, stats, trace
from ..yardstick import counts


def trace_counts(tr, cfg, rows, steps) -> dict:
    """Events the trace holds against the launches the window's shapes
    make, and its busy time."""
    return {"w8": [tr.kernel_time_us("w8_mma_kernel")[0], len(counts.w8_launches(cfg, rows, round(steps)))],
            "q8a8": [tr.kernel_time_us("q8a8_wgmma_kernel")[0], len(counts.q8a8_launches(cfg, rows))],
            "sample_step": tr.kernel_time_us("sample_step_kernel")[0],
            "busy_ms": tr.busy_union_us(*tr.window) / 1e3}


def _serve(engine, pool, lang, in_flight, results, seconds=None, count=None, dispatch_ms=None):
    """Windows back to back until the first fetch at or after ``seconds``
    from the first dispatch (or until ``count`` are dispatched), then the
    ones in flight.  Appends each window's (pool index, results) and
    returns (first dispatch, each fetch's end)."""
    pending, fetched = collections.deque(), []
    i = 0
    t_first = time.perf_counter()
    while count is None or i < count:
        k = i % len(pool)
        t0 = time.perf_counter()
        pending.append((k, engine.transcribe_window_async(pool[k], [lang] * pool[k].shape[0], seed=i)))
        if dispatch_ms is not None:
            dispatch_ms.append((time.perf_counter() - t0) * 1e3)
        i += 1
        if len(pending) > in_flight:
            k0, p = pending.popleft()
            results.append((k0, engine.transcribe_window_fetch(p)[0]))
            fetched.append(time.perf_counter())
            if seconds is not None and fetched[-1] - t_first >= seconds:
                break
    while pending:
        k0, p = pending.popleft()
        results.append((k0, engine.transcribe_window_fetch(p)[0]))
        fetched.append(time.perf_counter())
    return t_first, fetched


def serve(engine, cfg, mix, seed, seconds, run=None) -> dict:
    """Make the pool, warm the window's shape up, then serve windows for
    ``seconds``.  Returns the pool, the results, the audio rate, the
    serving window's memory peak and the window's stamps."""
    B, lang, dev = mix["rows"], cfg["assumed"]["language"], engine.device
    clip = int(mix["clip_s"] * audio.SAMPLE_RATE)
    pool_rows = audio.rows(seed, mix["pool_windows"] * B, clip, program.window_samples(cfg))
    pool = [pool_rows[w * B:(w + 1) * B] for w in range(mix["pool_windows"])]
    for w in range(mix["warm_windows"]):  # the window's graph is captured on the first
        engine.transcribe_window_fetch(engine.transcribe_window_async(pool[w % len(pool)], [lang] * B, seed=w))
    program.sync(dev)
    if run is not None:
        run.setup_done()
    setup_peak = program.reset_peak(dev)

    results, dispatch_ms = [], []
    s0 = engine.decode_steps
    t_first, fetched = _serve(engine, pool, lang, mix["in_flight"], results, seconds=seconds,
                              dispatch_ms=dispatch_ms)
    windows = len(results)
    gaps = sorted((b - a) * 1e3 for a, b in zip(fetched, fetched[1:]))
    return dict(pool=pool, results=results, windows=windows, dispatch_ms=dispatch_ms,
                audio_s_per_s=stats.audio_rate(B * mix["clip_s"], windows, t_first, fetched[-1]),
                wall_ms=(fetched[-1] - t_first) * 1e3 / windows, steps=(engine.decode_steps - s0) / windows,
                setup_peak=setup_peak, window_peak=program.peak(dev),
                fetch_gap_ms={q: stats.percentile(gaps, p) for q, p in (("p10", 10), ("p50", 50), ("p90", 90))}
                if gaps else None)


def drive(run) -> None:
    cfg, mix, dev = run.cfg, run.mix, run.device
    B = mix["rows"]
    lang = cfg["assumed"]["language"]
    engine = program.build_engine(cfg, run.seed, dev)
    out = serve(engine, cfg, mix, run.seed, run.seconds, run=run)
    pool, results, windows = out["pool"], out["results"], out["windows"]
    run.e2e["audio_s_per_s"] = out["audio_s_per_s"]
    run.set_memory(out["setup_peak"], out["window_peak"])
    if out["fetch_gap_ms"] is not None:  # fetch to fetch: a window's wall in the steady pipeline
        run.extra["fetch_gap_ms"] = out["fetch_gap_ms"]
    run.data.update(rows=B, windows=windows, wall_ms=out["wall_ms"], steps=out["steps"],
                    dispatch_ms=out["dispatch_ms"], cfg=cfg)

    if run.trace and dev.type == "cuda":  # the CPU has no device trace
        # The window's kernels launched one by one, outside its graph, the
        # device alone traced: a profiler session over a large-v3 graph
        # window has ended in an illegal memory access.
        traced, s1 = [], engine.decode_steps
        with trace.session(traced, host=False):
            engine.transcribe_window_eager(pool[0], [lang] * B, seed=0)
        run.data.update(trace=traced[0], trace_steps=engine.decode_steps - s1)
        run.extra["trace_kernels"] = trace_counts(traced[0], cfg, B, run.data["trace_steps"])

    # Every window's rows answered, each with its prefix; the reference
    # follows ``check_rows`` distinct batch slots, each from a window drawn
    # from the seed, the longest row among them.
    prefix = [cfg["assumed"]["special_tokens"]["sot"], lang, cfg["assumed"]["special_tokens"]["task"]]
    missing = sum(1 for _, drs in results for dr in drs if dr is None or list(dr.tokens[:3]) != prefix)
    run.attempted, run.failed = windows * B, missing
    run.checks["rows_missing"] = (missing, 0)
    rng = random.Random(run.seed)
    slots = rng.sample(range(B), min(B, mix["check_rows"]))
    picks = [(rng.randrange(windows), b) for b in slots]
    longest = max(((w, b) for w in range(windows) for b in range(B) if results[w][1][b] is not None),
                  key=lambda wb: len(results[wb[0]][1][wb[1]].tokens), default=None)
    if longest is not None and longest not in picks:
        picks[-1] = longest
    run.samples = [(pool[results[w][0]][b], results[w][1][b].tokens) for w, b in picks if results[w][1][b] is not None]
    del engine, out
    run.free()
