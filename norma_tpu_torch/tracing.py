"""Structured spans and the device report (``norma_tpu/tracing.py``).

  - ``span`` / ``instrument`` — timed spans on Python ``logging`` with
    user fields
  - ``decode_telemetry`` — the reference's per-decode trace fields
    (at_temp, logprob, no_speech_prob)
  - ``profile`` / ``annotate`` — a ``torch.profiler`` session over a
    region (CPU and CUDA activity, a Chrome trace per session under
    ``log_dir``) and named regions inside it
  - ``device_time_report`` / ``device_time_report_multi`` /
    ``profiled_device_ms`` — device time by name from those traces: the
    one measurement path for every device-ms figure; ``idle_share`` — the
    share of a call's wall time with no device work, overlapping streams
    counted once.  A CUDA session
    checks its own trace and raises :class:`DeviceEventsLost` where a
    launch came back without its device events
  - ``prime_device_tracer`` — one short session, once in a process,
    before its first CUDA graph with WHILE nodes is captured (the engine
    calls it): a graph captured before the process's first session is
    traced with each WHILE body's first pass only

The report reads the trace's event categories as JAX's reads xplane lines:
``"kernel"`` (one event per kernel, graph replays' included, every pass
of a graph's WHILE nodes) is the counterpart of "XLA Ops", ``"gpu_user_annotation"`` (the device span of
each :func:`annotate` region) that of "XLA Modules"; ``"gpu_memcpy"`` and
``"gpu_memset"`` are the copies and fills.  Host events are ignored.
"""

from __future__ import annotations

import contextlib
import functools
import glob
import inspect
import json
import logging
import os
import shutil
import socket
import tempfile
import time
from typing import Any, Dict, Optional

logger = logging.getLogger("norma_tpu_torch")


@contextlib.contextmanager
def span(name: str, level: int = logging.DEBUG, **fields: Any):
    """A timed, structured span: logs entry fields and exit duration.
    Errors are logged at ERROR level with the elapsed time."""
    t0 = time.perf_counter()
    logger.log(level, "%s enter %s", name, fields if fields else "")
    try:
        yield fields
    except Exception as e:
        logger.log(logging.ERROR, "%s error after %.3fms: %r",
                   name, (time.perf_counter() - t0) * 1e3, e)
        raise
    else:
        logger.log(level, "%s exit %.3fms", name, (time.perf_counter() - t0) * 1e3)


def instrument(
    _fn=None,
    *,
    name: Optional[str] = None,
    level: int = logging.DEBUG,
    fields: Optional[Dict[str, Any]] = None,
):
    """Decorator wrapping a call in a :func:`span`.

    ``fields`` maps a span-field name to an extractor over the call's bound
    arguments; extraction is skipped when the logger isn't enabled for
    ``level``.  Errors are logged at every level.
    """

    def deco(fn):
        span_name = name or fn.__qualname__
        sig = inspect.signature(fn) if fields else None

        def extract(args, kwargs) -> Dict[str, Any]:
            fvals: Dict[str, Any] = {}
            if fields:
                try:
                    bound = sig.bind_partial(*args, **kwargs)
                    bound.apply_defaults()
                except TypeError:  # never let telemetry break the call
                    return fvals
                for k, fx in fields.items():
                    key = k if k not in ("name", "level") else k + "_"
                    try:
                        fvals[key] = fx(bound.arguments)
                    except Exception:  # one bad extractor keeps the others
                        pass
            return fvals

        if inspect.iscoroutinefunction(fn):  # the span covers the awaited call

            @functools.wraps(fn)
            async def awrapper(*args, **kwargs):
                if not logger.isEnabledFor(level):
                    try:
                        return await fn(*args, **kwargs)
                    except Exception as e:
                        logger.error("%s error: %r", span_name, e)
                        raise
                with span(span_name, level=level, **extract(args, kwargs)):
                    return await fn(*args, **kwargs)

            return awrapper

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            if not logger.isEnabledFor(level):
                try:
                    return fn(*args, **kwargs)
                except Exception as e:
                    logger.error("%s error: %r", span_name, e)
                    raise
            with span(span_name, level=level, **extract(args, kwargs)):
                return fn(*args, **kwargs)

        return wrapper

    return deco(_fn) if _fn is not None else deco


def decode_telemetry(at_temp: float, avg_logprob: float, no_speech_prob: float) -> None:
    """The reference's decode trace fields (model.rs:180-185)."""
    logger.debug(
        "decoded at_temp=%.1f logprob=%.3f no_speech_prob=%.3f",
        at_temp,
        avg_logprob,
        no_speech_prob,
    )


# The trace's device categories; the first three are device-busy time.
BUSY_LINES = ("kernel", "gpu_memcpy", "gpu_memset")
DEVICE_LINES = BUSY_LINES + ("gpu_user_annotation",)
# Host calls that put kernels on the device; each has a correlation id that
# the device events it launched carry (a graph launch's, its kernels').
_LAUNCH_CALLS = ("LaunchKernel", "GraphLaunch", "cuLaunch")
_TRACE_GLOB = "*.pt.trace.json"

# Sessions the last :func:`profiled_device_ms` took, and the device events
# each session that lost some held.
last_profile: Dict[str, Any] = {"sessions": 0, "lost": []}
# The last CUDA session's check: launches, lost launches, device events, and
# the least time from a kernel launch call to its kernel's start (us; < 0
# when the device clock reads behind the host's).
last_session: Dict[str, Any] = {}
_session = 0
# Whether a session has been opened in this process (prime_device_tracer).
_tracer_started = False


class DeviceEventsLost(RuntimeError):
    """A profiler session came back without the device events of kernels
    that were launched inside it.  ``launches`` counts the host launches
    with no device event, ``device_events`` the device events it held;
    the message names the lost launches' calls and the ops that made them."""

    def __init__(self, path: str, launches: int, of: int, device_events: int, detail: str = ""):
        super().__init__(
            f"{path}: {launches} of {of} kernel launches have no device event "
            f"({device_events} device events in the trace){detail}"
        )
        self.launches, self.device_events = launches, device_events


def _events(path: str):
    with open(path) as f:
        return [e for e in json.load(f).get("traceEvents", []) if e.get("ph") == "X"]


def trace_events(trace_dir: str):
    """(path, event) for every complete event ("ph": "X") of every trace
    file under ``trace_dir``, files in name order.  An event's ``cat`` is
    its category (``DEVICE_LINES`` on the device; ``cpu_op``,
    ``cuda_runtime``, ``user_annotation``, ... on the host), ``ts`` and
    ``dur`` are in us, device events carry ``args["device"]``."""
    for path in sorted(glob.glob(os.path.join(trace_dir, "**", _TRACE_GLOB), recursive=True)):
        for ev in _events(path):
            yield path, ev


def _lost_launches(events):
    """(the launch events without a device event, launches, device events)."""
    corr = {e.get("args", {}).get("correlation") for e in events if e.get("cat") in BUSY_LINES}
    launches = [
        e for e in events
        if e.get("cat") in ("cuda_runtime", "cuda_driver") and any(c in e.get("name", "") for c in _LAUNCH_CALLS)
    ]
    lost = [e for e in launches if e.get("args", {}).get("correlation") not in corr]
    return lost, len(launches), sum(1 for e in events if e.get("cat") in DEVICE_LINES)


def _launch_to_start_us(events) -> Optional[float]:
    """The least (kernel start - its launch call's start) over the trace's
    kernels, in us: a launch precedes its kernel, so a negative value is
    the device clock reading behind the host's in the trace."""
    start = {}
    for e in events:
        if e.get("cat") == "kernel":
            c = e.get("args", {}).get("correlation")
            start[c] = min(start.get(c, float("inf")), float(e.get("ts", 0.0)))
    gaps = [start[c] - float(e.get("ts", 0.0)) for e in events
            if e.get("cat") in ("cuda_runtime", "cuda_driver") and (c := e.get("args", {}).get("correlation")) in start]
    return min(gaps) if gaps else None


def _lost_detail(events, lost) -> str:
    """The lost launches by (call, the op that made it), and where in the
    session they fell (us after its first event)."""
    ops = {e["args"]["External id"]: e.get("name") for e in events
           if e.get("cat") == "cpu_op" and "External id" in e.get("args", {})}
    t0 = min(float(e.get("ts", 0.0)) for e in events)
    by = {}
    for e in lost:
        key = (e.get("name"), ops.get(e.get("args", {}).get("External id")))
        by[key] = by.get(key, 0) + 1
    at = sorted(round(float(e.get("ts", 0.0)) - t0) for e in lost)
    first = min((float(e.get("ts", 0.0)) - t0 for e in events if e.get("cat") in BUSY_LINES), default=None)
    return (f"; lost by (call, op): {sorted(by.items(), key=lambda kv: -kv[1])[:8]}; at us {at[:6]}...{at[-3:]}; "
            f"first device event at us {first and round(first)}; least launch-to-start us "
            f"{_launch_to_start_us(events)}")


@contextlib.contextmanager
def profile(log_dir: str = os.path.join(tempfile.gettempdir(), "norma_tpu_torch_profile")):
    """Record CPU and CUDA activity for the enclosed region with
    ``torch.profiler`` and write its Chrome trace under ``log_dir``.

    On CUDA the session takes a warm-up step before it records (256 small
    kernels, waited for, under a ``torch.profiler`` schedule of one
    warm-up and one active step): sessions late in a long process on the
    H100 have come back without the device events of their first kernels
    while the launch calls were recorded, and a session recording from its
    start lost them where one with the warm-up step, in the same process,
    did not.  Then the session checks its own trace: every kernel or graph
    launch of the region must have its device events, or the trace is
    renamed ``*.lost`` and :class:`DeviceEventsLost` is raised."""
    global _session, _tracer_started
    import torch
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    cuda = torch.cuda.is_available()
    _tracer_started = True
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    os.makedirs(log_dir, exist_ok=True)
    if cuda:
        torch.cuda.synchronize()
    sched = torch.profiler.schedule(wait=0, warmup=1, active=1) if cuda else None
    with torch_profile(activities=activities, schedule=sched) as prof:
        if cuda:
            x = torch.zeros(1, device="cuda")
            for _ in range(256):
                x.add_(1.0)
            torch.cuda.synchronize()
            prof.step()
        yield log_dir
        if cuda:
            torch.cuda.synchronize()
    _session += 1
    path = os.path.join(log_dir, f"{socket.gethostname()}.{os.getpid()}.{_session}.pt.trace.json")
    prof.export_chrome_trace(path)
    if cuda:
        events = _events(path)
        lost, launches, dev_events = _lost_launches(events)
        last_session.update(launches=launches, lost=len(lost), device_events=dev_events,
                            launch_to_start_us=_launch_to_start_us(events))
        if lost:
            os.replace(path, path + ".lost")
            raise DeviceEventsLost(path, len(lost), launches, dev_events, _lost_detail(events, lost))


def prime_device_tracer() -> None:
    """Open and close one short ``torch.profiler`` session on the card,
    once in the process, unless a session was opened before (or is open).

    On the H100 the traces of a CUDA graph with WHILE nodes that was
    captured before the process's first profiler session held only the
    first pass of each WHILE body: the kernels of every later pass ran out
    of the trace's sight, and the device-busy and idle figures read low.
    A graph captured after a session is traced whole, so the engine calls
    this before it captures a window graph (with no capture in flight in
    the process).  Without CUDA it does nothing."""
    global _tracer_started
    import torch

    if _tracer_started or not torch.cuda.is_available():
        return
    _tracer_started = True
    if torch.autograd.profiler._is_profiler_enabled:  # a session is open: it started the tracer
        return
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        torch.zeros(1, device="cuda").add_(1.0)
        torch.cuda.synchronize()


def annotate(name: str):
    """A named region inside a profiler session (``record_function``); on
    the device timeline it is a ``gpu_user_annotation`` span from its first
    kernel's start to its last kernel's end."""
    import torch

    return torch.profiler.record_function(name)


def profiled_device_ms(fn, n: int, trace_dir: str, ops: int = 0):
    """Run ``fn`` ``n`` times under :func:`profile`; return the device-busy
    milliseconds per call (the kernels', copies' and fills' device time /
    ``n``) and, when ``ops`` > 0, the top kernel rows
    ``[{"op", "ms_per_call", "n"}, ...]``.

    A session that loses device events (:class:`DeviceEventsLost`) is taken
    again, twice at most; :data:`last_profile` says how many sessions it
    took.  Raises ``RuntimeError`` naming ``trace_dir`` when the trace holds
    no device events (the CPU): 0.0 would read as an infinitely fast card.
    """
    shutil.rmtree(trace_dir, ignore_errors=True)
    lost = []
    for session in range(1, 4):
        try:
            with profile(trace_dir):
                for _ in range(n):
                    fn()
            break
        except DeviceEventsLost as e:
            lost.append(e.device_events)
            if session == 3:
                raise
            logger.warning("%s; taking the session again", e)
    last_profile.update(sessions=session, lost=lost)
    reports = device_time_report_multi(trace_dir, BUSY_LINES)
    busy = sum(t for line in BUSY_LINES for t, _ in reports[line].values())
    if not any(reports.values()):
        raise RuntimeError(f"no device events (kernel, gpu_memcpy, gpu_memset) in trace under {trace_dir}")
    avg = busy / n
    if not ops:
        return avg, []
    rows = [
        {"op": k[:90], "ms_per_call": round(t / n, 3), "n": c}
        for k, (t, c) in list(reports["kernel"].items())[:ops]
    ]
    return avg, rows


def busy_union_ms(trace_dir: str) -> float:
    """Milliseconds in which at least one device event (kernel, copy, fill)
    ran, over the traces under ``trace_dir``: the union of their intervals,
    so work that overlaps (several streams, as data-parallel replicas on one
    card run) counts once, where :func:`profiled_device_ms` sums it."""
    spans = sorted(
        (float(ev.get("ts", 0.0)), float(ev.get("ts", 0.0)) + float(ev.get("dur", 0.0)))
        for _, ev in trace_events(trace_dir) if ev.get("cat") in BUSY_LINES
    )
    total, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            total += b - max(a, end)
            end = b
    return total / 1e3


def idle_share(fn, trace_dir: str):
    """Run ``fn`` once under :func:`profile` (through
    :func:`profiled_device_ms`, so a session that lost device events is
    taken again), timed by the host clock between two synchronizes.
    Returns (wall ms, busy ms, idle share, device events, summed ms):
    busy is :func:`busy_union_ms` over every device of the trace, the idle
    share ``1 - busy / wall``, summed the device events' total time
    (summed - busy is the time work overlapped).  Raises ``RuntimeError``
    without device events."""
    import torch

    walls = []
    sync = torch.cuda.synchronize if torch.cuda.is_available() else (lambda: None)

    def timed():
        sync()
        t0 = time.perf_counter()
        fn()
        sync()
        walls.append((time.perf_counter() - t0) * 1e3)

    summed, _ = profiled_device_ms(timed, 1, trace_dir)
    busy = busy_union_ms(trace_dir)
    events = sum(1 for _, ev in trace_events(trace_dir) if ev.get("cat") in BUSY_LINES)
    return walls[-1], busy, 1.0 - busy / walls[-1], events, summed


def device_time_report(trace_dir: str, line: str = "kernel"):
    """Device time by name from the traces under ``trace_dir``:
    ``{name: (total_ms, count)}`` sorted by total time, descending.
    ``line`` is a device category: "kernel" (per kernel),
    "gpu_user_annotation" (per :func:`annotate` region), "gpu_memcpy" or
    "gpu_memset"; any other (a host category) reports nothing."""
    return device_time_report_multi(trace_dir, (line,))[line]


def device_time_report_multi(trace_dir: str, lines):
    """Like :func:`device_time_report` for several lines in ONE parsing
    pass: ``{line: {name: (total_ms, count)}}``.

    A trace of several devices holds each device's own events; the report
    takes the per-name MAX over devices, not the sum (the slowest device's
    time is the call's; a sum would grow with the device count)."""
    lines = tuple(lines)
    # {line: {(path, device): ({name: total_ms}, {name: count})}}
    per_dev: Dict[str, Dict[Any, tuple]] = {ln: {} for ln in lines}
    for path, ev in trace_events(trace_dir):
        cat = ev.get("cat")
        if cat not in per_dev or cat not in DEVICE_LINES:  # host events are not device time
            continue
        key = (path, ev.get("args", {}).get("device", ev.get("pid")))
        t, c = per_dev[cat].setdefault(key, ({}, {}))
        name = ev.get("name", "")
        t[name] = t.get(name, 0.0) + float(ev.get("dur", 0.0)) / 1e3
        c[name] = c.get(name, 0) + 1
    out = {}
    for ln in lines:
        merged: Dict[str, tuple] = {}
        for t, c in per_dev[ln].values():
            for name, total in t.items():
                if name not in merged or total > merged[name][0]:
                    merged[name] = (total, c[name])
        out[ln] = dict(sorted(merged.items(), key=lambda kv: -kv[1][0]))
    return out
