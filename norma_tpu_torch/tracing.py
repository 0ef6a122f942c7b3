"""Structured spans, the program's own records, and the device report
(``norma_tpu/tracing.py``).

  - ``span`` / ``instrument`` — timed spans: each is a record in the
    process's store (name, start and end on ``time.perf_counter_ns()``,
    its id, its parent span on the same thread, its fields), a
    ``record_function`` while a ``torch.profiler`` session is open (so the
    Chrome trace holds the program's spans on the clock of its kernel
    events), and a ``logging`` line when the logger is enabled for its
    level
  - ``region`` — a named region of a window: device time marks
    (``%globaltimer``, one single-thread kernel each, inside a captured
    window graph or launched eagerly) at its start and end on CUDA, host
    stamps on the CPU, where a window's :class:`Marks` collects them
    (``marking``); a ``record_function`` while a session is open, outside
    a capture; ``clock_anchor`` maps a card's marks onto
    ``perf_counter_ns``
  - ``record`` / ``snapshot`` — the store: a bounded deque of span,
    window, round and clock records (``STORE_RECORDS``; ``dropped`` counts
    what it let go), and a copy of it by kind.  ``NORMA_TPU_TORCH_TRACE=0``
    in the environment, read once at import, turns the records and the
    device marks off
  - ``decode_telemetry`` — the reference's per-decode trace fields
    (at_temp, logprob, no_speech_prob)
  - ``profile`` / ``annotate`` — a ``torch.profiler`` session over a
    region (CPU and CUDA activity, a Chrome trace per session under
    ``log_dir``) and named regions inside it (``annotate`` is ``region``)
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
each :func:`region` opened outside a capture) that of "XLA Modules"; ``"gpu_memcpy"`` and
``"gpu_memset"`` are the copies and fills.  Host events are ignored.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import glob
import inspect
import itertools
import json
import logging
import os
import shutil
import socket
import sys
import tempfile
import threading
import time
from typing import Any, Dict, List, Optional

logger = logging.getLogger("norma_tpu_torch")

# Whether the program records spans, windows and rounds and writes device
# marks: read once, at import.
ENABLED = os.environ.get("NORMA_TPU_TORCH_TRACE", "1") != "0"
# The store holds this many records, the newest: a 51 s live run of 22
# streams makes a few thousand.
STORE_RECORDS = 1 << 16

_store: collections.deque = collections.deque(maxlen=STORE_RECORDS)
_store_lock = threading.Lock()
_dropped = 0
_ids = itertools.count(1)
_local = threading.local()  # per thread: the open spans' ids, the window's marks


def _append(rec: Dict[str, Any]) -> None:
    global _dropped
    with _store_lock:
        if len(_store) == _store.maxlen:
            _dropped += 1
        _store.append(rec)


def record(kind: str, **fields: Any) -> Dict[str, Any]:
    """Append one record ``{"kind": kind, **fields}`` to the store (when
    recording is on) and return it; the store lets its oldest record go
    when full, and counts it in ``dropped``.  ``kind`` is "window",
    "round" or "clock" (spans record themselves)."""
    rec = {"kind": kind, **fields}
    if ENABLED:
        _append(rec)
    return rec


def snapshot(since_ns: Optional[int] = None) -> Dict[str, Any]:
    """A copy of the store: ``{"spans", "windows", "rounds", "clocks"}``
    (lists of records, oldest first, those that ended at or after
    ``since_ns`` when given), ``dropped`` (records the store let go since
    the process began) and ``kept_from_ns`` (the end of the oldest record
    it holds, None when empty: a reader's span that starts before it may
    have lost records when ``dropped`` > 0).  Every record has ``t0`` and
    ``t1``, on ``perf_counter_ns``."""
    with _store_lock:
        recs, dropped = list(_store), _dropped
    out: Dict[str, Any] = {"spans": [], "windows": [], "rounds": [], "clocks": []}
    for r in recs:
        if since_ns is None or r["t1"] >= since_ns:
            out[r["kind"] + "s"].append(r)
    out["dropped"] = dropped
    out["kept_from_ns"] = recs[0]["t1"] if recs else None
    return out


def _profiling() -> bool:
    """Whether a ``torch.profiler`` session is open (torch loaded)."""
    t = sys.modules.get("torch")
    return t is not None and t.autograd.profiler._is_profiler_enabled


def _annotation(name: str):
    """An entered ``record_function`` while a profiler session is open and
    this thread's stream is not capturing a CUDA graph (inside a capture it
    would record nothing at replay), else None."""
    if not _profiling():
        return None
    import torch

    if torch.cuda.is_available() and torch.cuda.is_current_stream_capturing():
        return None
    rf = torch.profiler.record_function(name)
    rf.__enter__()
    return rf


class _Span:
    __slots__ = ("rec", "level", "log", "rf")

    def __init__(self, name: str, level: int, fields: Dict[str, Any]):
        self.rec = {"kind": "span", "name": name, "id": 0, "parent": None, "t0": 0, "t1": 0, "fields": fields}
        self.level = level

    def __enter__(self):
        rec = self.rec
        self.log = logger.isEnabledFor(self.level)
        if self.log:
            logger.log(self.level, "%s enter %s", rec["name"], rec["fields"] if rec["fields"] else "")
        self.rf = _annotation(rec["name"])
        stack = getattr(_local, "spans", None)
        if stack is None:
            stack = _local.spans = []
        rec["id"] = sid = next(_ids)
        rec["parent"] = stack[-1] if stack else None
        stack.append(sid)
        rec["t0"] = time.perf_counter_ns()
        return rec

    def __exit__(self, typ, e, tb):
        rec = self.rec
        rec["t1"] = t1 = time.perf_counter_ns()
        stack = _local.spans
        if stack and stack[-1] == rec["id"]:
            stack.pop()
        elif rec["id"] in stack:  # spans of interleaved coroutines on one thread
            stack.remove(rec["id"])
        if self.rf is not None:
            self.rf.__exit__(typ, e, tb)
        ms = (t1 - rec["t0"]) / 1e6
        if e is not None and isinstance(e, Exception):
            rec["error"] = repr(e)
            logger.log(logging.ERROR, "%s error after %.3fms: %r", rec["name"], ms, e)
        elif self.log:
            logger.log(self.level, "%s exit %.3fms", rec["name"], ms)
        if ENABLED:
            _append(rec)
        return False


def span(name: str, level: int = logging.DEBUG, **fields: Any):
    """A timed, structured span (module docstring): a context manager that
    yields its record (``t0`` set on entry, ``t1`` on exit).  It logs its
    entry fields and exit duration when the logger is enabled for
    ``level``; errors are logged at ERROR level with the elapsed time and
    kept in the record (``error``)."""
    return _Span(name, level, fields)


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
            if fields and logger.isEnabledFor(level):
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

        def traced() -> bool:
            return ENABLED or logger.isEnabledFor(level) or _profiling()

        if inspect.iscoroutinefunction(fn):  # the span covers the awaited call

            @functools.wraps(fn)
            async def awrapper(*args, **kwargs):
                if not traced():
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
            if not traced():
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


def device_mark(slot) -> None:
    """Write the card's ``%globaltimer`` (ns) into ``slot`` (one int64 on
    the card) by a one-thread kernel on the current stream
    (``csrc/mark.cu``); ``device_mark.launches`` counts its launches."""
    from .ops import _build

    _build.launch("norma_mark", device_mark, slot.device, slot.data_ptr())


device_mark.launches = 0


class Marks:
    """One window's time marks, in the order its regions open and close
    (``names``: ``(region, 0 at its start | 1 at its end)``).  On a card
    each mark is :func:`device_mark` into the next of ``slots`` (int64 on
    the card, inside a graph's capture or eagerly), read after the window
    and mapped by :func:`clock_anchor`; with ``slots`` None each is the
    host's ``perf_counter_ns()``, in ``host``."""

    def __init__(self, slots=None):
        self.slots = slots
        self.names: List[tuple] = []
        self.host: List[int] = []

    def mark(self, name: str, edge: int) -> None:
        i = len(self.names)
        if self.slots is None:
            self.host.append(time.perf_counter_ns())
        elif i >= self.slots.numel():
            raise RuntimeError(f"a window has more than {self.slots.numel()} time marks")
        else:
            device_mark(self.slots[i:i + 1])
        self.names.append((name, edge))


@contextlib.contextmanager
def marking(marks: Optional[Marks]):
    """Within the block this thread's :func:`region` calls mark ``marks``
    (nothing is marked with recording off)."""
    prev = getattr(_local, "marks", None)
    _local.marks = marks if ENABLED else None
    try:
        yield marks
    finally:
        _local.marks = prev


class region:
    """A named region of the program: its start and end marked into the
    thread's window :class:`Marks` (:func:`marking`), where one is set; a
    ``record_function`` while a profiler session is open and the stream is
    not capturing, so an eager window's trace holds it as a
    ``gpu_user_annotation`` span from its first kernel's start to its last
    kernel's end."""

    __slots__ = ("name", "marks", "rf")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.rf = _annotation(self.name)
        self.marks = getattr(_local, "marks", None)
        if self.marks is not None:
            self.marks.mark(self.name, 0)
        return self

    def __exit__(self, typ, e, tb):
        if self.marks is not None and e is None:
            self.marks.mark(self.name, 1)
        if self.rf is not None:
            self.rf.__exit__(typ, e, tb)
        return False


# The JAX package's name for a named region.
annotate = region


def regions(names, times) -> List[list]:
    """``[name, start, end]`` of each region from a window's marks
    (:attr:`Marks.names` and their times), in the order the regions
    started; a region left open has no entry."""
    out, open_ = [], {}
    for (name, edge), t in zip(names, times):
        if edge == 0:
            open_.setdefault(name, []).append(len(out))
            out.append([name, int(t), None])
        elif open_.get(name):
            out[open_[name].pop()][2] = int(t)
    return [r for r in out if r[2] is not None]


def clock_anchor(device, tries: int = 5) -> Dict[str, Any]:
    """The offset that maps the card's ``%globaltimer`` onto
    ``perf_counter_ns`` (host = device + ``offset_ns``), from ``tries``
    marks each launched on a stream of its own and waited for: the host's
    times before the launch and after the wait bracket the mark, the
    offset is the midpoint of the tightest bracket and ``err_ns`` half its
    width.  Kept in the store as a "clock" record and returned."""
    import torch

    slot = torch.zeros(1, dtype=torch.int64, device=device)
    stream = torch.cuda.Stream(device=device)
    best = None
    with torch.cuda.stream(stream):
        device_mark(slot)  # the first launch loads the kernel
        stream.synchronize()
        for _ in range(tries):
            h0 = time.perf_counter_ns()
            device_mark(slot)
            stream.synchronize()
            h1 = time.perf_counter_ns()
            g = int(slot.item())
            if best is None or h1 - h0 < best[1] - best[0]:
                best = (h0, h1, g)
    h0, h1, g = best
    return record("clock", device=str(device), offset_ns=(h0 + h1) // 2 - g, err_ns=(h1 - h0 + 1) // 2,
                  t0=h0, t1=h1)


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
