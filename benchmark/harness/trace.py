"""Device traces: a ``torch.profiler`` session over the enclosed work, read
back into device intervals, kernel events by name and the program's
named regions.

The session's Chrome trace goes to a directory made with
``tempfile.mkdtemp()`` (under ``TMPDIR``) and is deleted once read.  On
the card the session takes a warm-up step before it records (256 small
kernels under a profiler schedule of one warm-up and one active step):
sessions on the H100 have come back without the device events of their
first kernels when they recorded from their start.

Event categories read: ``kernel``, ``gpu_memcpy`` and ``gpu_memset`` are
device-busy time; ``gpu_user_annotation`` spans are the device extent of
the program's named regions (``window_graph``, ``window_front``, ...);
host events (``cpu_op``, ``cuda_runtime``, ``user_annotation``, ...) say
what the host did while the device was idle.
"""

from __future__ import annotations

import bisect
import contextlib
import json
import os
import shutil
import tempfile
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

BUSY = ("kernel", "gpu_memcpy", "gpu_memset")
HOST = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation", "python_function")

Span = Tuple[float, float]  # (start, end) in microseconds


@dataclass
class Trace:
    """What a session held, times in microseconds on the trace's clock."""

    busy: List[Span] = field(default_factory=list)  # device events, sorted by start
    kernels: List[Tuple[str, float, float]] = field(default_factory=list)  # (name, start, end)
    regions: Dict[str, List[Span]] = field(default_factory=dict)  # device spans by region name
    host: List[Tuple[str, float, float]] = field(default_factory=list)
    window: Span = (0.0, 0.0)  # the recorded step's host extent

    @classmethod
    def from_events(cls, events: List[dict], step_name: Optional[str] = None) -> "Trace":
        t = cls()
        steps = []
        for e in events:
            if e.get("ph") != "X":
                continue
            cat, name = e.get("cat"), str(e.get("name", ""))
            a = float(e.get("ts", 0.0))
            b = a + float(e.get("dur", 0.0))
            if cat in BUSY:
                t.busy.append((a, b))
                if cat == "kernel":
                    t.kernels.append((name, a, b))
            elif cat == "gpu_user_annotation":
                t.regions.setdefault(name, []).append((a, b))
            elif cat in HOST:
                t.host.append((name, a, b))
                if step_name is not None and name.startswith(step_name):
                    steps.append((a, b))
        t.busy.sort()
        t.kernels.sort(key=lambda k: k[1])
        if steps:
            t.window = (min(s for s, _ in steps), max(e for _, e in steps))
        elif t.busy:
            t.window = (t.busy[0][0], max(e for _, e in t.busy))
        return t

    def busy_union_us(self, lo: float = float("-inf"), hi: float = float("inf")) -> float:
        """Microseconds in [lo, hi) in which some device event ran
        (overlapping events counted once)."""
        return sum(b - a for a, b in union(self.busy, lo, hi))

    def kernel_time_us(self, needle: str) -> Tuple[int, float]:
        """(events, summed microseconds) of the kernels whose name holds
        ``needle``."""
        hits = [b - a for n, a, b in self.kernels if needle in n]
        return len(hits), sum(hits)

    def first_kernel(self, needle: str, lo: float, hi: float) -> Optional[float]:
        for n, a, _ in self.kernels:
            if lo <= a < hi and needle in n:
                return a
        return None

    def top_kernels(self, k: int = 10) -> List[List]:
        by: Dict[str, float] = {}
        for n, a, b in self.kernels:
            by[n] = by.get(n, 0.0) + (b - a)
        return [[n, s / 1e6] for n, s in sorted(by.items(), key=lambda kv: -kv[1])[:k]]

    def idle_by_host(self, k: int = 10, longest: int = 500) -> List[List]:
        """The device's idle gaps inside the window: the ``longest`` gaps
        summed by the innermost host event running at each gap's middle
        ("host idle" where none was), the shorter ones summed as one entry."""
        lo, hi = self.window
        gaps, prev = [], lo
        for a, b in union(self.busy, lo, hi):
            if a > prev:
                gaps.append((prev, a))
            prev = max(prev, b)
        if hi > prev:
            gaps.append((prev, hi))
        gaps.sort(key=lambda g: g[0] - g[1])
        host = sorted(self.host, key=lambda h: h[1])
        starts = [h[1] for h in host]
        by: Dict[str, float] = {}
        for a, b in gaps[:longest]:
            mid = 0.5 * (a + b)
            i = bisect.bisect_right(starts, mid)
            inner = [h for h in host[max(0, i - 300):i] if h[2] >= mid]
            name = min(inner, key=lambda h: h[2] - h[1])[0][:120] if inner else "host idle"
            by[name] = by.get(name, 0.0) + (b - a)
        if len(gaps) > longest:
            by[f"{len(gaps) - longest} shorter gaps"] = sum(b - a for a, b in gaps[longest:])
        return [[n, s / 1e6] for n, s in sorted(by.items(), key=lambda kv: -kv[1])[:k]]


def union(spans: List[Span], lo: float = float("-inf"), hi: float = float("inf")) -> List[Span]:
    """Sorted ``spans`` clipped to [lo, hi) and merged where they overlap."""
    out: List[list] = []
    for a, b in spans:
        a, b = max(a, lo), min(b, hi)
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


STEP = "benchmark_traced"


@contextlib.contextmanager
def session(result: list, settle=None, host: bool = True):
    """Trace the enclosed work on the card; appends the :class:`Trace` to
    ``result`` when the block ends.  The trace's window is the block;
    ``settle()``, where given, runs after it, before the session stops.
    ``host=False`` records the device alone (no host events, a third of
    the trace of an eager window): the window is then the device's
    extent."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function, schedule

    d = tempfile.mkdtemp(prefix="benchmark_trace_")
    try:
        torch.cuda.synchronize()
        activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA] if host else [ProfilerActivity.CUDA]
        with profile(activities=activities,
                     schedule=schedule(wait=0, warmup=1, active=1)) as prof:
            x = torch.zeros(1, device="cuda")
            for _ in range(256):
                x.add_(1.0)
            torch.cuda.synchronize()
            prof.step()
            with record_function(STEP):
                yield
                if settle is None:
                    torch.cuda.synchronize()
            if settle is not None:
                settle()
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        del prof
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
        result.append(Trace.from_events(events, STEP))
    finally:
        shutil.rmtree(d, ignore_errors=True)
