"""Arithmetic of the end-to-end metrics, on stamps the drivers took."""

from __future__ import annotations

import math
from typing import Dict, List, Sequence


def percentile(values: Sequence[float], q: float) -> float:
    """The q-th percentile (0-100) by linear interpolation between the
    closest ranks (numpy's default)."""
    v = sorted(values)
    if not v:
        raise ValueError("no samples")
    x = (len(v) - 1) * q / 100.0
    lo = math.floor(x)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (x - lo)


def audio_rate(rows_audio_s: float, windows: int, t_first_dispatch: float, t_last_fetch: float) -> float:
    """Seconds of audio decoded per second of wall time: the audio of the
    completed windows over the time from the first dispatch to the last
    fetch."""
    return rows_audio_s * windows / (t_last_fetch - t_first_dispatch)


def window_latencies(records: List[Dict], t0: float, t1: float) -> Dict[str, List[float]]:
    """Milliseconds from due to applied and from due to dispatch of every
    stream-window record applied in [t0, t1]; records without first-time
    audio (``due`` None) are not stream-windows a user waits for."""
    lat, wait = [], []
    for r in records:
        if r.get("due") is None or r.get("applied") is None or not t0 <= r["applied"] <= t1:
            continue
        lat.append((r["applied"] - r["due"]) * 1e3)
        wait.append((r["dispatched"] - r["due"]) * 1e3)
    return {"lat_ms": lat, "wait_ms": wait}
