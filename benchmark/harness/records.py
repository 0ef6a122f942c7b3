"""The program's own records (``norma_tpu_torch.tracing.snapshot()``) of
the measured window, shared by the per-layer metrics that read them.  A
program without the records (an older checkout) gives None, as does a
store that let records of the window go, or holds another count of them
than the run counted."""

from __future__ import annotations

from typing import List, Optional


def snapshot() -> Optional[dict]:
    try:
        from norma_tpu_torch import tracing
    except ImportError:
        return None
    snap = getattr(tracing, "snapshot", None)
    return snap() if snap is not None else None


def region(window: dict, name: str) -> Optional[list]:
    """``[start, end]`` of the window's first region ``name`` (ns)."""
    for r in window.get("regions") or ():
        if r[0] == name:
            return r[1:]
    return None


def batch_windows(run) -> Optional[List[dict]]:
    """The measured windows of a batch run: the graph windows after the
    mix's ``warm_windows`` (the eager traced window is no graph window),
    each with its window and front regions; None unless there are as many
    as the run counted and the store let none go."""
    snap = snapshot()
    n = run.data.get("windows")
    if snap is None or not n or snap["dropped"]:
        return None
    graph = [w for w in snap["windows"] if w.get("graph")]
    warm = run.mix["warm_windows"]
    measured = graph[warm:warm + n]
    if len(measured) != n or any(region(w, "window") is None or region(w, "window_front") is None
                                 for w in measured):
        return None
    return measured


def window_ns(run):
    """The live run's measured window, [t0, t1] on ``perf_counter_ns``."""
    t0, t1 = run.data.get("t0"), run.data.get("t1")
    return None if t0 is None or t1 is None else (int(t0 * 1e9), int(t1 * 1e9))


def live_rounds(run, snap: Optional[dict] = None) -> Optional[List[dict]]:
    """The rounds dispatched in the live run's measured window, each with
    one window record; None when the store may have let some go."""
    snap = snap or snapshot()
    span = window_ns(run)
    if snap is None or span is None:
        return None
    t0, t1 = span
    if snap["dropped"] and (snap["kept_from_ns"] is None or snap["kept_from_ns"] > t0):
        return None
    rounds = [r for r in snap["rounds"] if t0 <= r["dispatch"][0] <= t1]
    if not rounds or any(len(r.get("windows") or ()) != 1 or region(r["windows"][0], "window") is None
                         for r in rounds):
        return None
    return rounds
