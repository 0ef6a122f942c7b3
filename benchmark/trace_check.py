"""Card checks of the program's own records against the benchmark's
measurements (the program's window and round records,
``norma_tpu_torch.tracing.snapshot()``).

    python3 benchmark/trace_check.py --check marks --seed 7 --seconds 20
    python3 benchmark/trace_check.py --check sum --workload distil-large-v3.batch32 --seed 7 --seconds 20

``marks``: one ``--trace 1`` run of ``distil-large-v3.live``.  The
profiler's trace holds the program's spans (``record_function``s on the
host) and the mark kernels of the window graphs (device events): the
spans give the trace clock's offset from ``perf_counter_ns``, and each
window's start and end marks, mapped onto ``perf_counter_ns`` by the
engine's clock anchor, are compared with their mark kernels' events and
with the ``window_graph`` region around the replay.

``sum``: one run of a batch cell.  Per measured window, its front, loops
and finish (what is left of the window) and the gap to the next window's
start, against the run's fetch-to-fetch ``fetch_gap_ms``; and each
window's mapped marks against its host dispatch and fetch.

Prints one JSON line.  Benchmark runs never run this.
"""

from __future__ import annotations

import argparse
import bisect
import importlib
import json
import os
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.join(ROOT, "benchmark")

SPANS = ("scheduler.drain", "scheduler.dispatch", "scheduler.fetch", "scheduler.apply", "window_dispatch")


def drive(workload: str, seed: int, seconds: float, trace: bool):
    from benchmark import run as bench

    import torch

    spec = bench.load_spec(ROOT, workload)
    r = bench.Run(spec, seed, seconds, trace, torch.device("cuda:0"), time.perf_counter())
    importlib.import_module(f"benchmark.harness.{spec['mix']['kind']}").drive(r)
    return r


def trace_offset_ns(host, spans) -> tuple:
    """(offset, matched): trace ns = perf_counter_ns + offset, from the
    program's spans found among the trace's host events: for each span
    name, each alignment of the trace's first event with a record, the
    one under which most events have a record within 200 us; the offset
    is then the median over those events."""
    best = (0, None)
    for name in SPANS:
        evs = sorted(a * 1e3 for n, a, _ in host if n == name)
        recs = sorted(s["t0"] for s in spans if s["name"] == name)
        if not evs or not recs:
            continue

        def nearest(t):
            i = bisect.bisect_left(recs, t)
            return min(recs[max(0, i - 1):i + 1], key=lambda r: abs(r - t))

        for r0 in recs:
            off = evs[0] - r0
            hits = [d for d in ((e - off) - nearest(e - off) for e in evs) if abs(d) < 200e3]
            if len(hits) > best[0]:
                best = (len(hits), off + statistics.median(hits))
    return best[1], best[0]


def all_threads_profiler():
    """``torch.profiler.profile`` recording the host ops of every thread
    (the scheduler's spans run on its own thread; a session records the
    ops of the thread that opened it only, by default); None where this
    torch has no such setting."""
    import torch
    import torch.profiler as tp

    try:
        config = torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
    except (AttributeError, TypeError):
        return None
    orig = tp.profile

    def profile(*a, **k):
        k.setdefault("experimental_config", config)
        return orig(*a, **k)

    return orig, profile


def check_marks(args) -> dict:
    import torch.profiler as tp

    from benchmark.harness import records

    patch = all_threads_profiler()
    if patch is not None:
        tp.profile = patch[1]  # the harness's session opens it by this name
    try:
        r = drive("distil-large-v3.live", args.seed, args.seconds, True)
    finally:
        if patch is not None:
            tp.profile = patch[0]
    tr = r.data["trace"]
    snap = records.snapshot()
    off, matched = trace_offset_ns(tr.host, snap["spans"])
    if off is None:
        return {"error": "no program span in the trace", "all_threads": patch is not None}
    lo, hi = tr.window
    marks = sorted(a * 1e3 - off for n, a, _ in tr.kernels if "mark_kernel" in n)
    graphs = sorted((a * 1e3 - off, b * 1e3 - off) for a, b in tr.regions.get("window_graph", []))
    out = {"records": {k: len(snap[k]) for k in ("spans", "windows", "rounds", "clocks")}, "dropped": snap["dropped"],
           "spans_matched": matched, "mark_events": len(marks), "window_graph_regions": len(graphs),
           "mark_kernel_us_p50": statistics.median([b - a for n, a, b in tr.kernels if "mark_kernel" in n] or [0]),
           "clock_err_ns": [c["err_ns"] for c in snap["clocks"]], "windows": []}
    near = lambda t, pool: min(pool, key=lambda p: abs(p - t)) if pool else None  # noqa: E731
    for w in snap["windows"]:
        if not w.get("graph"):
            continue
        s, e = records.region(w, "window")
        if not (lo * 1e3 - off <= s and e <= hi * 1e3 - off):
            continue
        ms, me = near(s, marks), near(e, marks)
        g = near(s, [a for a, _ in graphs])
        ge = next((b for a, b in graphs if a == g), None)
        out["windows"].append(dict(since_anchor_s=(s - snap["clocks"][0]["t1"]) / 1e9,
                                   start_vs_kernel_us=(s - ms) / 1e3, end_vs_kernel_us=(e - me) / 1e3,
                                   start_vs_region_us=None if g is None else (s - g) / 1e3,
                                   end_vs_region_us=None if ge is None else (e - ge) / 1e3))
    ws = out["windows"]
    for k in ("start_vs_kernel_us", "end_vs_kernel_us", "start_vs_region_us", "end_vs_region_us"):
        v = [abs(x[k]) for x in ws if x[k] is not None]
        out[k + "_max_abs"] = max(v) if v else None
    out["within_50us"] = bool(ws) and all(
        abs(x[k]) <= 50 for x in ws for k in ("start_vs_kernel_us", "end_vs_kernel_us", "start_vs_region_us",
                                               "end_vs_region_us") if x[k] is not None)
    return out


def check_sum(args) -> dict:
    from benchmark.harness import records

    r = drive(args.workload, args.seed, args.seconds, False)
    ws = records.batch_windows(r)
    if ws is None:
        return {"error": "no measured graph windows"}
    parts = []
    for a, b in zip(ws, ws[1:]):
        w0, w1 = records.region(a, "window")
        front = records.region(a, "window_front")[1] - w0
        loops = sum(y - x for n, x, y in a["regions"] if n == "token_loop")
        gap = records.region(b, "window")[0] - w1
        parts.append(dict(front=front / 1e6, loops=loops / 1e6, finish=(w1 - w0 - front - loops) / 1e6,
                          gap=gap / 1e6, period=(records.region(b, "window")[0] - w0) / 1e6))
    mean = {k: statistics.fmean(p[k] for p in parts) for k in parts[0]}
    p50 = r.extra["fetch_gap_ms"]["p50"]
    late = [w for w in ws if records.region(w, "window")[0] < w["dispatch"][0]
            or records.region(w, "window")[1] > w["fetched"]]
    return {"windows": len(ws), "mean_ms": mean, "sum_ms": mean["front"] + mean["loops"] + mean["finish"] + mean["gap"],
            "fetch_gap_p50_ms": p50, "off_pct": 100.0 * (mean["period"] - p50) / p50,
            "marks_outside_dispatch_to_fetch": len(late), "audio_s_per_s": r.e2e["audio_s_per_s"]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--check", choices=("marks", "sum"), required=True)
    ap.add_argument("--workload", default="distil-large-v3.batch32")
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    args = ap.parse_args()
    sys.path[:] = [ROOT] + [p for p in sys.path if os.path.abspath(p or ".") != HERE]
    from benchmark import run as bench

    bench.cache_dirs(ROOT)
    out = check_marks(args) if args.check == "marks" else check_sum(args)
    out.update(check=args.check, workload=args.workload if args.check == "sum" else "distil-large-v3.live",
               seed=args.seed, seconds=args.seconds)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
