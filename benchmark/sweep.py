"""Find a mix's operating point by a sweep on the card.

    python3 benchmark/sweep.py --config <name> --traffic live --streams 16,20,24 --seconds 20 --seed 7
    python3 benchmark/sweep.py --config <name> --traffic batch32 --rows 8,16,32,64 --seconds 12 --seed 7

``live``: the knee, the most streams served with no audio dropped and the
95th-percentile latency at or under ``--limit-ms``.  One engine serves
each stream count in turn (``harness/live.py::serve``), its scheduler with
the smallest power of two of slots at or above the count; the mix's file
then takes 4/5 of the knee, rounded down, and the knee's slots.

``batch``: the audio rate and the serving window's memory peak at each
batch size (``harness/batch.py::serve``), one engine for all.

Prints one JSON line per point and a last summary line.  Benchmark runs
never run this.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.join(ROOT, "benchmark")


def slots(n: int) -> int:
    b = 1
    while b < n:
        b *= 2
    return b


def live_points(engine, cfg, mix, args):
    from benchmark.harness import live, stats

    points, knee = [], None
    for n in (int(x) for x in args.streams.split(",")):
        m = dict(mix, streams=n, max_streams=slots(n))
        out = live.serve(engine, cfg, m, args.seed, args.seconds)
        lat, rounds = out["lat_ms"], out["rounds"]
        p = dict(streams=n, max_streams=m["max_streams"], windows=len(lat),
                 lat_p50_ms=stats.percentile(lat, 50) if lat else None,
                 lat_p95_ms=stats.percentile(lat, 95) if lat else None,
                 wait_p95_ms=stats.percentile(out["wait_ms"], 95) if lat else None,
                 audio_drops=out["audio_drops"], rounds=len(rounds),
                 mean_B=sum(r["B"] for r in rounds) / max(len(rounds), 1),
                 mean_active=sum(r["n_active"] for r in rounds) / max(len(rounds), 1),
                 feeder_late_ms=out["feeder_late_ms"])
        points.append(p)
        print(json.dumps(p), flush=True)
        if p["audio_drops"] == 0 and p["lat_p95_ms"] is not None and p["lat_p95_ms"] <= args.limit_ms:
            knee = n
    return dict(knee=knee, streams=None if knee is None else int(0.8 * knee),
                max_streams=None if knee is None else slots(knee), points=points)


def batch_points(engine, cfg, mix, args):
    from benchmark.harness import batch

    points = []
    for B in (int(x) for x in args.rows.split(",")):
        out = batch.serve(engine, cfg, dict(mix, rows=B), args.seed, args.seconds)
        p = dict(rows=B, **{k: out[k] for k in ("audio_s_per_s", "windows", "wall_ms", "steps", "fetch_gap_ms")},
                 window_peak_gib=out["window_peak"] / 2**30, setup_peak_gib=out["setup_peak"] / 2**30)
        del out
        points.append(p)
        print(json.dumps(p), flush=True)
    best = max(points, key=lambda p: p["audio_s_per_s"])
    return dict(best_rows=best["rows"], points=points)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--traffic", default="live")
    ap.add_argument("--streams", default="")
    ap.add_argument("--rows", default="")
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--limit-ms", type=float, default=1200.0)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    sys.path[:] = [ROOT] + [p for p in sys.path if os.path.abspath(p or ".") != HERE]
    from benchmark.run import cache_dirs

    cache_dirs(ROOT)
    from benchmark.harness import program

    with open(os.path.join(HERE, "configs", args.config + ".json")) as f:
        cfg = json.load(f)
    with open(os.path.join(HERE, "traffic", args.traffic + ".json")) as f:
        mix = json.load(f)
    engine = program.build_engine(cfg, args.seed, "cuda:0")
    res = (batch_points if mix["kind"] == "batch" else live_points)(engine, cfg, mix, args)
    print(json.dumps({k: v for k, v in res.items() if k != "points"}), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
