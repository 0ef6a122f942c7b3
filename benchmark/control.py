"""Readings that the limits of ``correct`` are set from.

    python3 benchmark/control.py --config <name> --traffic <batch mix> --seeds 1,2,... [--control-seeds 1,2,3] [--out FILE]

For each seed, in one process: the program serves ``--windows`` windows
of the batch mix's shape on weights and audio drawn from the seed, as a
benchmark run does, and its state is freed; then the reference follows
the served rows, giving the program's reading (the widest gap of a served
token below the reference's best logit, and grammar breaks).  For the
control seeds the control, the reference on an int4 grid where the
configuration states int8, picks its own greedy token at each position of
the same rows and served tokens, and that pick is judged on the
reference's logits the same way.  Benchmark runs never run this.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.join(ROOT, "benchmark")


def served_rows(cfg, mix, seed, device, windows):
    """[(audio row, served tokens)] of ``windows`` windows of the mix's
    rows, served by the program on ``seed``'s weights and audio."""
    from benchmark.harness import audio, program

    engine = program.build_engine(cfg, seed, device)
    B, lang = mix["rows"], cfg["assumed"]["language"]
    rows = audio.rows(seed, windows * B, int(mix["clip_s"] * audio.SAMPLE_RATE), program.window_samples(cfg))
    out = []
    for w in range(windows):
        batch = rows[w * B:(w + 1) * B]
        drs, _ = engine.transcribe_window_fetch(engine.transcribe_window_async(batch, [lang] * B, seed=w))
        out += [(batch[b], drs[b].tokens) for b in range(B) if drs[b] is not None]
    del engine
    return out


def readings(cfg, seed, device, rows, control: bool, tol: float) -> dict:
    """The program's reading on ``rows`` and, with ``control``, the
    control's: the widest gap, grammar breaks, tokens judged and exact."""
    from benchmark.harness import check

    g = check.grammar_of(cfg, device)
    ref = check.reference_of(cfg, seed, device, bits=8)
    ctl = check.reference_of(cfg, seed, device, bits=4) if control else None
    acc = {"program": [], "control": [] if control else None}
    for row, tokens in rows:
        _, logits = check.follow(ref, row, tokens, device)
        acc["program"].append(g.judge_row(logits, tokens, tol))
        if control:
            picks = g.picks(check.follow(ctl, row, tokens, device)[1], tokens)
            acc["control"].append(g.judge_row(logits, tokens, tol, picks=picks))
    return {k: None if js is None else dict(gap=max(j.max_gap for j in js), breaks=sum(j.breaks for j in js),
                                            judged=sum(j.judged for j in js), exact=sum(j.exact for j in js))
            for k, js in acc.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--traffic", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--windows", type=int, default=1)
    ap.add_argument("--device", default="cuda:0")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    sys.path[:] = [ROOT] + [p for p in sys.path if os.path.abspath(p or ".") != HERE]
    from benchmark.run import cache_dirs

    cache_dirs(ROOT)
    import torch

    with open(os.path.join(HERE, "configs", args.config + ".json")) as f:
        cfg = json.load(f)
    with open(os.path.join(HERE, "traffic", args.traffic + ".json")) as f:
        mix = json.load(f)
    with open(os.path.join(HERE, "limits", args.config + ".json")) as f:
        tol = json.load(f)["token_gap"]
    device = torch.device(args.device)
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    results = []
    for s in (int(x) for x in args.seeds.split(",")):
        rows = served_rows(cfg, mix, s, device, args.windows)
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
        r = dict(seed=s, rows=len(rows), **readings(cfg, s, device, rows, s in controls, tol))
        results.append(r)
        print(json.dumps(r), flush=True)
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
