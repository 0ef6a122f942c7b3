"""Multi-stream serving soak (the port of ``tools/soak_serving.py``): N
real-time streams for M minutes through ``BatchedTranscriber``, with
liveness and loss assertions and periodic metrics.

Streams run at REAL TIME for minutes, so scheduler rounds, admission,
retirement and channel backpressure all cycle many times, and host memory
growth would show.  Exit code 0 (and ``SOAK PASS``) means every assertion
held:

  - every stream terminated, and all but a small allowance produced output
  - zero transcript drops and zero audio-chunk drops (the lossy paths must
    not fire when receivers drain promptly)
  - RSS growth under ``--rss-budget-mb`` (default 256 MB) after the first
    wave
  - with ``--target-p99-ms``, the measured ready->applied p99 within 1.3x
    of the target

Model on the card: distil-large-v3 at ``max_target_positions=136`` with an
unreachable EOT id, ``init_params(seed=0)`` in bf16 with fused QKV (the
JAX package's soak and bench latency model).  ``--cpu``: a tiny seeded
model with a peaked decoder softmax (the final LayerNorm gain scaled by 8)
and EOT suppressed, so greedy rung-0 decodes emit text.

Run on the card:          python -m norma_tpu_torch.tools.soak_serving --minutes 3
Self-test on the CPU:     python -m norma_tpu_torch.tools.soak_serving --cpu --minutes 0.2
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import threading
import time
from typing import List

# The CPU self-test's tiny vocabulary (1000 tokens): text 0..899, then
# <|endoftext|> 900, <|startoftranscript|> 901, three languages 902..904,
# tasks 905/906, <|nospeech|> 907, <|notimestamps|> 940 and the timestamps
# 941..999.
TINY_ST = dict(sot=901, eot=900, task=905, no_speech=907, no_timestamps=940, zero_sec=941, one_sec=991)
TINY_LANG_IDS = [902, 903, 904]
TINY_CFG = dict(
    num_mel_bins=80, vocab_size=1000, d_model=64, encoder_layers=2, encoder_attention_heads=2,
    decoder_layers=2, decoder_attention_heads=2, max_source_positions=32, max_target_positions=48,
    suppress_tokens=(0, 5, 9, 907, 900),  # EOT unreachable: greedy runs to the length cap
)
# distil-large-v3's token layout with an unreachable EOT id.
CARD_ST = dict(sot=50258, eot=-1, task=50360, no_speech=50363, no_timestamps=50364, zero_sec=50365,
               one_sec=50415)


def rss_mb() -> float:
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) / 1024.0
    return 0.0


class _TinyTokenizer:
    """Text ids decode as " w<id>"; special ids decode to nothing."""

    def decode(self, ids: List[int], skip_special_tokens: bool = True) -> str:
        return "".join(f" w{i}" for i in ids if 0 <= i < 900)


class _NullTok:
    def decode(self, ids, skip_special_tokens=True):
        return " ".join(str(i) for i in ids) or "."


def build_model(cpu: bool):
    """The soak's WhisperModel: the tiny texty model on the CPU, the
    distil-large-v3 latency model on the card."""
    import torch

    from ..decode import DecodeEngine, LanguageState
    from ..decode.masks import SpecialTokens
    from ..model import PRESETS, WhisperConfig, fuse_qkv, init_params
    from ..models.whisper.model import WhisperModel

    if cpu:
        cfg = WhisperConfig(**TINY_CFG)
        params = init_params(cfg, seed=3, device="cpu")
        params["decoder"]["ln_g"].mul_(8.0)  # a peaked softmax: rung 0 passes the gate
        engine = DecodeEngine(params, cfg, SpecialTokens(**TINY_ST), language_token_ids=TINY_LANG_IDS)
        return WhisperModel(engine, _TinyTokenizer(), LanguageState(const=TINY_LANG_IDS[0]))
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --cpu for the CPU self-test")
    # The JAX package's soak model (its bench's latency arm): distil dims at
    # mtp=136 with an unreachable EOT id and plain seed-0 weights.  Every
    # window decodes the full 132 tokens, whose random stream is dense in
    # timestamp boundaries, so every stream emits drainable segments: the
    # empty-output gate measures plumbing, not model luck.
    cfg = PRESETS["distil-large-v3"].with_(max_target_positions=136)
    params = fuse_qkv(init_params(cfg, seed=0, dtype=torch.bfloat16, device=torch.device("cuda", 0)))
    engine = DecodeEngine(params, cfg, SpecialTokens(**CARD_ST))
    return WhisperModel(engine, _NullTok(), LanguageState(const=50259))


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--minutes", type=float, default=3.0)
    ap.add_argument("--streams", type=int, default=8)
    ap.add_argument("--cpu", action="store_true",
                    help="tiny seeded model on the CPU (hermetic self-test)")
    ap.add_argument("--rss-budget-mb", type=float,
                    default=float(os.environ.get("SOAK_RSS_BUDGET_MB", 256)))
    ap.add_argument("--no-pipeline", action="store_true",
                    help="disable round pipelining (latency A/B control)")
    ap.add_argument("--target-p99-ms", type=float, default=None,
                    help="ready->applied SLA: auto-size rounds from the "
                         "cost EMA and ASSERT the measured p99 at exit")
    ap.add_argument("--first-partial", type=float, default=None,
                    help="early first-chunk flush (seconds)")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    """Run the soak; returns its summary (streams, RSS growth, the final
    ``metrics()``) after printing ``SOAK PASS``."""
    args = parse_args(argv)

    from ..audio.sources import SyntheticSource
    from ..input import Settings
    from ..runtime.batching import BatchedTranscriber

    model = build_model(args.cpu)
    bt = BatchedTranscriber(
        model, max_streams=args.streams,
        target_p99_ms=args.target_p99_ms,
        first_partial_seconds=args.first_partial,
    )
    if args.no_pipeline:
        bt.pipeline_rounds = False
        print("# round pipelining DISABLED (A/B control)", flush=True)
    # Warm EVERY batch bucket the scheduler can dispatch (bt.warmup, not
    # model.warmup): a bucket's first use mid-wave (graph captures,
    # allocator growth) would stall real-time sources into ring overflow.
    bt.warmup()
    captures0 = model.engine.graph_captures
    deadline = time.monotonic() + args.minutes * 60.0
    results = {}
    threads = []
    started = 0
    rss0 = None
    lock = threading.Lock()

    def drain(tag, handle):
        segs = list(handle.receiver)
        with lock:
            results[tag] = segs

    print(f"# soak: {args.streams} streams, {args.minutes} min, "
          f"{'tiny/cpu' if args.cpu else 'distil-large-v3'}", flush=True)
    wave = 0
    while time.monotonic() < deadline:
        handles = []
        # Streams live ~20 s real time each wave (3 s for the CPU
        # self-test) so retirement/admission cycles repeatedly.
        dur = 3.0 if args.cpu else 20.0
        dur = min(dur, max(2.0, deadline - time.monotonic()))
        for i in range(args.streams):
            # Non-repeating frequency sweep: 17 is coprime to 391, so every
            # stream in a soak gets a distinct tone in 220-611 Hz.
            h = bt.blocking_start(Settings(source=SyntheticSource(
                sample_rate=16_000, channels=1, duration=dur,
                freq=220.0 + (17.0 * (started + i)) % 391.0, realtime=True,
            )))
            handles.append(h)
            started += 1
        for i, h in enumerate(handles):
            t = threading.Thread(target=drain, args=(f"w{wave}s{i}", h), daemon=True)
            t.start()
            threads.append(t)
        for t in threads:
            t.join(timeout=dur * 4 + 120)
        stuck = [t for t in threads if t.is_alive()]
        assert not stuck, f"{len(stuck)} drain threads stuck in wave {wave}"
        threads.clear()
        if rss0 is None:
            rss0 = rss_mb()  # after the first wave: captures and caches warm
        m = bt.metrics()
        print(f"# wave {wave}: {started} streams total, rss {rss_mb():.0f} MB, metrics {m}", flush=True)
        wave += 1

    m = bt.metrics()
    bt.close()
    # CUDA graphs the live rounds captured: keys bt.warmup() did not reach.
    captures = model.engine.graph_captures - captures0
    grew = rss_mb() - (rss0 or rss_mb())
    empty = [tag for tag, segs in results.items() if not segs]
    print(f"# done: {started} streams, {len(results)} drained, "
          f"rss growth {grew:.0f} MB, graph captures after warmup {captures}, metrics {m}", flush=True)
    assert len(results) == started, (len(results), started)
    # "No output" is a legitimate outcome for a window that fails the
    # avg_logprob gate at every temperature (the reference returns None and
    # drains the slice, model.rs:188-190).  Plumbing faults (lost channels,
    # deadlocks, starvation) empty out WHOLE waves, so a small fraction is
    # allowed, not zero.
    allowed_empty = max(1, started // 20)
    assert len(empty) <= allowed_empty, (
        f"{len(empty)}/{started} streams with no output "
        f"(> {allowed_empty} allowance for gated windows): {empty[:8]}"
    )
    assert m["transcript_drops"] == 0, m
    assert m["audio_drops"] == 0, m
    if args.target_p99_ms:
        # The measured ready->applied p99 must honor the target; 30% slack
        # covers the calibration rounds at the start of the run (buckets
        # without an EMA are allowed optimistically until measured once).
        ra = m["latency"]["ready_to_applied"]
        assert ra is not None, "no ready->applied samples recorded"
        assert ra["p99_ms"] <= args.target_p99_ms * 1.3, (
            f"SLA violated: ready->applied p99 {ra['p99_ms']} ms vs "
            f"target {args.target_p99_ms} ms (cost model: "
            f"{m['round_cost_ema_ms']}, cap {m['sla']['round_cap']})"
        )
        print(f"# SLA held: p99 {ra['p99_ms']} ms <= {args.target_p99_ms} * 1.3 ms", flush=True)
    assert grew < args.rss_budget_mb, (
        f"RSS grew {grew:.0f} MB (> {args.rss_budget_mb:.0f} budget) — "
        "possible leak across stream churn"
    )
    # Latency under churn: ready_to_applied is the scheduler queueing +
    # round latency; admit_to_first_partial spans capture + first window
    # fill + first round.
    lat = m["latency"]
    print(f"# latency: {json.dumps(lat)}", flush=True)
    assert lat["ready_to_applied"] and lat["ready_to_applied"]["n"] > 0, (
        "soak ran decode rounds but recorded no ready->applied latency"
    )
    print("SOAK PASS", flush=True)
    return {"streams": started, "waves": wave, "rss_growth_mb": grew, "empty": len(empty),
            "graph_captures_after_warmup": captures, "metrics": m}


if __name__ == "__main__":
    main(sys.argv[1:])
