#!/usr/bin/env python3
"""Drive the norma_tpu_torch port once on one CUDA card, end to end.

    python3 chip_smoke.py

Needs one CUDA card, nvcc and this repository's sources; it exits non-zero
(and prints no result line) without them.  Phases, one line each:

  1. build: compile csrc/*.cu with nvcc, one process per source
     (ops/_build.py); print the nvcc version, build seconds, ptxas' resource
     lines and the card's name and power limit;
  2. sample_step kernel vs its plain PyTorch version at rows 1/6/8/48 x
     V=51866 and 8 x an odd V (greedy exactness with NaN, all-masked,
     step-0 and per-row-step rows; the speculative verify rows 5/40/104
     greedy_only with per-row steps; t>0 mask support and exact replay from
     the kernel's own Philox uniforms; uniformity of those uniforms,
     per-row independence); times at 6 and 8 rows host-launched and from
     CUDA graphs, by cluster size against the plan's; the Philox probe
     (philox_uniform) bit for bit against its plain version
     (philox_uniform_torch) at 6/1/64 x V, an odd V and V=7, host-launched
     against it and device-only (torch.profiler) with its bound;
  3. self_decode kernel vs its plain version at distil-large-v3 widths
     (f32 and bf16, bucket views, in-place row write; every position of a
     128-row crop at rows 1 and 6, host and device positions; the served
     bf16 8 rows at crops 128/256/448, pos 3/127/255/300/447); device ms
     from CUDA graphs over cold caches at those fills beside SDPA over the
     same rows, and by cluster size against the plan's (each size's output
     checked);
  4. the golden config (tests/golden/engine_small.json) on the card,
     through run_loop's graph (one host read each) and the per-step eager
     loop (run_loop_eager) alike;
  5. the single-stream slice: distil-large-v3 at mtp=448, buckets
     (128, 256), self_kv_impl="kernel", f32, seeded random weights:
     WhisperModel over 30 s of audio in three chunks (constant language,
     then detect mode) and a padded B=8 window.  Three kernels' launch
     counters must move (sample_step, self_decode, loop_cond).  The warm
     B=1 and B=8 windows dispatched under set_sync_debug_mode("error")
     return with the stream busy and make one host read each.  Then the
     window graphs against the per-step eager loop
     (``DecodeEngine.transcribe_window_eager``) on a B=1 and the B=8
     window (tokens equal; walls, medians, host syncs), the B=1 idle share
     under torch.profiler, graph and eager, and each window graph's nodes,
     record and instantiate seconds and pool bytes;
  6. cross_decode kernel vs its plain version (int8 and int4, G 1/6,
     B 1/8/48, stacked layers 0/1 and the per-layer form; Ta 37/38/200 at
     G 1-8 and every cluster size); device ms from CUDA graphs over cold
     codes at B=8 G=1 and B=1 G=6, int8 and int4, by cluster size against
     the plan's (each size's output checked);
  7. flash_encoder kernel vs its plain version (T 1500/200/37, B 1/8, bf16
     and f32, D=1280, H=20);
  8. q8a8 kernel vs its plain version at the w8a8 encoder's four (K, N)
     shapes, M=12000 (the int32 accumulation bit-exact), with a bf16 cuBLAS
     product of the same shape timed beside them for reference;
  9. the batched serving slice: distil-large-v3 bf16, fused QKV,
     quantize_encoder(quantize_decoder(...)), jax_flash encoder, int8
     cross-K/V in the kernel layout, self-decode kernel:
     BatchedTranscriber(max_streams=8) after warmup() serving 8 concurrent
     20-40 s synthetic streams fed in lockstep at 3x real time: no audio
     or transcript drops, >= 3 rounds per stream, a round with all 8
     active, and every one of the six kernels' launch counters (the five
     above and w8, which the int8 decoder layers and head run) must move
     during the served rounds.  The engine leaves the caller's params as
     they were: a bare encode on them equals the engine's, and a second
     engine with the w8a16 encoder runs.  Then one B=1 window with int4
     cross-K/V, a full-width decoder_step through the kernel routes against
     the plain routes on the prefill of the engine's padded window, at B=1
     and at B=8 (5 active), the B=8 and B=1 window graphs against eager
     (tokens equal, one host read each) with the B=8 idle share under
     torch.profiler, graph and eager, the warm B=8
     and B=1 windows' dispatch under set_sync_debug_mode("error") (the
     stream busy when it returns, one host read), each window graph's
     nodes, record and instantiate seconds and pool bytes, and one eager
     B=8 window profiled; then a fresh engine whose WhisperModel.warmup
     windows at B=1 and B=8 have every row finished before its first step
     (the gate's outcome on silence), after which live B=1 and B=8 windows
     capture no graph; then engines with cross_kv_impl="a8" (int8 q and
     softmax weights, exact int8 products) and "einsum" on the same
     params: the a8 B=8 window one graph (its capture survives a dropped
     engine's graphs being collected inside it), one host read and no
     capture once warm, the warm B=8 walls of the kernel, a8 and einsum engines
     in turns, and one layer's a8 output on the card against the same
     function on the CPU (within 1e-5 of the max, or one weight code's
     step where a code flipped at a rounding tie);
 10. w4_matmul kernel vs its plain version at the int4 head's pitched
     codes [1280 -> 51866] and at 1280x1280, rows 1/6/8/16/48/200, bf16 and
     f32 x, one launch per product; contiguous codes (copied pitched for the
     call) give the same product; JAX-layout head trees (int4 and int8)
     carried by params_from_numpy get the engine's head layout and run
     logits_head through the kernels; device times from CUDA graphs over
     cold weights at 1/6/8/16 rows beside the int8 head (w8 kernel) and a
     bf16 cuBLAS head, by (cluster, warps) against the plan's, and w4
     beside w8 by the number of 128-column tiles;
 11. w8_matmul kernel vs its plain version at the int8 decoder's four
     shapes and the head, rows 1/6/8/16/24/48/200, bf16 and f32 x, one
     launch per product; device times from CUDA graphs over cold weights
     at 6/8/16 rows against bf16 cuBLAS on a bf16 weight, with the bound;
 12. log_mel kernel: a B=8 batch of 30 s windows through log_mel_pallas
     (its own path; the kernel is on no serving path, as in the JAX
     package), then kernel vs log_mel_dft and vs frontend/mel.py at B 1/8
     and on a silent row beside a loud one, 80 and 128 mels; times at B=8
     and B=1 host-launched against the plain version and device-only
     (torch.profiler, the log-mel launch and its clamp), the bound of its
     three TF32 passes beside the first form's f32 bound, and the rFFT
     frontend's time;
 13. the public entry point at full width: a distil-large-v3-shaped
     checkpoint (config.json, a WordLevel tokenizer.json, BF16
     model.safetensors of seeded random weights) written to a temporary
     directory, monolingual.Definition(quantize_decoder, int4 head,
     quantize_encoder, quantize_cross_kv, jax_flash / kernel / kernel) ->
     Transcriber.blocking_spawn streaming >= 35 s of real-time synthetic
     audio, stop(), close(), join(): no audio dropped, no error, and the
     seven on-path kernels' counters (sample_step, self_decode,
     cross_decode, flash_encoder, q8a8, w8, w4) all move; the first
     window again, graph against eager (tokens equal) and its dispatch
     under set_sync_debug_mode("error") (one host read); then one window
     of multilingual.Definition in detect mode with quantize_self_kv and
     the int4 head (the self-decode kernel stays off on the int8 cache);
     then the port's offline quantizer (python -m
     norma_tpu_torch.tools.quantize_checkpoint, --decoder --logits int4
     --encoder, the tiers this Definition quantized in memory) on the
     checkpoint, its output served through a Definition's local_dir
     decoding the first streamed window to the same tokens, and
     norma_tpu_torch/examples/file_transcribe.py in a subprocess on the
     checkpoint and a 12 s WAV: exit 0 and at least one streamed line;
 14. speculative decoding at full width: a large-v3 target (32/32 layers)
     and a distil-large-v3-shaped draft (2 decoder layers sharing the
     target's encoder), seeded random weights drawn on the card with a
     peaked softmax.  f32: the speculative tokens equal the plain engine's
     greedy decode at B=1 and B=8 (5 active), at spec_k=4 and "auto"
     (a failure prints the first differing position and the target's logit
     margin there); each window is one CUDA graph (one capture) with one
     host read, its round loop one WHILE node whose passes equal the
     rounds, and each graph's nodes by type are printed; a self-draft
     accepts every proposal; at 4 target layers the window graph's packed
     rows equal the round-by-round eager window's bit for bit and
     transcribe_window equals transcribe_window_eager.  bf16 serving knobs
     (fused QKV, int8 decoder, int4 head, w8a8 + flash encoder; int8
     draft): B=8 rows against the plain engine (printed), the launches of
     sample_step, w8, w4, flash and q8a8 in one speculative window (all
     must move), warm walls of both engines at B=1 and B=8 in turns beside
     the walls of the round loop read on the host in chunks, one host read
     a speculative window (two with its fallback); then the public entry,
     monolingual.Definition(draft_local_dir=...) over two BF16 checkpoints
     it writes (depth cut to 4 layers), warmup() running the fallback, and
     30 s transcribed in three chunks with no capture after warmup().
     Phase 2 also holds sample_step at
     the verify chunk's 5, 40 and 104 rows (greedy_only, per-row steps);
 15. the README's Quick start with the microphone: the stub libasound
     (tests/stub_alsa, gcc) and the port's native ALSA runtime (g++) built
     into build/norma_tpu_torch/, NTA_ALSA_LIB set before the native
     library first loads; list_devices names "stubmic" and query_configs
     gives its six ranges; on phase 13's checkpoint with the serving knobs,
     Transcriber.blocking_spawn -> blocking_start(Settings()) for 33 s of
     real time -> stop(): one final chunk, the samples captured within 5%
     of wall x 16 kHz, no ring drop, windows decoded on the card and the
     seven kernels' counters moved; then Settings(selected_device=
     "stubmic"), and an absent device under TRY_DEFAULT (opens the
     default) and under ERROR (raises SelectedDeviceNotFound);
 16. the port's flip-rate tool (norma_tpu_torch/tools/accuracy_flip_rate.py)
     at its default widths, 2 seeds: the Adam fit on the card, both
     regimes, every tier including xkv_int4 through cross_decode; the
     trained regime's median top-2 gap must be >= 3 logits and every tier
     must decode all but at most one trained window exactly; the w8, q8a8,
     cross_decode and sample_step counters must move; seed 1's fit again
     with 30 GB of the card held must give the same weights bit for bit;
 17. the port's soak tool (norma_tpu_torch/tools/soak_serving.py) for one
     minute with 8 real-time streams on distil-large-v3 at mtp 136 (EOT
     unreachable, seed 0, bf16, fused QKV): it must print SOAK PASS;
 19. data parallelism (last; ~100 s): the serving config of phase 9 on
     a dp=2 mesh of virtual devices (cuda:0 named twice), and on a mesh
     over every card where there are several.  A padded B=8 window (5
     active) through DecodeEngine on shard_params: each replica's rows
     bit for bit equal to a one-device engine's on the same 4 rows, and
     each replica alone moves the six serving kernels' counters; the same
     window one engine against two replicas, walls in turns, its dispatch
     under set_sync_debug_mode("error") (each replica's stream busy, one
     host read each) and the idle share (tracing.idle_share: overlapping
     streams counted once).  Then
     BatchedTranscriber(max_streams=8, mesh=...) after warmup() serving
     phase 9's 8 lockstep streams (on the virtual mesh, and over every
     card where 8 streams divide over them): phase 9's checks, no CUDA
     graph captured after warmup, the B=8 round median beside phase 9's,
     the peak memory.  With several cards, sample_step on each other
     card's tensors from cuda:0 (the launch's device guard).  Then phase 5's f32 config (weights drawn on the card):
     the dp=2 greedy tokens at B=8 equal the one-device engine's;
     norma_tpu_torch.parallel.dryrun_multichip on the card (its tp mesh's
     line ends with the draft/verify part of a tp-sharded draft); and the
     engine's host reads must let another Python thread run while they
     wait on the card (replicas wait in their own threads);
 18. (run right after phase 9, whose engine it then frees) the device
     report (norma_tpu_torch/tracing.py) on phase 9's engine:
     one eager and one graph B=8 window through profiled_device_ms
     (traces under build/traces/): per served kernel, the eager window's
     report events equal the wrapper's launch counter, and the graph
     window's counters equal the eager window's and its report events are
     at most its counters and short of them by max(4, n // 1000) at most
     (the trace lost 2 of a graph window's 5785 w8 records; the window is
     taken again, three times at most, when it falls outside); device-busy
     ms <= wall ms; the device ms per window, the top 12 kernels, the named
     regions' device span and busy ms (the eager window's window_front,
     token_loop, ladder_finish; the graph's replay, window_graph), the idle
     share split into the host's ends and the gaps between device events,
     and the graph window's wall untraced, beside the card's name and power
     limit; loop_cond's device ms per launch in the graph window.
 20. tensor parallelism (after phase 19): phase 9's serving config on
     make_mesh(tp=2) over the card named twice (one process, a
     LocalGroup): the ranks' encoder outputs bit for bit, a padded B=8
     window against one engine (prefill logits and no-speech within a
     stated bf16 tolerance), its window graph's results equal to its
     per-step eager window's, a warm window dispatched under
     set_sync_debug_mode("error") busy at return with one host read,
     every serving kernel launched and the
     encoder's kernels twice one engine's count; BatchedTranscriber(
     max_streams=8, mesh=tp2) serving 8 lockstep streams (no capture after
     warmup, the B=8 round median, peak memory); a B=1 window at tp=4
     (the ragged int8 head, q8a8 at K 320 and N 960) and phase 8's checks
     at the tp=4 shapes; phase 5's f32 config at tp=2, greedy tokens equal
     one engine's at B=8, with the plain cross-attention and with
     cross_kv_impl="a8" over int8 cross-K/V (q's row scale the max over
     both ranks' columns).  Then speculative decoding at tp=2 over the card
     named twice on phase 14's configs, full width and depth: f32, the
     greedy speculative rung's tokens of a B=1 and a padded B=8 window
     (5 active) equal tp=1's (phase 14's rows of the same run), and a
     window of padding rows captures the window's graph (the live B=1
     window then captures none), one host read a window; the bf16 serving
     knobs: w8 against
     its plain version on both ranks' shards at the path's rows, the
     verify chunk's logits within VERIFY_TOL of tp=1's (the gap also
     printed at target depths 4, 8 and 16 beside 32, and at 32 in f32
     unquantized, the shards' witness), and after a
     warm-up (a window of padding rows at B=1 and B=8, as silence under
     the no-speech gate) a B=8 window whose sample_step, w8, w4, flash
     and q8a8 launches must all move, a B=1 window, valid tokens, no CUDA
     graph captured after the warm-up, one host read a window (two with
     the fallback), walls beside phase 14's and rows against its rows
     (printed, not gated); at 4/4 target layers, WhisperModel.warmup(
     batch=8), then a live window and one forced into the t>0 fallback
     (two host reads), no capture after the warm-up.
 21. tensor parallelism over the cards (phase 20's second half; with one
     card it prints that it did not run).  tp=2 over cuda:0,1 (a worker process each, NCCL): the
     prefill's logits within phase 20's tolerance of one engine's and bit
     for bit equal to tp=2 in one process, every row of the window equal
     to that run's, launches per rank, B=1 walls against one engine, each
     card's idle share and memory; a warm B=1 and a padded B=8 window on
     every rank one CUDA graph whose loops are WHILE nodes holding the
     collectives: the dispatch under set_sync_debug_mode("error") returns
     with the stream busy, one host read a rank, no capture, every rank's
     rows bit for bit equal to its eager window's and to tp=2 in one
     process; each rank's graph nodes by type; a window of a new shape
     (B=2) dispatched while a warm B=8 window is in flight (its capture's
     run before it launches collectives outside a graph, which wait for
     the B=8 graph), both windows' rows bit for bit equal to tp=2 in one
     process and one capture a rank; a served run (no capture after
     warmup, the B=8 round median).  With four cards, tp=4 and dp2 x
     tp2 over the cards (logits and no-speech within the tolerance; dp2 x
     tp2 also the warm-window checks on each replica's ranks).  Over every
     card, phase 19's one row a card with threads of one process against
     worker processes, in turns, results bit for bit, and each worker
     alone.  Then speculative decoding at tp=2 over cuda:0,1 in
     worker processes (each gets its rank's target and draft shards, one
     NCCL communicator) on phase 14's target cut to 4/4 layers with the
     serving knobs: a padded B=8 and a B=1 window's rows, rounds and
     tokens per round bit for bit equal to tp=2 in one process, one host
     read a window on each rank (two with the fallback, as in one
     process), and B=1 walls of both.
 22. (run after phase 2) loop_cond, the token loop's stop test in the
     window graphs' WHILE nodes, bit for bit against its plain version at
     rows 1/6/8/48 (flags none, some, all set; positions below, at and past
     the run's end), host-launched time beside the plain version's.

Then one JSON line with each kernel's launches, error and times, the
card's ``nvidia-smi`` name/power-limit line, and last
``{"ok": true, "device": {...}}``.  Each kernel's ``launches`` is the count
from the path that runs it, its counters set to 0 just before: phase 5
(sample_step, self_decode, loop_cond), phase 9 (cross_decode, flash_encoder, q8a8),
phase 13 (w4_matmul, w8_matmul) and, for the two kernels that no serving
path runs, their own paths: phase 12's batch (log_mel) and phase 2's
replay of the sampler's draws (philox_uniform).  Phases 9 and 17 also
print the CUDA graphs the engine captured after warmup().
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import time
import traceback

ROOT = os.path.dirname(os.path.abspath(__file__))

# large-v3 token layout (V = 51866), with the real EOT.
ST_V3 = dict(
    sot=50258, eot=50257, task=50360, no_speech=50363,
    no_timestamps=50364, zero_sec=50365, one_sec=50415,
)
LANG_IDS_V3 = list(range(50259, 50359))
V3 = 51866


def log(msg: str) -> None:
    print(msg, flush=True)


def smi_line() -> str:
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return r.stdout.strip().splitlines()[0]


def cuda_ms(fn, n: int = 100) -> float:
    """Mean device ms per call over ``n`` back-to-back calls (CUDA events)."""
    import torch

    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    s.record()
    for _ in range(n):
        fn()
    e.record()
    torch.cuda.synchronize()
    return s.elapsed_time(e) / n


def turns(plain, kernel):
    """Time plain, kernel, kernel, plain; return (kernel_ms, plain_ms)."""
    p1, k1, k2, p2 = cuda_ms(plain), cuda_ms(kernel), cuda_ms(kernel), cuda_ms(plain)
    return (k1 + k2) / 2, (p1 + p2) / 2


# The H100 SXM's published peaks at 700 W (NVIDIA's data sheet, dense):
# HBM bytes/s and operations/s by operand type.
PEAK_BYTES = 3.35e12
PEAK_OPS = {"bf16": 989e12, "int8": 1979e12, "tf32": 495e12, "f32": 67e12}


def bound(nbytes: float, ops=0.0, kind: str = "bf16"):
    """(bound_ms, bound_by): the least time for ``nbytes`` of HBM traffic
    (each input read once, each output written once) and ``ops``
    operations of ``kind`` on the card (or a {kind: ops} dict, their times
    summed), whichever is larger."""
    ops = ops if isinstance(ops, dict) else {kind: ops}
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, sum(n / PEAK_OPS[k] for k, n in ops.items()) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


# Each kernel's CUDA function names (substrings of the profiler's names).
KERNEL_FUNCS = {
    "sample_step": ("sample_step_kernel",), "self_decode": ("self_decode_kernel",),
    "cross_decode": ("cross_decode_kernel",), "flash_encoder": ("flash_encoder",),
    "q8a8": ("q8a8_wgmma_kernel",), "w8_matmul": ("w8_mma_kernel",),
    "w4_matmul": ("w4_mma_kernel",), "log_mel": ("log_mel_kernel", "log_mel_clamp_kernel"),
    "philox_uniform": ("philox_uniform_kernel",), "loop_cond": ("loop_cond_kernel",),
}


TRACES = os.path.join(ROOT, "build", "traces")


def device_profile(fn, names, tag="profile"):
    """Run ``fn`` once through the package's measurement path
    (``norma_tpu_torch.tracing.profiled_device_ms``, traces under
    build/traces/<tag>); per kernel of ``names``: device-only ms per launch
    of its main function, launches, device ms in all (its split-sum pass
    included), ``tries``, the sessions it took, and ``missed``, the device
    events each session that lost some held (a session that loses device
    events is taken again, twice at most).  None where the report shows
    no device time ("not measured")."""
    from norma_tpu_torch import tracing

    d = os.path.join(TRACES, tag)
    tracing.profiled_device_ms(fn, 1, d)
    tries, missed = tracing.last_profile["sessions"], list(tracing.last_profile["lost"])
    events = [(k, c, t * 1e3) for k, (t, c) in tracing.device_time_report(d).items()]
    out = {}
    for name in names:
        funcs = KERNEL_FUNCS[name]
        main = [(c, us) for k, c, us in events if funcs[0] in k and us > 0]
        rest = [us for k, c, us in events if any(f in k for f in funcs[1:]) and us > 0]
        if not main:
            out[name] = None
            continue
        n = sum(c for c, _ in main)
        total = sum(us for _, us in main)
        out[name] = dict(launches=n, ms_per_launch=total / n / 1e3, ms_total=(total + sum(rest)) / 1e3, tries=tries,
                         missed=missed)
    return out


def tries_text(d) -> str:
    """Beside a device-only figure that took more than one profiler
    session: how many, and the device events each short one held."""
    return "" if d is None or d["tries"] == 1 else (
        f" ({d['tries']} profiles taken; device events in the short ones: {d['missed']})")


def profile_text(prof) -> str:
    return "; ".join(
        f"{k}: not measured" if v is None else
        f"{k}: {v['ms_per_launch']:.4f} ms x {v['launches']} ({v['ms_total']:.1f} ms){tries_text(v)}"
        for k, v in prof.items()
    )


def idle_share(fn, tag="idle"):
    """Run ``fn`` once under ``norma_tpu_torch.tracing.profile`` (traces
    under build/traces/<tag>): (wall ms, device-busy ms, idle share, device
    events).  Busy is the sum of the kernels', copies' and fills' device
    time in the report; the idle share is 1 - busy / wall."""
    import torch

    from norma_tpu_torch import tracing

    d = os.path.join(TRACES, tag)
    wall = []

    def timed():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - t0) * 1e3)

    busy, _ = tracing.profiled_device_ms(timed, 1, d)
    rep = tracing.device_time_report_multi(d, tracing.BUSY_LINES)
    n = sum(c for line in rep.values() for _, c in line.values())
    return wall[-1], busy, 1.0 - busy / wall[-1], n


def window_modes(engine, audio, langs, seed, n_active=None):
    """The same window through the window graph and through the per-step
    eager loop (``transcribe_window_eager``: a host read before every step,
    no graphs), in turns graph, eager, eager, graph.  Tokens must be equal;
    returns per mode the walls (ms, host clock after a sync), their median,
    host syncs and steps per window."""
    import numpy as np
    import torch

    res, tokens = {"graph": [], "eager": []}, []
    for mode in ("graph", "eager", "eager", "graph"):
        run = engine.transcribe_window_eager if mode == "eager" else engine.transcribe_window
        torch.cuda.synchronize()
        h0, s0, t0 = engine.host_syncs, engine.decode_steps, time.perf_counter()
        drs, _ = run(audio, langs, seed, n_active)
        torch.cuda.synchronize()
        res[mode].append(((time.perf_counter() - t0) * 1e3, engine.host_syncs - h0, engine.decode_steps - s0))
        tokens.append([d and d.tokens for d in drs])
    if any(tk != tokens[0] for tk in tokens):
        raise AssertionError("graph-loop tokens differ from the per-step loop's")
    return {k: dict(ms=[r[0] for r in v], median_ms=float(np.median([r[0] for r in v])), syncs=v[0][1],
                    steps=v[0][2]) for k, v in res.items()}


def modes_text(res) -> str:
    return "; ".join(f"{k} {[round(x, 1) for x in v['ms']]} ms (median {v['median_ms']:.1f}), {v['syncs']} syncs, "
                     f"{v['steps']} steps" for k, v in res.items())


def one_read_window(engine, audio, langs, seed, n_active=None):
    """A window of a shape the engine captured before, dispatched under
    ``torch.cuda.set_sync_debug_mode("error")``: the dispatch makes no
    synchronizing call and returns while the card is still busy with the
    window (the current stream's ``query()``; each replica's stream on a dp
    engine), its fetch is the window's one host read (each replica's), and
    no CUDA graph is captured.  Returns (results, dict(dispatch_ms, wall_ms,
    busy, syncs))."""
    import torch

    reps = getattr(engine, "replicas", None)
    engines = [r.engine for r in reps] if reps else [engine]
    streams = [r.stream for r in reps] if reps else [torch.cuda.current_stream()]
    torch.cuda.synchronize()
    h0, c0 = [e.host_syncs for e in engines], engine.graph_captures
    t0 = time.perf_counter()
    torch.cuda.set_sync_debug_mode("error")
    try:
        pending = engine.transcribe_window_async(audio, langs, seed, n_active)
        busy = [not s.query() for s in streams]
    finally:
        torch.cuda.set_sync_debug_mode(0)
    t1 = time.perf_counter()
    drs, _ = engine.transcribe_window_fetch(pending)
    t2 = time.perf_counter()
    syncs = [e.host_syncs - h for e, h in zip(engines, h0)]
    if not all(busy) or any(n != 1 for n in syncs) or engine.graph_captures != c0:
        raise AssertionError(f"a warm window: stream busy after the dispatch {busy}, host reads {syncs} (want 1 "
                             f"each), {engine.graph_captures - c0} graphs captured")
    return drs, dict(dispatch_ms=(t1 - t0) * 1e3, wall_ms=(t2 - t0) * 1e3, busy=busy, syncs=syncs)


def one_read_text(r) -> str:
    return (f"dispatch {r['dispatch_ms']:.2f} ms returned with the stream busy {r['busy']} (no synchronizing call "
            f"under set_sync_debug_mode('error')), window {r['wall_ms']:.1f} ms, host reads {r['syncs']}")


def window_graph_stats(engine, kinds=("window",)):
    """Per device program of ``engine`` (each replica's on a dp engine) whose
    kind is one of ``kinds`` (``DecodeEngine._programs``: "window",
    "loop", "spec", "fallback"): its key, nodes (its own, its WHILE
    bodies', and theirs by type), record and instantiate seconds and the
    WHILE passes of its last fetch; and per engine its graph pool's
    reserved bytes."""
    import torch

    out = []
    engines = [r.engine for r in engine.replicas] if hasattr(engine, "replicas") else [engine]
    segs = torch.cuda.memory_snapshot()
    for e in engines:
        pool = e._graph_pool
        pool_bytes = sum(s["total_size"] for s in segs
                         if pool is not None and tuple(s.get("segment_pool_id", ())) == tuple(pool))
        out.append(dict(pool_bytes=pool_bytes, graphs={k: dict(v.stats, passes=v.passes)
                                                       for k, v in e._programs.items() if k[0] in kinds}))
    return out


def program_text(key) -> str:
    """A device program's key, short: rows, detection, K."""
    kind = key[0]
    if kind == "window":
        return f"B={key[1]} detect={key[3]}"
    if kind == "spec":
        return f"spec B={key[1]} detect={key[3]} K={key[4]}"
    if kind == "fallback":
        return f"fallback B={key[1]}"
    return f"run_loop P={key[2]} greedy={key[3]}"


def graph_stats_text(stats) -> str:
    return " | ".join(
        f"pool {e['pool_bytes'] / 2**30:.2f} GiB: " + "; ".join(
            f"{program_text(k)}: {g.get('nodes')} + {g.get('body_nodes', 0)} body nodes "
            f"{g.get('body_types', {})}, record {g.get('record_s', float('nan')):.2f} s, instantiate "
            f"{g.get('instantiate_s', float('nan')):.3f} s, last passes {g.get('passes')}"
            for k, g in e["graphs"].items())
        for e in stats)


# --------------------------------------------------------------------------


def _kernel_name(mangled: str) -> str:
    """A kernel's name and template arguments from its mangled name:
    '_ZN12_GLOBAL__N_117q8a8_wgmma_kernelILi128EfEEv...' ->
    'q8a8_wgmma_kernel<128,f>'."""
    rest = mangled[3:] if mangled.startswith("_ZN") else mangled[2:]
    name = mangled
    while rest[:1].isdigit():
        digits = re.match(r"\d+", rest).group()
        n = int(digits)
        name, rest = rest[len(digits):len(digits) + n], rest[len(digits) + n:]
    if rest.startswith("I"):
        args = re.findall(r"Li(\d+)E|(?<=[IE])([fd])(?=[EL])|(__nv_bfloat16)", rest.split("EEv")[0] + "E")
        name += "<" + ",".join("".join(a) for a in args) + ">"
    return name


def phase_build(rec):
    from norma_tpu_torch.ops import _build

    _build.lib()
    info = _build.build_info
    log(f"phase 1 build: ok nvcc='{info.get('nvcc')}' seconds={info.get('seconds', 0.0):.1f}")
    # ptxas -v, one line per entry function: registers, spills, static smem.
    func, spill = "?", ""
    for ln in info.get("ptxas", "").splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            func = _kernel_name(m.group(1))
        elif "spill" in ln:
            spill = ln.strip()
        elif "registers" in ln:
            log(f"  ptxas {func}: {ln.split(':', 1)[-1].strip()}; {spill}")
    rec["nvcc"] = info.get("nvcc")
    rec["smi"] = smi_line()
    log(f"  card {rec['smi']}")


def _v3_masks(dev, V=V3):
    import torch

    from norma_tpu_torch.decode.masks import SpecialTokens, build_masks
    from norma_tpu_torch.model.config import PRESETS

    m = build_masks(V, PRESETS["distil-large-v3"].suppress_tokens, SpecialTokens(**ST_V3))
    return tuple(torch.from_numpy(a).to(dev) for a in (m.suppress, m.non_timestamps, m.timestamps, m.first_token))


SS_ROWS = (1, 6, 8, 48)
SS_ODD_V = V3 + 3  # odd: no cluster size divides it


def phase_sample_step(rec, dev):
    import numpy as np
    import torch

    from norma_tpu_torch.ops import sample_step as ss

    eot, nts = ST_V3["eot"], ST_V3["no_timestamps"]
    g = torch.Generator(device=dev).manual_seed(0)
    i32 = lambda x, B: torch.full((B,), x, dtype=torch.int32, device=dev) if np.isscalar(x) else torch.as_tensor(x, dtype=torch.int32, device=dev)
    max_err = 0.0

    def case_inputs(B, V, p1, p2, lts):
        ll = torch.randn((B, V), generator=g, device=dev) * 2.0
        return ll, i32(p1, B), i32(p2, B), i32(lts, B)

    cases = [  # (p1, p2, last_ts, step)
        (ST_V3["task"], ST_V3["sot"], 0, 0),
        (ST_V3["zero_sec"] + 1, 100, 0, 1),
        (ST_V3["zero_sec"] + 2, ST_V3["sot"], 0, 2),
        (100, 101, 0, 3),
        (100, ST_V3["zero_sec"] + 3, ST_V3["zero_sec"] + 3, 4),
        (V3 - 1, 100, V3 - 1, 5),  # grammar deadlock
    ]
    # Every case at each row count, at V=51866 and at an odd V: greedy
    # tokens and deadlock flags exact, probabilities to rtol 1e-5; t>0 draws
    # in the mask's support and replayed exactly from the kernel's Philox
    # uniforms (>= 2000 at 48 rows).
    draws = replay_ok = replay_n = 0
    shapes = [(B, V3) for B in SS_ROWS] + [(8, SS_ODD_V)]
    # The probe's own path is this replay: its launches count from here.
    ss.philox_uniform.launches = 0
    for B, V in shapes:
        masks = _v3_masks(dev, V)
        for p1, p2, lts, step in cases:
            ll, tp1, tp2, tlts = case_inputs(B, V, p1, p2, lts)
            ll[0] = float("nan")  # a NaN row
            if B > 1:
                ll[1, 7] = float("nan")  # one NaN poisons the row
            temp = torch.zeros(B, device=dev)
            args = (ll, *masks, tp1, tp2, tlts, step, temp)
            kn, kp, kd = ss.sample_step(*args, eot=eot, no_timestamps=nts)
            pn, pp, pd = ss.sample_step_torch(*args, eot=eot, no_timestamps=nts, greedy_only=True)
            if not (torch.equal(kn, pn) and torch.equal(kd, pd)):
                raise AssertionError(f"greedy mismatch B={B} V={V} case={(p1, p2, lts, step)}")
            torch.testing.assert_close(kp, pp, rtol=1e-5, atol=0.0, equal_nan=True)
            fin = torch.isfinite(pp)
            if fin.any():
                max_err = max(max_err, float((kp[fin] - pp[fin]).abs().max()))
        # Per-row steps: row 0 at the first-token grammar.
        ll, tp1, tp2, tlts = case_inputs(B, V, 100, 101, 0)
        steps = torch.arange(B, dtype=torch.int32, device=dev) % 3
        args = (ll, *masks, tp1, tp2, tlts, steps, torch.zeros(B, device=dev))
        kn, kp, kd = ss.sample_step(*args, eot=eot, no_timestamps=nts)
        pn, pp, pd = ss.sample_step_torch(*args, eot=eot, no_timestamps=nts, greedy_only=True)
        if not (torch.equal(kn, pn) and torch.equal(kd, pd)):
            raise AssertionError(f"per-row-step greedy mismatch B={B} V={V}")
        torch.testing.assert_close(kp, pp, rtol=1e-5, atol=0.0)
        for step in range(1, 51 if B == 48 else 11):
            ll, tp1, tp2, tlts = case_inputs(B, V, 100, 101, 0)
            temp = torch.tensor([0.2, 0.6, 1.0] * 16, device=dev)[:B]
            seed = 1234 + (step << 32)
            kn, kp, kd = ss.sample_step(ll, *masks, tp1, tp2, tlts, step, temp, eot=eot, no_timestamps=nts,
                                        seed=seed)
            if not torch.isfinite(kp).all() or kd.any():
                raise AssertionError(f"t>0 draw chose a masked token at B={B} V={V} step {step}")
            draws += B
            u = ss.philox_uniform(seed, step, B, V, dev)
            pn, _, _ = ss.sample_step_torch(ll, *masks, tp1, tp2, tlts, step, temp, eot=eot, no_timestamps=nts,
                                            u=u)
            replay_ok += int((pn == kn).sum())
            replay_n += B
    pu_launches = ss.philox_uniform.launches
    if replay_ok != replay_n:
        raise AssertionError(f"Philox replay agreed on {replay_ok}/{replay_n} draws")
    # The probe against its plain version (Philox4x32-10 in PyTorch integer
    # arithmetic, on the card): bit for bit, at the replay's shape, one row,
    # 64 rows, an odd V and a V below one group of four.
    pu_err = 0.0
    for rows, V in ((6, V3), (1, V3), (64, V3), (6, SS_ODD_V), (3, 7)):
        pseed, pstep = 0x123456789ABCDEF0 + rows, 11 + V % 5
        ku = ss.philox_uniform(pseed, pstep, rows, V, dev)
        pu = ss.philox_uniform_torch(pseed, pstep, rows, V, dev)
        if ku.shape != (rows, V) or not torch.equal(ku.view(torch.int32), pu.view(torch.int32)):
            raise AssertionError(f"philox_uniform differs from philox_uniform_torch at {rows} x {V}")
        pu_err = max(pu_err, float((ku - pu).abs().max()))
    masks = _v3_masks(dev)
    # The speculative verify chunk's rows (B x (K+1)): greedy_only, per-row
    # steps and grammar states, as a round runs them; CUDA-graph ms.
    verify_ms = {}
    for R in SPEC_ROWS:
        ll = torch.randn((R, V3), generator=g, device=dev) * 2.0
        tp1 = torch.randint(0, V3, (R,), generator=g, device=dev, dtype=torch.int32)
        tp2 = torch.randint(0, V3, (R,), generator=g, device=dev, dtype=torch.int32)
        ts = torch.randint(nts + 1, V3, (R,), generator=g, device=dev, dtype=torch.int32)
        tlts = torch.where(torch.rand(R, generator=g, device=dev) < 0.5, 0, ts).to(torch.int32)
        steps = (torch.arange(R, device=dev) % 5).to(torch.int32)
        args = (ll, *masks, tp1, tp2, tlts, steps, torch.zeros(R, device=dev))
        kn, kp, kd = ss.sample_step(*args, eot=eot, no_timestamps=nts, greedy_only=True)
        pn, pp, pd = ss.sample_step_torch(*args, eot=eot, no_timestamps=nts, greedy_only=True)
        if not (torch.equal(kn, pn) and torch.equal(kd, pd)):
            raise AssertionError(f"greedy_only per-row-step mismatch at {R} verify rows")
        torch.testing.assert_close(kp, pp, rtol=1e-5, atol=0.0, equal_nan=True)
        verify_ms[R] = graph_ms([lambda: ss.sample_step(*args, eot=eot, no_timestamps=nts, greedy_only=True)] * 20)
    u = ss.philox_uniform(99, 7, 64, 512, dev)
    umin, umax, umean = float(u.min()), float(u.max()), float(u.mean())
    if not (0.0 <= umin < 0.02 and 0.98 < umax < 1.0 and abs(umean - 0.5) < 0.02):
        raise AssertionError(f"Philox uniforms off: min={umin} max={umax} mean={umean}")
    row = torch.randn((1, V3), generator=g, device=dev).repeat(8, 1)
    kn, _, _ = ss.sample_step(row, *masks, i32(100, 8), i32(101, 8), i32(0, 8), 3,
                              torch.ones(8, device=dev), eot=eot, no_timestamps=nts, seed=5)
    if len(set(kn.tolist())) < 2:
        raise AssertionError("rows with equal inputs drew the same token")

    # Times at the slices' shapes: the B=1 speculative ladder's 6 rows (t =
    # 0..1) and the served batch's 8; host-launched in turns with the plain
    # version, and device ms from CUDA graphs; then the cluster size against
    # the plan's, from CUDA graphs.
    times = {}
    for B in (6, 8):
        ll, tp1, tp2, tlts = case_inputs(B, V3, 100, 101, 0)
        temp = torch.linspace(0.0, 1.0, B, device=dev)
        args = (ll, *masks, tp1, tp2, tlts, 3, temp)
        k_ms, p_ms = turns(
            lambda: ss.sample_step_torch(*args, eot=eot, no_timestamps=nts),
            lambda: ss.sample_step(*args, eot=eot, no_timestamps=nts, seed=1),
        )
        kern = [lambda: ss.sample_step(*args, eot=eot, no_timestamps=nts, seed=1)] * 20
        zeros = torch.zeros(B, device=dev)
        greedy = [lambda: ss.sample_step(*args[:-1], zeros, eot=eot, no_timestamps=nts)] * 20
        gr_ms = (graph_ms(kern) + graph_ms(kern)) / 2
        gr_greedy_ms = graph_ms(greedy)
        plan, sweep = ss.sample_step_plan, {}
        try:
            for c in (1, 2, 4, 8, 16):
                ss.sample_step_plan = lambda B_, V_, c=c: {**plan(B_, V_), "cluster": c,
                                                           "slice": 4 * -(-(-(-V_ // c)) // 4)}
                sweep[c] = graph_ms(kern)
        finally:
            ss.sample_step_plan = plan
        # Bound: the logits, masks and row state read once, three [B] outputs.
        b_ms, b_by = bound(nbytes(ll, *masks, tp1, tp2, tlts, temp) + B * (8 + 4 + 1))
        times[B] = dict(ms=k_ms, plain_ms=p_ms, graph_ms=gr_ms, graph_greedy_ms=gr_greedy_ms, bound_ms=b_ms,
                        bound_by=b_by, cluster=plan(B, V3)["cluster"], cluster_ms=sweep)
    # The Philox probe (philox_uniform, the port of u_kernel): 6 rows of V
    # uniforms; bound: the [6, V] f32 output written once.
    pu_ms, pu_plain_ms = turns(lambda: ss.philox_uniform_torch(7, 3, 6, V3, dev),
                               lambda: ss.philox_uniform(7, 3, 6, V3, dev))
    pu_bound, pu_by = bound(6 * V3 * 4)
    pu_prof = device_profile(lambda: [ss.philox_uniform(7, i, 6, V3, dev) for i in range(20)], ["philox_uniform"],
                             "philox")
    rec.setdefault("profile", {}).update(pu_prof)
    pu_dev = pu_prof["philox_uniform"]
    t6 = times[6]
    rec["sample_step"] = dict(max_abs_err=max_err, ms=t6["ms"], plain_ms=t6["plain_ms"], bound_ms=t6["bound_ms"],
                              bound_by=t6["bound_by"], library_ms=None)
    rec["philox_uniform"] = dict(launches=pu_launches, max_abs_err=pu_err, ms=pu_ms, plain_ms=pu_plain_ms,
                                 bound_ms=pu_bound, bound_by=pu_by, library_ms=None)
    rec["sample_step_detail"] = dict(times=times, verify_ms=verify_ms)
    tt = "; ".join(
        f"{B} rows: host-launched {v['ms']:.4f} ms vs plain {v['plain_ms']:.4f} ms, CUDA graph {v['graph_ms']:.4f} "
        f"ms (greedy {v['graph_greedy_ms']:.4f}), bound {v['bound_ms']:.4f} ms ({v['bound_by']}); by cluster "
        f"size (plan {v['cluster']}): " + ", ".join(f"{c}: {ms:.4f}" for c, ms in v["cluster_ms"].items())
        for B, v in times.items())
    log(f"phase 2 sample_step: ok greedy exact at rows {list(SS_ROWS)} x V={V3} and 8 x V={SS_ODD_V} (NaN, "
        f"all-masked, step 0, per-row steps), max_abs_err(prob)={max_err:.3g}; t>0 {draws} draws in support, "
        f"Philox replay {replay_ok}/{replay_n}; u min={umin:.5f} max={umax:.5f} mean={umean:.5f}; {tt}; "
        f"philox_uniform: {pu_launches} launches on the replay, bit-equal to philox_uniform_torch at 6/1/64 x {V3}, "
        f"6 x {SS_ODD_V} and 3 x 7; 6 x {V3}: {pu_ms:.4f} ms host-launched vs plain {pu_plain_ms:.4f} ms, "
        f"device-only {'not measured' if pu_dev is None else format(pu_dev['ms_per_launch'], '.4f')} ms per launch"
        f"{tries_text(pu_dev)} (first form 0.0089), bound {pu_bound:.4f} ms ({pu_by}); verify rows greedy_only, "
        f"per-row steps, exact vs plain, CUDA graph ms " + ", ".join(f"{R}: {v:.4f}" for R, v in verify_ms.items()))


def phase_loop_cond(rec, dev):
    """The token loop's stop test (csrc/loop_cond.cu, ops/loop_cond.py)
    against its plain version: rows 1, 6 (a B=1 window's rungs as rows), 8
    (a B=8 window's sequential rungs) and 48, finished flags none / some /
    all set, positions below, at and past the run's end, one launch each,
    bit for bit.  Times host-launched in turns against the plain version;
    the bound is its bytes (the flags, the position, the byte it writes).
    Its launches come from phase 5's main path, where it runs inside the
    window graphs' WHILE nodes."""
    import torch

    from norma_tpu_torch.ops import loop_cond as lc

    bad, n = [], 0
    for B in (1, 6, 8, 48):
        rows = torch.arange(B, device=dev)
        for fill, fin in (("none", rows < 0), ("some", rows % 3 != 1), ("all", rows >= 0)):
            for pos, end in ((3, 128), (127, 128), (128, 128), (200, 128)):
                p = torch.tensor([pos], dtype=torch.int64, device=dev)
                got, want = lc.loop_cond(fin, p, end), lc.loop_cond_torch(fin, p, end)
                n += 1
                if not torch.equal(got, want):
                    bad.append((B, fill, pos, end, int(got[0]), int(want[0])))
    torch.cuda.synchronize()
    if bad:
        raise AssertionError(f"loop_cond against its plain version, (rows, fill, pos, end, kernel, plain): {bad[:6]}")
    fin = torch.zeros(8, dtype=torch.bool, device=dev)
    p = torch.tensor([100], dtype=torch.int64, device=dev)
    ms, plain_ms = turns(lambda: lc.loop_cond_torch(fin, p, 128), lambda: lc.loop_cond(fin, p, 128))
    b_ms, b_by = bound(nbytes(fin, p) + 1)
    rec["loop_cond"] = dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=None)
    log(f"phase 22 loop_cond: ok {n} cases bit for bit against loop_cond_torch (rows 1/6/8/48, flags none/some/all, "
        f"positions below/at/past the end); 8 rows host-launched {ms:.4f} ms vs plain {plain_ms:.4f} ms; bound "
        f"{b_ms:.6f} ms ({b_by})")


def phase_self_decode(rec, dev):
    import torch

    from norma_tpu_torch.ops import self_decode as sd

    L, D, H = 2, 1280, 20
    g = torch.Generator(device=dev).manual_seed(1)
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    n_cases = 0
    for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 2e-2)):
        for B in (6, 48):
            for T, alloc in ((128, 128), (256, 256), (448, 448), (128, 448), (256, 448)):
                for pos in (3, 127, 300):
                    if pos >= T:
                        continue
                    full_k = (torch.randn((L, B, alloc, D), generator=g, device=dev) * 0.5).to(dtype)
                    full_v = (torch.randn((L, B, alloc, D), generator=g, device=dev) * 0.5).to(dtype)
                    qkv = (torch.randn((B, 1, 3, D), generator=g, device=dev)).to(dtype)
                    q, kn, vn = qkv[..., 0, :], qkv[..., 1, :], qkv[..., 2, :]
                    orig_k, orig_v = full_k.clone(), full_v.clone()
                    pk, pv = full_k.clone(), full_v.clone()
                    li = 1
                    a, _, _ = sd.self_attention_decode(q, kn, vn, full_k[:, :, :T], full_v[:, :, :T], li, pos, H)
                    pa, _, _ = sd.self_attention_decode_torch(q, kn, vn, pk[:, :, :T], pv[:, :, :T], li, pos, H)
                    torch.cuda.synchronize()
                    err = float((a.float() - pa.float()).abs().max())
                    if not err <= tol:
                        raise AssertionError(f"self_decode {dtype} B={B} T={T}/{alloc} pos={pos}: err {err}")
                    worst[dtype] = max(worst[dtype], err)
                    if not (torch.equal(full_k, pk) and torch.equal(full_v, pv)):
                        raise AssertionError(f"cache write differs B={B} T={T} pos={pos}")
                    orig_k[li, :, pos], orig_v[li, :, pos] = kn[:, 0], vn[:, 0]
                    if not (torch.equal(full_k, orig_k) and torch.equal(full_v, orig_v)):
                        raise AssertionError(f"rows other than (li, :, pos) moved B={B} T={T} pos={pos}")
                    n_cases += 1

    # Every position of one short crop at the plan's cluster (1 row: 8 CTAs,
    # some with no rows while pos < 8; 6 rows: 4), host and device
    # positions alternating: the CTAs' ranges cover 0..pos-1 exactly once.
    T = 128
    for B in (1, 6):
        ck = torch.randn((L, B, T, D), generator=g, device=dev) * 0.5
        cv = torch.randn((L, B, T, D), generator=g, device=dev) * 0.5
        qkv = torch.randn((B, 1, 3, D), generator=g, device=dev)
        q, kn, vn = qkv[..., 0, :], qkv[..., 1, :], qkv[..., 2, :]
        for pos in range(T):
            pk, pv = ck.clone(), cv.clone()
            p_arg = torch.tensor([pos], dtype=torch.int64, device=dev) if pos % 2 else pos
            a, _, _ = sd.self_attention_decode(q, kn, vn, ck, cv, 1, p_arg, H)
            pa, _, _ = sd.self_attention_decode_torch(q, kn, vn, pk, pv, 1, pos, H)
            torch.cuda.synchronize()
            err = float((a - pa).abs().max())
            if not err <= 1e-5:
                raise AssertionError(f"self_decode every-pos B={B} pos={pos}: err {err}")
            if not (torch.equal(ck, pk) and torch.equal(cv, pv)):
                raise AssertionError(f"self_decode every-pos B={B} pos={pos}: cache write differs")
            worst[torch.float32] = max(worst[torch.float32], err)
            n_cases += 1

    # The served shape: bf16, 8 rows, crops 128/256/448 (the buckets and
    # mtp) of one 448-row allocation, fills across the window.
    B, T_ALL, li = 8, 448, 1
    bf = torch.bfloat16
    served = [(T, pos) for T in (128, 256, 448) for pos in (3, 127, 255, 300, 447) if pos < T]
    for T, pos in served:
        full_k = (torch.randn((L, B, T_ALL, D), generator=g, device=dev) * 0.5).to(bf)
        full_v = (torch.randn((L, B, T_ALL, D), generator=g, device=dev) * 0.5).to(bf)
        qkv = torch.randn((B, 1, 3, D), generator=g, device=dev).to(bf)
        q, kn, vn = qkv[..., 0, :], qkv[..., 1, :], qkv[..., 2, :]
        orig_k, orig_v = full_k.clone(), full_v.clone()
        pk, pv = full_k.clone(), full_v.clone()
        a, _, _ = sd.self_attention_decode(q, kn, vn, full_k[:, :, :T], full_v[:, :, :T], li, pos, H)
        pa, _, _ = sd.self_attention_decode_torch(q, kn, vn, pk[:, :, :T], pv[:, :, :T], li, pos, H)
        torch.cuda.synchronize()
        err = float((a.float() - pa.float()).abs().max())
        if not err <= 2e-2:
            raise AssertionError(f"self_decode served B={B} T={T} pos={pos}: err {err}")
        worst[bf] = max(worst[bf], err)
        if not (torch.equal(full_k, pk) and torch.equal(full_v, pv)):
            raise AssertionError(f"served cache write differs T={T} pos={pos}")
        orig_k[li, :, pos], orig_v[li, :, pos] = kn[:, 0], vn[:, 0]
        if not (torch.equal(full_k, orig_k) and torch.equal(full_v, orig_v)):
            raise AssertionError(f"served: rows other than (li, :, pos) moved T={T} pos={pos}")
        n_cases += 1

    # Device ms from CUDA graphs at those fills, over six caches in turn
    # (~220 MB, so the rows come from device memory, not the 50 MB L2, as in
    # the token loop), beside SDPA over rows 0..pos of the same crop with the
    # new row in place (it leaves out the row write).  Bound: q and the new
    # K/V row in, rows 0..pos-1 of layer li's K and V read, the new row
    # written, the output out: 2 B D (2 pos + 6) bytes.
    import torch.nn.functional as F

    dh = D // H
    caches = [((torch.randn((L, B, T_ALL, D), generator=g, device=dev) * 0.5).to(bf),
               (torch.randn((L, B, T_ALL, D), generator=g, device=dev) * 0.5).to(bf)) for _ in range(6)]
    qkv = torch.randn((B, 1, 3, D), generator=g, device=dev).to(bf)
    q, kn, vn = qkv[..., 0, :], qkv[..., 1, :], qkv[..., 2, :]
    qh = q.reshape(B, 1, H, dh).transpose(1, 2)

    def kern_calls(T, pos):
        return [lambda c=c: sd.self_attention_decode(q, kn, vn, c[0][:, :, :T], c[1][:, :, :T], li, pos, H)
                for c in caches]

    def sdpa_calls(T, pos):
        view = lambda x: x[li, :, :pos + 1].reshape(B, pos + 1, H, dh).transpose(1, 2)
        return [lambda c=c: F.scaled_dot_product_attention(qh, view(c[0]), view(c[1]), scale=dh**-0.5)
                for c in caches]

    fills = {}
    for T, pos in served + [(448, SD_MEAN_POS)]:
        k1, l1, l2, k2 = (graph_ms(kern_calls(T, pos)), graph_ms(sdpa_calls(T, pos)),
                          graph_ms(sdpa_calls(T, pos)), graph_ms(kern_calls(T, pos)))
        b_ms, b_by = bound(2 * B * D * (2 * pos + 6))
        fills[(T, pos)] = dict(graph_ms=(k1 + k2) / 2, sdpa_ms=(l1 + l2) / 2, bound_ms=b_ms, bound_by=b_by)
    ck, cv = caches[0]
    plain_ms = cuda_ms(lambda: sd.self_attention_decode_torch(q, kn, vn, ck, cv, li, SD_MEAN_POS, H))

    # The cluster size against the plan's at 6 and 8 rows (the ladder's and
    # the served batch's), crop 448, pos 300: each size's output held to the
    # plain version too.
    plan, sweep = sd.self_decode_plan, {}
    try:
        for B_s in (6, 8):
            ref = sd.self_attention_decode_torch(q[:B_s], kn[:B_s], vn[:B_s], ck[:, :B_s].clone(),
                                                 cv[:, :B_s].clone(), li, 300, H)[0]
            calls_s = [lambda c=c: sd.self_attention_decode(q[:B_s], kn[:B_s], vn[:B_s], c[0][:, :B_s],
                                                            c[1][:, :B_s], li, 300, H) for c in caches]
            for c in (1, 2, 4, 8, 16):
                sd.self_decode_plan = lambda B_, H_, S_, dt_, dh_=64, c=c: {
                    **plan(B_, H_, S_, dt_, dh_), "cluster": c, "share": -(-(S_ - 1) // c)}
                if -(-(448 - 1) // c) > plan(B_s, H, 448, bf)["max_rows"]:
                    continue  # the rows do not fit this few CTAs
                a = sd.self_attention_decode(q[:B_s], kn[:B_s], vn[:B_s], ck[:, :B_s], cv[:, :B_s], li, 300, H)[0]
                err = float((a.float() - ref.float()).abs().max())
                if not err <= 2e-2:
                    raise AssertionError(f"self_decode cluster {c} at {B_s} rows: err {err}")
                n_cases += 1
                sweep[(B_s, c)] = graph_ms(calls_s)
    finally:
        sd.self_decode_plan = plan
    picks = {B_s: plan(B_s, H, 448, bf)["cluster"] for B_s in (6, 8)}

    # The 6-row f32 slice shape, host-launched in turns with the plain
    # version (the figure PRs 1-7 kept).
    B6, pos6 = 6, 300
    ck6 = torch.randn((L, B6, 448, D), generator=g, device=dev)
    cv6 = torch.randn((L, B6, 448, D), generator=g, device=dev)
    qkv6 = torch.randn((B6, 1, 3, D), generator=g, device=dev)
    q6, kn6, vn6 = qkv6[..., 0, :], qkv6[..., 1, :], qkv6[..., 2, :]
    host_k, host_p = turns(
        lambda: sd.self_attention_decode_torch(q6, kn6, vn6, ck6, cv6, 1, pos6, H),
        lambda: sd.self_attention_decode(q6, kn6, vn6, ck6, cv6, 1, pos6, H),
    )
    mean = fills[(448, SD_MEAN_POS)]
    rec["self_decode"] = dict(max_abs_err=worst[torch.float32], ms=mean["graph_ms"], plain_ms=plain_ms,
                              bound_ms=mean["bound_ms"], bound_by=mean["bound_by"], library_ms=mean["sdpa_ms"])
    rec["self_decode_detail"] = dict(
        fills={f"T={T} pos={p}": v for (T, p), v in fills.items()},
        cluster_ms={f"{b} rows C={c}": v for (b, c), v in sweep.items()}, plan_cluster=picks,
        host_f32_6rows_pos300=dict(ms=host_k, plain_ms=host_p))
    ft = "; ".join(f"T={T} pos={p}: {v['graph_ms']:.4f} ms (SDPA {v['sdpa_ms']:.4f}, bound {v['bound_ms']:.4f})"
                   for (T, p), v in fills.items())
    st = "; ".join(f"{b} rows (plan {picks[b]}): " + ", ".join(
        f"{c}: {ms:.4f}" for (bb, c), ms in sweep.items() if bb == b) for b in (6, 8))
    log(f"phase 3 self_decode: ok {n_cases} cases (rows 6,48; T 128/256/448 and bucket views; pos 3/127/300; "
        f"every pos of T=128 at rows 1 and 6, host and device positions; the served bf16 8 rows at crops "
        f"128/256/448, pos 3/127/255/300/447; each cluster size); max_abs_err f32={worst[torch.float32]:.3g} "
        f"bf16={worst[bf]:.3g}; row write bit-equal, other rows untouched; bf16 8 rows, CUDA graph over cold "
        f"caches: {ft}; plain {plain_ms:.4f} ms at T=448 pos {SD_MEAN_POS}; by cluster size at T=448 pos 300: "
        f"{st}; host-launched 6 rows f32 pos 300: kernel {host_k:.4f} ms vs plain {host_p:.4f} ms")


# The served window's mean fill: its 444 steps write rows ~4..447.
SD_MEAN_POS = 225


def phase_golden(rec, dev):
    import numpy as np
    import torch

    from norma_tpu_torch.decode import DecodeEngine, SpecialTokens
    from norma_tpu_torch.frontend.mel import log_mel_spectrogram, prepare_audio
    from norma_tpu_torch.model import WhisperConfig, init_params

    with open(os.path.join(ROOT, "tests", "golden", "engine_small.json")) as f:
        golden = json.load(f)
    msp, mtp = 300, 48
    cfg = WhisperConfig(
        num_mel_bins=80, vocab_size=51865, d_model=64, encoder_layers=2,
        encoder_attention_heads=2, decoder_layers=2, decoder_attention_heads=2,
        max_source_positions=msp, max_target_positions=mtp, suppress_tokens=(),
    )
    st = SpecialTokens(sot=50258, eot=50257, task=50359, no_speech=50362,
                       no_timestamps=50363, zero_sec=50364, one_sec=50414)
    engine = DecodeEngine(init_params(cfg, seed=0, device=dev), cfg, st)
    got, reads = {}, []
    for kind in ("tone", "noise", "mix"):
        # tests/test_golden_tokens.py::make_audio(kind, 6.0, seed=1)
        rng = np.random.default_rng(1)
        k = 6 * 16000
        tt = np.arange(k) / 16000.0
        audio = {
            "tone": lambda: 0.3 * np.sin(2 * np.pi * 220 * tt),
            "noise": lambda: 0.1 * rng.standard_normal(k),
            "mix": lambda: 0.15 * np.sin(2 * np.pi * 440 * tt) + 0.05 * rng.standard_normal(k),
        }[kind]().astype(np.float32)
        mel = log_mel_spectrogram(
            torch.from_numpy(prepare_audio(audio, n_frames=2 * msp))[None].to(dev), n_mels=80, n_frames=2 * msp
        )
        state = engine.prefill(engine.encode(mel), 50259)
        h0 = engine.host_syncs
        dr = engine.run_loop(state, 0.0, seed=0)[0]
        reads.append(engine.host_syncs - h0)
        # The same window through the per-step eager loop (no graphs).
        dr_eager = engine.run_loop_eager(state, 0.0, seed=0)[0]
        if dr_eager.tokens != dr.tokens:
            raise AssertionError(f"golden {kind}: graph-loop tokens differ from the per-step loop's")
        got[kind] = dr.tokens == golden["windows"][kind]["tokens"]
        if not got[kind]:
            want = golden["windows"][kind]["tokens"]
            first = next((i for i, (a, b) in enumerate(zip(dr.tokens, want)) if a != b), min(len(dr.tokens), len(want)))
            log(f"  golden {kind}: first difference at token {first} of {len(want)}")
    if not all(got.values()):
        raise AssertionError(f"golden windows differ: {got}")
    if reads != [1, 1, 1]:
        raise AssertionError(f"golden: run_loop host reads {reads}, want one each (its program's fetch)")
    log(f"phase 4 golden: ok windows tone/noise/mix token-exact vs tests/golden/engine_small.json, through "
        f"run_loop's graph ({reads} host reads) and the per-step eager loop (run_loop_eager) alike")


def phase_slice(rec, dev):
    import numpy as np
    import torch

    from norma_tpu_torch.decode import DecodeEngine, LanguageState, SpecialTokens
    from norma_tpu_torch.frontend.mel import log_mel_spectrogram, prepare_audio
    from norma_tpu_torch.model import PRESETS, init_params
    from norma_tpu_torch.model.whisper import cross_kv, decoder_prefill, decoder_step
    from norma_tpu_torch.models.whisper import WhisperModel
    from norma_tpu_torch.ops import loop_cond as lc
    from norma_tpu_torch.ops import sample_step as ss
    from norma_tpu_torch.ops import self_decode as sd

    cfg = PRESETS["distil-large-v3"].with_(
        max_target_positions=448, decode_buckets=(128, 256), self_kv_impl="kernel"
    )
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0, dtype=torch.float32, device=dev)
    torch.cuda.synchronize()
    log(f"  slice params: distil-large-v3 f32 seed 0, {sum(p.numel() for p in params.buffers())} values, "
        f"{time.perf_counter() - t0:.1f} s to make")
    st = SpecialTokens(**ST_V3)
    engine = DecodeEngine(params, cfg, st, language_token_ids=LANG_IDS_V3)

    class IdsTokenizer:
        def decode(self, ids, skip_special_tokens=True):
            return " ".join(str(int(i)) for i in ids)

    windows = []
    inner = engine.transcribe_window

    def recorded(audio, langs, seed, n_active=None):
        torch.cuda.synchronize()
        s0, h0, w0 = engine.decode_steps, engine.host_syncs, time.perf_counter()
        out = inner(audio, langs, seed, n_active)
        torch.cuda.synchronize()
        windows.append(dict(B=int(audio.shape[0]), ms=(time.perf_counter() - w0) * 1e3,
                            steps=engine.decode_steps - s0, syncs=engine.host_syncs - h0))
        return out

    engine.transcribe_window = recorded
    rng = np.random.default_rng(0)
    sr = 16000
    tt = np.arange(30 * sr) / sr
    audio = (0.15 * np.sin(2 * np.pi * 440 * tt) + 0.05 * rng.standard_normal(30 * sr)).astype(np.float32)
    chunks = np.array_split(audio, 3)

    const_model = WhisperModel(engine, IdsTokenizer(), LanguageState(const=LANG_IDS_V3[0]))
    detect_model = WhisperModel(engine, IdsTokenizer(), LanguageState(), language_tokens=LANG_IDS_V3)
    const_model.warmup()
    detect_model.warmup()
    windows.clear()

    # ---- the main path: counters from zero ----
    ss.sample_step.launches = 0
    sd.self_attention_decode.launches = 0
    lc.loop_cond.launches = 0
    torch.cuda.reset_peak_memory_stats(dev)
    texts = {}
    for name, model in (("const", const_model), ("detect", detect_model)):
        out = [model.transcribe(c, final_chunk=(i == 2)) for i, c in enumerate(chunks)]
        if model.longform.buf.size != 0:
            raise AssertionError(f"{name}: buffer not drained ({model.longform.buf.size} samples left)")
        if model.longform.lang.detected is not None:
            raise AssertionError(f"{name}: detected language not cleared by the final chunk")
        texts[name] = out
    b1_windows = len(windows)
    batch = np.stack([prepare_audio(audio * (1.0 + 0.1 * i), 2 * cfg.max_source_positions) for i in range(8)])
    drs, info = engine.transcribe_window(torch.from_numpy(batch), [LANG_IDS_V3[0]] * 8, 11, n_active=5)
    launches = {"sample_step": ss.sample_step.launches, "self_decode": sd.self_attention_decode.launches,
                "loop_cond": lc.loop_cond.launches}
    peak = torch.cuda.max_memory_allocated(dev)
    # ---- end of the main path ----

    if drs[5:] != [None] * 3:
        raise AssertionError(f"pad rows gave results: {drs[5:]}")
    for d in drs[:5]:
        if d is not None and not (all(0 <= x < cfg.vocab_size for x in d.tokens) and len(d.tokens) <= 448):
            raise AssertionError(f"B=8 row out of range: n={len(d.tokens)}")
    for k, v in launches.items():
        if v <= 0:
            raise AssertionError(f"{k} kernel was not launched on the main path")
    for k in ("sample_step", "self_decode", "loop_cond"):
        rec.setdefault(k, {})["launches"] = launches[k]
    # The warm windows' dispatch and their one host read (B=1: the
    # warm-up's shape; B=8: the main path's).
    lang1 = [LANG_IDS_V3[0]]
    one_read = {1: one_read_window(engine, batch[:1], lang1, 5)[1],
                8: one_read_window(engine, batch, lang1 * 8, 11, n_active=5)[1]}

    # Full-width agreement: one decode step through the kernel vs the plain
    # ("xla") self-attention on the same prefill, logits compared.
    mel = log_mel_spectrogram(
        torch.from_numpy(batch[:1]).to(dev), n_mels=cfg.num_mel_bins, n_frames=2 * cfg.max_source_positions
    )
    feats = engine.encode(mel)
    xk, xv = cross_kv(params, cfg, feats)
    prefix = torch.tensor([[st.sot, LANG_IDS_V3[0], st.task]], device=dev)
    _, ck, cv = decoder_prefill(params, cfg, prefix, xk, xv)
    tok = torch.tensor([st.zero_sec], device=dev)
    lk, _, _ = decoder_step(params, cfg, tok, 3, ck.clone(), cv.clone(), xk, xv)
    lx, _, _ = decoder_step(params, cfg.with_(self_kv_impl="xla"), tok, 3, ck.clone(), cv.clone(), xk, xv)
    step_err = float((lk - lx).abs().max())
    if not (torch.isfinite(lk).all() and step_err < 1e-3):
        raise AssertionError(f"full-width step kernel vs plain: max abs logit diff {step_err}")

    b1 = windows[:b1_windows]
    b8 = windows[b1_windows:]
    # The window graphs against the per-step eager loop on the same windows
    # (f32: tokens equal), and the device's idle share under
    # torch.profiler, graph and eager.
    one = torch.from_numpy(batch[:1])
    modes_b1 = window_modes(engine, one, lang1, 5)
    modes_b8 = window_modes(engine, torch.from_numpy(batch), lang1 * 8, 11, n_active=5)
    idle = {"graph": idle_share(lambda: engine.transcribe_window(one, lang1, 5), "slice_graph"),
            "eager": idle_share(lambda: engine.transcribe_window_eager(one, lang1, 5), "slice_eager")}
    graphs = window_graph_stats(engine)
    rec["slice"] = dict(windows_b1=b1, window_b8=b8, peak_bytes=peak, launches=launches, step_logit_err=step_err,
                        modes_b1=modes_b1, modes_b8=modes_b8, idle_b1=idle, one_read=one_read, graphs=graphs)
    ms_b1 = [round(w["ms"], 1) for w in b1]
    log(f"phase 5 slice: ok distil-large-v3 mtp=448 buckets=(128,256) kernel f32; "
        f"B=1 windows={len(b1)} wall_ms={ms_b1} steps={[w['steps'] for w in b1]} "
        f"host_syncs={[w['syncs'] for w in b1]}; B=8 (n_active=5, sequential ladder) wall_ms={b8[0]['ms']:.1f} "
        f"steps={b8[0]['steps']} host_syncs={b8[0]['syncs']}; peak_mem={peak / 2**30:.2f} GiB; "
        f"launches={launches}; kernel-vs-plain step logit err={step_err:.3g}; "
        f"texts const={[len(x) for x in texts['const']]} detect={[len(x) for x in texts['detect']]} chars")
    log(f"  slice B=1 window, graph vs per-step eager loop (tokens equal): {modes_text(modes_b1)}")
    log(f"  slice B=8 window (n_active=5), graph vs eager (tokens equal): {modes_text(modes_b8)}")
    log(f"  slice B=1 idle share under torch.profiler: " + "; ".join(
        f"{m}: wall {v[0]:.1f} ms, device busy {v[1]:.1f} ms, idle {v[2]:.1%} ({v[3]} device events)"
        for m, v in idle.items()))
    for B, r in one_read.items():
        log(f"  slice warm B={B} window: {one_read_text(r)}")
    log(f"  slice window graphs: {graph_stats_text(graphs)}")


# --------------------------------------------------------------------------
# Phases 6-9: the batched serving slice's kernels and the slice itself.
# --------------------------------------------------------------------------

SERVE_H, SERVE_D, SERVE_TA = 20, 1280, 1500
# Phase 9 feeds its streams at this multiple of real time: a ~1.5-2.2 s
# round then takes in 4.5-6.6 s of each stream's audio, under the 9.6 s
# (8 chunks of 1.2 s) its audio ring holds.
FEED_SPEED = 3.0
FEED_BLOCK = 1600  # samples per stream per tick (0.1 s)


def _quant_xkv(x, limit):
    """Per-channel codes of [L, B, Ta, D] f32 (the engine's quantizer)."""
    from norma_tpu_torch.model.whisper import _quantize_xkv

    return _quantize_xkv(x, limit)


def phase_cross_decode(rec, dev):
    import torch

    from norma_tpu_torch.ops import paged_cross as pc

    H, D, L, Ta = SERVE_H, SERVE_D, 2, SERVE_TA
    g = torch.Generator(device=dev).manual_seed(6)
    # Tolerances: bf16 outputs round once (2**-8 relative at |out| <= ~0.5,
    # plus a p on a bf16 rounding boundary in one summation order); f32
    # outputs differ by summation order and such a p only.
    tol = {torch.bfloat16: 4e-3, torch.float32: 1e-4}
    worst = {torch.bfloat16: 0.0, torch.float32: 0.0}
    n_cases = 0
    timed = {}
    for int4 in (False, True):
        for B in (1, 8, 48):
            xk = torch.randn((L, B, Ta, D), generator=g, device=dev)
            xv = torch.randn((L, B, Ta, D), generator=g, device=dev)
            limit = 7.0 if int4 else 127.0
            kp, vp = (pc.prep_cross_kv_kernel4 if int4 else pc.prep_cross_kv_kernel)(
                _quant_xkv(xk, limit), _quant_xkv(xv, limit), H
            )
            for G in (1, 6):
                for dtype in (torch.bfloat16, torch.float32):
                    q = torch.randn((G * B, 1, D), generator=g, device=dev).to(dtype)
                    outs = [(pc.cross_attention_q8_kernel_stacked(q, kp, vp, li, H, G),
                             pc.cross_attention_decode_torch(q, kp, vp, li, H, G)) for li in (0, 1)]
                    k1 = {k: v[1] for k, v in kp.items()}
                    v1 = {k: v[1] for k, v in vp.items()}
                    outs.append((pc.cross_attention_q8_kernel(q, k1, v1, H, G),
                                 pc.cross_attention_decode_torch(q, kp, vp, 1, H, G)))
                    torch.cuda.synchronize()
                    for ko, po in outs:
                        if ko.dtype != dtype or ko.shape != po.shape or not torch.isfinite(ko).all():
                            raise AssertionError(f"cross_decode int4={int4} B={B} G={G} {dtype}: bad output")
                        err = float((ko.float() - po.float()).abs().max())
                        if not err <= tol[dtype]:
                            raise AssertionError(f"cross_decode int4={int4} B={B} G={G} {dtype}: err {err}")
                        worst[dtype] = max(worst[dtype], err)
                        n_cases += 1
            for B_t, G_t in ((8, 1), (1, 6)):
                if B == B_t:
                    q = torch.randn((G_t * B, 1, D), generator=g, device=dev).to(torch.bfloat16)
                    timed[(int4, B_t, G_t)] = turns(
                        lambda: pc.cross_attention_decode_torch(q, kp, vp, 1, H, G_t),
                        lambda: pc.cross_attention_q8_kernel_stacked(q, kp, vp, 1, H, G_t),
                    )

    # Edge shapes: key counts that leave short and empty tiles and pieces,
    # every G, and each cluster size on them, bf16 and f32 q, both held to
    # the bf16 tolerance: at 37-200 keys one p weighs up to ~1/10 of its row,
    # so a p on a bf16 rounding boundary that another summation order of its
    # logit rounds the other way moves an output by up to ~2**-8 * 0.1 *
    # |v| ~ 1e-3; at Ta=1500 each p weighs ~1/1500 and f32 holds to 1e-4.
    plan, edge_worst = pc.cross_decode_plan, 0.0
    try:
        for int4, Ta_e in ((False, 37), (False, 200), (True, 38), (True, 200)):
            limit = 7.0 if int4 else 127.0
            xk = torch.randn((L, 2, Ta_e, D), generator=g, device=dev)
            xv = torch.randn((L, 2, Ta_e, D), generator=g, device=dev)
            kp, vp = (pc.prep_cross_kv_kernel4 if int4 else pc.prep_cross_kv_kernel)(
                _quant_xkv(xk, limit), _quant_xkv(xv, limit), H)
            for G in range(1, 9):
                for dtype in (torch.bfloat16, torch.float32):
                    q = torch.randn((G * 2, 1, D), generator=g, device=dev).to(dtype)
                    want = pc.cross_attention_decode_torch(q, kp, vp, 1, H, G)
                    for c in (1, 2, 4, 8, 16):
                        pc.cross_decode_plan = _cross_plan_at(plan, c)
                        got = pc.cross_attention_q8_kernel_stacked(q, kp, vp, 1, H, G)
                        err = float((got.float() - want.float()).abs().max())
                        if not err <= tol[torch.bfloat16]:
                            raise AssertionError(f"cross_decode edge int4={int4} Ta={Ta_e} G={G} C={c} {dtype}: "
                                                 f"err {err}")
                        edge_worst = max(edge_worst, err)
                        n_cases += 1
    finally:
        pc.cross_decode_plan = plan

    # Device ms from CUDA graphs at the path's shapes (bf16 q, Ta=1500):
    # B=8 G=1 (the served batch) and B=1 G=6 (the ladder), int8 and int4,
    # cycling over enough layers of codes (>= 60 MB) that they come from
    # device memory, not the 50 MB L2, as in the token loop; each cluster
    # size against the plan's, its output held to the plain version.
    # Bound: one layer's K and V codes and scales read, q in, the output out.
    graphs, sweep, picks = {}, {}, {}
    try:
        for int4 in (False, True):
            for B, G in ((8, 1), (1, 6)):
                limit = 7.0 if int4 else 127.0
                n_sets = 2 if B == 8 else 8
                sets = []
                for _ in range(n_sets):
                    xk = torch.randn((L, B, Ta, D), generator=g, device=dev)
                    xv = torch.randn((L, B, Ta, D), generator=g, device=dev)
                    sets.append((pc.prep_cross_kv_kernel4 if int4 else pc.prep_cross_kv_kernel)(
                        _quant_xkv(xk, limit), _quant_xkv(xv, limit), H))
                q = torch.randn((G * B, 1, D), generator=g, device=dev).to(torch.bfloat16)
                calls = [lambda kv=kv, li=li: pc.cross_attention_q8_kernel_stacked(q, kv[0], kv[1], li, H, G)
                         for kv in sets for li in range(L)]
                kp, vp = sets[0]
                layer1 = [t[1] for t in list(kp.values()) + list(vp.values())]
                key = f"int{4 if int4 else 8} B={B} G={G}"
                b_ms, b_by = bound(nbytes(*layer1) + 2 * nbytes(q))
                graphs[key] = dict(graph_ms=(graph_ms(calls) + graph_ms(calls)) / 2, bound_ms=b_ms, bound_by=b_by)
                want = pc.cross_attention_decode_torch(q, kp, vp, 1, H, G)
                picks[key] = plan(B, H, G, Ta, int4)["cluster"]
                for c in (1, 2, 4, 8, 16):
                    pc.cross_decode_plan = _cross_plan_at(plan, c)
                    try:
                        got = pc.cross_attention_q8_kernel_stacked(q, kp, vp, 1, H, G)
                    except ValueError:  # this cluster's share does not fit the shared memory
                        continue
                    err = float((got.float() - want.float()).abs().max())
                    if not err <= tol[torch.bfloat16]:
                        raise AssertionError(f"cross_decode {key} C={c}: err {err}")
                    n_cases += 1
                    sweep[(key, c)] = graph_ms(calls)
                pc.cross_decode_plan = plan
    finally:
        pc.cross_decode_plan = plan
    k_ms, p_ms = timed[(False, 8, 1)]
    main = graphs["int8 B=8 G=1"]
    rec["cross_decode"] = dict(max_abs_err=worst[torch.bfloat16], ms=main["graph_ms"], plain_ms=p_ms,
                               bound_ms=main["bound_ms"], bound_by=main["bound_by"], library_ms=None)
    rec["cross_decode_times"] = {f"int{4 if k[0] else 8} B={k[1]} G={k[2]}": v for k, v in timed.items()}
    rec["cross_decode_detail"] = dict(graphs=graphs, plan_cluster=picks,
                                      cluster_ms={f"{k} C={c}": v for (k, c), v in sweep.items()})
    times = "; ".join(f"{k}: kernel {v[0]:.4f} ms vs plain {v[1]:.4f} ms" for k, v in rec["cross_decode_times"].items())
    gt = "; ".join(f"{k}: {v['graph_ms']:.4f} ms (bound {v['bound_ms']:.4f}, {v['bound_by']}; by cluster size, plan "
                   f"{picks[k]}: " + ", ".join(f"{c}: {ms:.4f}" for (kk, c), ms in sweep.items() if kk == k) + ")"
                   for k, v in graphs.items())
    log(f"phase 6 cross_decode: ok {n_cases} cases (int8/int4, B 1/8/48, G 1/6, stacked li 0/1 and per-layer, "
        f"bf16/f32; Ta 37/38/200 at G 1-8 and each cluster size); max_abs_err bf16={worst[torch.bfloat16]:.3g} "
        f"f32={worst[torch.float32]:.3g}, at Ta 37-200 {edge_worst:.3g}; host-launched {times} (Ta=1500, D=1280, H=20, bf16 q); CUDA graph over "
        f"cold codes: {gt}")


def _cross_plan_at(plan, c):
    """cross_decode_plan with the cluster set to ``c`` (the sweep's)."""
    from norma_tpu_torch.ops import paged_cross as pc

    def at(B, H, G, Ta, int4):
        share = -(-(Ta // 2 if int4 else Ta) // c)
        pitch = -(-share // 16) * 16 * (2 if int4 else 1) + (8 if int4 else 4)
        if 4 * G * pitch > pc._XD_SMEM:
            raise ValueError(f"cluster {c}: {4 * G * pitch} bytes of logits")
        return {**plan(B, H, G, Ta, int4), "cluster": c, "share": share, "pitch": pitch, "smem_bytes": 4 * G * pitch}
    return at


def phase_flash_encoder(rec, dev, lengths=(1500, 200, 37)):
    import torch
    import torch.nn.functional as F

    from norma_tpu_torch.ops import flash_encoder as fe

    H, D = SERVE_H, SERVE_D
    dh = D // H
    g = torch.Generator(device=dev).manual_seed(7)
    # Tolerances: bf16 outputs round once and the online softmax rounds p
    # at running (not final) maxima: ~2 bf16 ulps at |out| <= 1; f32 is
    # summation order only.
    tol = {torch.bfloat16: 1.6e-2, torch.float32: 1e-5}
    worst = {torch.bfloat16: 0.0, torch.float32: 0.0}
    n_cases = 0
    for dtype in (torch.bfloat16, torch.float32):
        for B in (1, 8):
            for T in lengths:
                for fused in (True, False):
                    if fused:
                        qkv = torch.randn((B, T, 3, D), generator=g, device=dev).to(dtype)
                        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]  # fused-QKV slices
                    else:
                        q, k, v = (torch.randn((B, T, D), generator=g, device=dev).to(dtype) for _ in range(3))
                    ko = fe.flash_self_attention(q, k, v, H)
                    po = fe.flash_attention_torch(q, k, v, H)
                    torch.cuda.synchronize()
                    if ko.dtype != dtype or ko.shape != (B, T, D) or not torch.isfinite(ko).all():
                        raise AssertionError(f"flash {dtype} B={B} T={T} fused={fused}: bad output")
                    err = float((ko.float() - po.float()).abs().max())
                    if not err <= tol[dtype]:
                        raise AssertionError(f"flash {dtype} B={B} T={T} fused={fused}: err {err}")
                    worst[dtype] = max(worst[dtype], err)
                    n_cases += 1
    times = {}
    T = lengths[0]
    for B in (8, 1):
        qkv = torch.randn((B, T, 3, D), generator=g, device=dev).to(torch.bfloat16)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        heads = lambda x: x.unflatten(-1, (H, dh)).transpose(1, 2)  # [B, H, T, dh] views
        qh, kh, vh = heads(q), heads(k), heads(v)
        k_ms, p_ms = turns(lambda: fe.flash_attention_torch(q, k, v, H), lambda: fe.flash_self_attention(q, k, v, H))
        # The library yardstick (never called by the port): SDPA computes
        # the same non-causal attention with scale dh**-0.5.
        sdpa_ms = cuda_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh))
        b_ms, b_by = bound(4 * B * T * D * 2, 4 * B * H * T * T * dh, "bf16")
        times[B] = dict(ms=k_ms, plain_ms=p_ms, library_ms=sdpa_ms, bound_ms=b_ms, bound_by=b_by)
    t8 = times[8]
    rec["flash_encoder"] = dict(max_abs_err=worst[torch.bfloat16], ms=t8["ms"], plain_ms=t8["plain_ms"],
                                bound_ms=t8["bound_ms"], bound_by=t8["bound_by"], library_ms=t8["library_ms"])
    rec["flash_times"] = {f"B={B} T=1500 bf16": v for B, v in times.items()}
    txt = "; ".join(f"B={B}: kernel {v['ms']:.4f} ms vs plain {v['plain_ms']:.3f} ms, SDPA {v['library_ms']:.4f} ms, "
                    f"bound {v['bound_ms']:.4f} ms ({v['bound_by']}), {v['bound_ms'] / v['ms']:.1%} of bound"
                    for B, v in times.items())
    log(f"phase 7 flash_encoder: ok {n_cases} cases (T 1500/200/37, B 1/8, bf16/f32, fused-QKV slices and "
        f"separate tensors); max_abs_err bf16={worst[torch.bfloat16]:.3g} f32={worst[torch.float32]:.3g}; "
        f"at T=1500 bf16 H=20: {txt}")


Q8_SHAPES = ((1280, 3840), (1280, 1280), (1280, 5120), (5120, 1280))


def phase_q8a8(rec, dev, rows=(12000, 1500, 1507), shapes=Q8_SHAPES):
    import torch

    from norma_tpu_torch.ops import quant_matmul as qm

    g = torch.Generator(device=dev).manual_seed(8)
    times, n_cases = {}, 0
    for K, N in shapes:
        # The weight codes as the encoder holds them: [K, N] values, K-major.
        wq = qm.kmajor_codes(torch.randint(-127, 128, (K, N), device=dev, dtype=torch.int8, generator=g))
        ws = torch.rand((N,), device=dev, generator=g) * 0.02
        b = torch.randn((N,), device=dev, generator=g)
        for M in rows:  # B=8 and B=1 windows, and a ragged M
            xq = torch.randint(-127, 128, (M, K), device=dev, dtype=torch.int8, generator=g)
            xs = torch.rand((M, 1), device=dev, generator=g) * 0.02
            ones_m, ones_n = torch.ones((M, 1), device=dev), torch.ones((N,), device=dev)
            # Unit scales, no bias: the output is float(acc) -- bit-equal iff
            # the int32 accumulation is exact.
            if not torch.equal(qm.q8a8_dense(xq, ones_m, wq, ones_n), qm.q8a8_dense_torch(xq, ones_m, wq, ones_n)):
                raise AssertionError(f"q8a8 M={M} K={K} N={N}: int32 accumulation differs from the exact product")
            # The f32 epilogue acc*xs*ws+b runs in the same order of correctly
            # rounded f32 operations in both versions, and the bf16 output is
            # one rounding of it: stated tolerance 0.
            for out_dtype in (torch.float32, torch.bfloat16):
                ko = qm.q8a8_dense(xq, xs, wq, ws, b, out_dtype=out_dtype)
                po = qm.q8a8_dense_torch(xq, xs, wq, ws, b, out_dtype=out_dtype)
                torch.cuda.synchronize()
                if ko.dtype != out_dtype or not torch.equal(ko, po):
                    err = float((ko.float() - po.float()).abs().max())
                    raise AssertionError(f"q8a8 M={M} K={K} N={N} {out_dtype}: epilogue err {err}")
            n_cases += 1
            if M == rows[0]:
                kt = turns(lambda: qm.q8a8_dense_torch(xq, xs, wq, ws, b), lambda: qm.q8a8_dense(xq, xs, wq, ws, b))
                bf16_ms = cuda_ms(lambda: qm.q8a8_dense(xq, xs, wq, ws, b, out_dtype=torch.bfloat16))
                # Yardsticks, never called by the port: torch._int_mm computes
                # the kernel's int32 product (no epilogue); a bf16 cuBLAS
                # product of the same shape.
                int_mm_ms = cuda_ms(lambda: torch._int_mm(xq, wq))
                xb, wb = xq.to(torch.bfloat16), wq.to(torch.bfloat16)
                cublas_ms = cuda_ms(lambda: torch.matmul(xb, wb))
                del xb, wb
                b_ms, b_by = bound(nbytes(xq, xs, wq, ws, b) + 4 * M * N, 2 * M * N * K, "int8")
                b16_ms, _ = bound(nbytes(xq, xs, wq, ws, b) + 2 * M * N, 2 * M * N * K, "int8")
                times[(K, N)] = dict(ms=kt[0], plain_ms=kt[1], bf16_out_ms=bf16_ms, library_ms=int_mm_ms,
                                     cublas_bf16_ms=cublas_ms, bound_ms=b_ms, bound_by=b_by,
                                     bf16_out_bound_ms=b16_ms)
            elif M == rows[1]:
                times[(K, N, M)] = dict(ms=cuda_ms(lambda: qm.q8a8_dense(xq, xs, wq, ws, b)),
                                        plan=qm.q8a8_plan(M, N, K)["bn"])
    # A [K, N]-contiguous weight (params no engine prepped) runs through a
    # K-major copy, with the same result.
    if not torch.equal(qm.q8a8_dense(xq, xs, wq.contiguous(), ws, b), qm.q8a8_dense(xq, xs, wq, ws, b)):
        raise AssertionError("q8a8 kernel on [K, N]-contiguous codes differs from K-major codes")
    t = times[shapes[0]]
    rec["q8a8"] = dict(max_abs_err=0.0, ms=t["ms"], plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
                       bound_by=t["bound_by"], library_ms=t["library_ms"])
    rec["q8a8_times"] = {"K={} N={}".format(*k) + f" M={k[2] if len(k) > 2 else rows[0]}": v
                         for k, v in times.items()}
    txt = "; ".join(
        f"{k}: kernel {v['ms']:.4f} ms (bf16 out {v['bf16_out_ms']:.4f}) vs plain {v['plain_ms']:.3f}, _int_mm "
        f"{v['library_ms']:.4f}, bf16 cuBLAS {v['cublas_bf16_ms']:.4f}, bound {v['bound_ms']:.4f} ({v['bound_by']}; "
        f"bf16 out {v['bf16_out_bound_ms']:.4f}), {v['bound_ms'] / v['ms']:.1%} of bound"
        if "plain_ms" in v else f"{k}: kernel {v['ms']:.4f} ms (tile 128x{v['plan']})"
        for k, v in rec["q8a8_times"].items())
    log(f"phase 8 q8a8: ok {n_cases} cases ({len(shapes)} shapes x M {'/'.join(map(str, rows))}): int32 accumulation bit-exact, f32 "
        f"and bf16 epilogues bit-equal, [K, N]-contiguous codes copied K-major with the same result; {txt}")


def _serving_params(cfg, dev):
    import torch

    from norma_tpu_torch.model import fuse_qkv, init_params
    from norma_tpu_torch.model.quant import quantize_decoder, quantize_encoder

    params = fuse_qkv(init_params(cfg, seed=0, dtype=torch.bfloat16, device=dev))
    return quantize_encoder(quantize_decoder(params))


class LockstepFeed:
    """``len(durations)`` synthetic streams (tone + noise, a distinct
    frequency and noise seed each) fed from ONE thread at FEED_SPEED x real
    time.  Every tick sends each live stream's next FEED_BLOCK samples while
    holding ``lock`` (the scheduler's), so the streams' chunks land in the
    same drain and the rounds take all live streams together.  Feeding
    starts once every source has been started; ``sources[i]`` is stream
    i's AudioSource."""

    def __init__(self, durations, sr, lock):
        import threading

        import numpy as np

        from norma_tpu_torch.audio.sources import AudioSource

        feed = self

        class Source(AudioSource):
            sample_rate, channels, dtype = sr, 1, np.dtype(np.float32)

            def __init__(self, i, dur):
                n = int(dur * sr)
                t = np.arange(n) / sr
                noise = np.random.default_rng(100 + i).standard_normal(n)
                self.audio = (0.2 * np.sin(2 * np.pi * (180.0 + 37.0 * i) * t) + 0.05 * noise).astype(np.float32)
                self.pos, self.cb, self.stopped = 0, None, False

            def start(self, on_data, on_end=None):
                self.cb = (on_data, on_end)
                with feed._cond:
                    feed._started += 1
                    feed._cond.notify_all()

            def stop(self):
                self.stopped = True

        self.sources = [Source(i, d) for i, d in enumerate(durations)]
        self.sr, self.lock = sr, lock
        self._started = 0
        self._cond = threading.Condition()
        self._halt = threading.Event()
        self._thread = threading.Thread(target=self._run, name="lockstep-feed", daemon=True)
        self._thread.start()

    def _run(self):
        with self._cond:
            while self._started < len(self.sources) and not self._halt.is_set():
                self._cond.wait(0.1)
        t0, k = time.monotonic(), 0
        live = list(self.sources)
        while live and not self._halt.is_set():
            k += 1
            due = t0 + k * FEED_BLOCK / self.sr / FEED_SPEED
            if self._halt.wait(max(0.0, due - time.monotonic())):
                break
            with self.lock:
                for s in live:
                    if s.stopped:
                        continue
                    on_data, on_end = s.cb
                    blk = s.audio[s.pos:s.pos + FEED_BLOCK]
                    s.pos += len(blk)
                    on_data(blk)
                    if s.pos >= len(s.audio):
                        s.stopped = True
                        if on_end is not None:
                            on_end()
            live = [s for s in live if not s.stopped]

    def close(self):
        self._halt.set()
        self._thread.join(timeout=10)


def serve_streams(model, n_streams, seconds, timeout=600.0, mesh=None):
    """Serve ``n_streams`` concurrent synthetic streams, fed in lockstep
    (LockstepFeed), through a BatchedTranscriber(max_streams=8, mesh=mesh)
    after warmup().  Returns a report:
    per-round records, rounds per stream, texts, metrics, drop accounting,
    launch counts.  On a mesh a round's wall runs from the first replica's
    start to the last one's end (each replica's stream synchronized), its
    steps and host syncs summed over the replicas."""
    import threading

    import torch

    from norma_tpu_torch.decode.longform import LongFormDecoder
    from norma_tpu_torch.input import Settings
    from norma_tpu_torch.ops import flash_encoder, paged_cross, quant_matmul, sample_step, self_decode
    from norma_tpu_torch.runtime import batching
    from norma_tpu_torch.runtime.channels import RecycledRing

    engine = model.engine
    cuda = engine.device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    bt = batching.BatchedTranscriber(model, max_streams=8, mesh=mesh)
    t0 = time.perf_counter()
    bt.warmup()
    warm_s = time.perf_counter() - t0

    rounds, pad_bad, open_rounds = [], [], {}
    inner_async, inner_fetch = engine.transcribe_window_async, engine.transcribe_window_fetch

    def fetched(pending):
        """Fetch a round; its steps and host reads at the fetch go to its
        record (a window graph counts them there)."""
        s0, h0 = engine.decode_steps, engine.host_syncs
        out = inner_fetch(pending)
        r = open_rounds.pop(id(pending))
        r.update(fetch_steps=engine.decode_steps - s0, fetch_syncs=engine.host_syncs - h0)
        return out

    def timed_async(audio, langs, seed, n_active=None):
        sync()
        s0, h0, w0 = engine.decode_steps, engine.host_syncs, time.perf_counter()
        out = inner_async(audio, langs, seed, n_active)
        sync()
        rounds.append(dict(B=int(audio.shape[0]), n_active=n_active, ms=(time.perf_counter() - w0) * 1e3,
                           steps=engine.decode_steps - s0, syncs=engine.host_syncs - h0))
        open_rounds[id(out)] = rounds[-1]
        return out

    def checked_fetch(pending):
        active = pending.meta[0] if hasattr(pending, "meta") else pending[1]
        drs, info = fetched(pending)
        if any(d is not None for d, a in zip(drs, active) if not a):
            pad_bad.append(list(active))
        return drs, info

    # Drop accounting: samples each decoder was fed, samples each ring
    # dropped; windows each decoder applied (its rounds).
    fed, dropped, applied = {}, {}, {}
    orig_feed, orig_send, orig_apply = LongFormDecoder.feed, RecycledRing.try_send, LongFormDecoder.apply_result

    def feed(self, data):
        fed[id(self)] = fed.get(id(self), 0) + len(data)
        return orig_feed(self, data)

    def try_send(self, data, length, final=None, stamp=None):
        before = self.dropped
        ok = orig_send(self, data, length, final, stamp)
        if self.dropped != before:
            dropped[id(self)] = dropped.get(id(self), 0) + length
        return ok

    def apply_result(self, dr, final_chunk):
        applied[id(self)] = applied.get(id(self), 0) + 1
        return orig_apply(self, dr, final_chunk)

    counters = (sample_step.sample_step, self_decode.self_attention_decode,
                paged_cross.cross_attention_q8_kernel_stacked, flash_encoder.flash_self_attention,
                quant_matmul.q8a8_dense, quant_matmul.w8_matmul)
    spans, restore = {}, []
    remote = [r.engine for r in getattr(engine, "replicas", []) if r.remote]
    if mesh is not None:
        # The dp engine's dispatch returns at once: time each replica's part
        # in its own thread, its stream synchronized (the k-th part of every
        # replica is round k's: every round's batch divides over dp).  A
        # replica in worker processes runs its window on their streams: its
        # part ends at its fetch, so its span is dispatch to fetch (the
        # pipelined scheduler fetches round k after it dispatches round
        # k + 1), not dispatch to the device's end.
        for i, rep in enumerate(engine.replicas):
            e = rep.engine
            part, fetch, starts = e.transcribe_window_async, e.transcribe_window_fetch, []

            def timed_part(audio, langs, seed, n_active=None, i=i, e=e, part=part, starts=starts, remote=rep.remote):
                s0, h0, w0 = e.decode_steps, e.host_syncs, time.perf_counter()
                out = part(audio, langs, seed, n_active)
                if remote:
                    starts.append(w0)
                    return out
                if cuda:
                    torch.cuda.current_stream().synchronize()  # the replica's stream
                spans.setdefault(i, []).append((w0, time.perf_counter(), e.decode_steps - s0, e.host_syncs - h0))
                return out

            def timed_fetch(pending, i=i, fetch=fetch, starts=starts):
                out = fetch(pending)  # its steps and reads count in the round's fetch
                spans.setdefault(i, []).append((starts.pop(0), time.perf_counter(), 0, 0))
                return out

            e.transcribe_window_async = timed_part
            if rep.remote:
                e.transcribe_window_fetch = timed_fetch
            restore.append(e)
        rounds_n = {}

        def timed_async(audio, langs, seed, n_active=None):
            out = inner_async(audio, langs, seed, n_active)
            rounds_n[id(out)] = n_active
            rounds.append(dict(B=int(audio.shape[0]), n_active=n_active))
            open_rounds[id(out)] = rounds[-1]
            return out

        def checked_fetch(pending):
            n = rounds_n.pop(id(pending))
            drs, info = fetched(pending)
            if n is not None and any(d is not None for d in drs[n:]):
                pad_bad.append((len(drs), n))
            return drs, info

    engine.transcribe_window_async, engine.transcribe_window_fetch = timed_async, checked_fetch
    LongFormDecoder.feed, RecycledRing.try_send, LongFormDecoder.apply_result = feed, try_send, apply_result
    sr = 16000
    durations = [seconds[0] + (seconds[1] - seconds[0]) * i / max(n_streams - 1, 1) for i in range(n_streams)]
    src = LockstepFeed(durations, sr, bt._lock)
    try:
        # ---- the main path: counts from zero ----
        for c in counters:
            c.launches = 0
        for e in remote:
            e.launches(reset=True)
        captures0 = engine.graph_captures
        if cuda:
            torch.cuda.reset_peak_memory_stats(engine.device)
        w_start = time.perf_counter()
        handles = [bt.blocking_start(Settings(source=s)) for s in src.sources]
        streams = [bt._streams[h._sid] for h in handles]
        texts = {}
        readers = [threading.Thread(target=lambda i=i, h=h: texts.setdefault(i, list(h.receiver)), daemon=True)
                   for i, h in enumerate(handles)]
        for th in readers:
            th.start()
        for th in readers:
            th.join(timeout=timeout)
        sync()
        wall_s = time.perf_counter() - w_start
        launches = {c.__name__: c.launches for c in counters}
        for e in remote:  # positions in worker processes launch there: every rank's counters
            for k, n in worker_launches(e.launches(), counters).items():
                launches[k] += n
        captures = engine.graph_captures - captures0
        peak = torch.cuda.max_memory_allocated(engine.device) if cuda else 0
        # ---- end of the main path ----
        metrics = bt.metrics()
    finally:
        engine.transcribe_window_async, engine.transcribe_window_fetch = inner_async, inner_fetch
        for e in restore:
            del e.transcribe_window_async
            e.__dict__.pop("transcribe_window_fetch", None)
        LongFormDecoder.feed, RecycledRing.try_send, LongFormDecoder.apply_result = orig_feed, orig_send, orig_apply
        bt.close()
        src.close()
    if mesh is not None:  # the replicas' spans of every round (warmup's windows ran before the rounds)
        served = {i: v[-len(rounds):] for i, v in spans.items()} if rounds else {}
        for k, r in enumerate(rounds):
            parts = [served[i][k] for i in sorted(served)]
            r.update(ms=(max(p[1] for p in parts) - min(p[0] for p in parts)) * 1e3,
                     steps=sum(p[2] for p in parts), syncs=sum(p[3] for p in parts))
    for r in rounds:  # a round's steps and host reads: its dispatch's and its fetch's
        r["steps"] += r.pop("fetch_steps", 0)
        r["syncs"] += r.pop("fetch_syncs", 0)
    alive = [i for i, th in enumerate(readers) if th.is_alive()]
    accounting = []
    for i, s in enumerate(streams):
        total = int(durations[i] * sr)
        got = fed.get(id(s.state), 0) + dropped.get(id(s.ring), 0)
        accounting.append((total, fed.get(id(s.state), 0), dropped.get(id(s.ring), 0), s.ring.dropped))
        if got not in (total - 1, total):
            raise AssertionError(f"stream {i}: fed {fed.get(id(s.state), 0)} + dropped "
                                 f"{dropped.get(id(s.ring), 0)} samples != produced {total}")
    return dict(rounds=rounds, texts=texts, metrics=metrics, alive=alive, pad_bad=pad_bad,
                launches=launches, captures=captures, peak=peak, peak_device=str(engine.device), wall_s=wall_s,
                warm_s=warm_s, accounting=accounting,
                stream_rounds=[applied.get(id(s.state), 0) for s in streams],
                ring_drops=sum(a[3] for a in accounting), bt_closed=not bt._thread.is_alive())


def check_served(rep, n_streams):
    if rep["alive"]:
        raise AssertionError(f"receivers of streams {rep['alive']} never closed")
    if len(rep["texts"]) != n_streams:
        raise AssertionError(f"only {len(rep['texts'])} of {n_streams} receivers finished")
    if not rep["bt_closed"]:
        raise AssertionError("the scheduler thread did not exit on close()")
    if rep["pad_bad"]:
        raise AssertionError(f"pad rows gave results: {rep['pad_bad']}")
    m = rep["metrics"]
    if m["audio_drops"] != 0 or rep["ring_drops"] != 0:
        raise AssertionError(f"audio dropped: metrics {m['audio_drops']}, rings {rep['ring_drops']} chunks")
    if m["transcript_drops"] != 0:
        raise AssertionError(f"{m['transcript_drops']} transcripts dropped with every receiver reading")
    if min(rep["stream_rounds"]) < 3:
        raise AssertionError(f"rounds per stream {rep['stream_rounds']}: want >= 3 each")
    if not any(r["n_active"] == n_streams for r in rep["rounds"]):
        raise AssertionError(f"no round served all {n_streams} streams: "
                             f"{[(r['B'], r['n_active']) for r in rep['rounds']]}")
    missing = [k for k, v in rep["launches"].items() if v <= 0]
    if missing:
        raise AssertionError(f"kernels not launched during the served rounds: {missing}")


def phase_serving(rec, dev, cfg=None, params=None, st=None, lang_ids=None, seconds=(20.0, 40.0)):
    """The serving slice at full width (the defaults); a CPU rehearsal
    passes a tiny config, its params, tokens and shorter streams."""
    import numpy as np
    import torch

    from norma_tpu_torch.decode import DecodeEngine, LanguageState, SpecialTokens
    from norma_tpu_torch.frontend.mel import log_mel_spectrogram, prepare_audio
    from norma_tpu_torch.model import PRESETS
    from norma_tpu_torch.model.whisper import decoder_step, encode, quantize_cross_kv
    from norma_tpu_torch.models.whisper import WhisperModel
    from norma_tpu_torch.ops import paged_cross

    cuda = torch.device(dev).type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    if cfg is None:
        cfg = PRESETS["distil-large-v3"].with_(
            max_target_positions=448, decode_buckets=(128, 256), encoder_attn_impl="jax_flash",
            cross_kv_impl="kernel", self_kv_impl="kernel",
        )
        st, lang_ids = SpecialTokens(**ST_V3), LANG_IDS_V3
    t0 = time.perf_counter()
    if params is None:
        params = _serving_params(cfg, dev)
    sync()
    nbytes = sum(p.numel() * p.element_size() for p in params.buffers())
    log(f"  serving params: bf16 seed 0, fused QKV, w8a8 encoder + int8 decoder/head, "
        f"{nbytes / 2**30:.2f} GiB on the device, {time.perf_counter() - t0:.1f} s to make")

    class IdsTokenizer:
        def decode(self, ids, skip_special_tokens=True):
            return " ".join(str(int(i)) for i in ids)

    codes0 = {k: (v.data_ptr(), v.stride()) for k, v in params["encoder"]["layers"].items() if k.endswith("_q")}
    engine = DecodeEngine(params, cfg, st, language_token_ids=lang_ids, quantize_cross_kv=True)
    codes1 = {k: (v.data_ptr(), v.stride()) for k, v in params["encoder"]["layers"].items() if k.endswith("_q")}
    if codes1 != codes0:
        raise AssertionError("the engine changed the caller's encoder codes")
    model = WhisperModel(engine, IdsTokenizer(), LanguageState(const=lang_ids[0]), language_tokens=lang_ids)
    n_streams = 8
    rep = serve_streams(model, n_streams, seconds)
    check_served(rep, n_streams)
    if rep["captures"]:  # warmup() captures every graph a served round replays
        raise AssertionError(f"{rep['captures']} CUDA graphs captured during the served rounds, after warmup")
    rec["serving"] = {k: v for k, v in rep.items() if k not in ("texts",)}
    for r in rep["rounds"]:
        log(f"  served round: B={r['B']} n_active={r['n_active']} wall_ms={r['ms']:.1f} "
            f"decode_steps={r['steps']} host_syncs={r['syncs']}")
    lat = rep["metrics"]["latency"]
    log(f"  metrics: audio_drops={rep['metrics']['audio_drops']} transcript_drops="
        f"{rep['metrics']['transcript_drops']} ready_to_applied={lat['ready_to_applied']} "
        f"admit_to_first_partial={lat['admit_to_first_partial']} round_cost_ema_ms="
        f"{rep['metrics']['round_cost_ema_ms']}")
    log(f"  drop accounting per stream (produced, fed, dropped samples, dropped chunks): {rep['accounting']}")

    # One B=1 window with int4 cross-K/V through the same kernel.  A second
    # engine on the same params with the w8a16 encoder: the first engine's
    # K-major prep left the caller's codes as they were.
    e16 = DecodeEngine(params, cfg.with_(encoder_q8_mode="w8a16"), st, language_token_ids=lang_ids)
    if e16.params is not params:
        raise AssertionError("a w8a16 engine copied the params")
    e4 = DecodeEngine(params, cfg, st, language_token_ids=lang_ids, quantize_cross_kv="int4")
    if e4.quantize_cross_kv != "int4":
        raise AssertionError("the int4 tier fell back")
    m4 = WhisperModel(e4, IdsTokenizer(), LanguageState(const=lang_ids[0]))
    sr = 16000
    n_win = m4.longform.window_samples
    tt = np.arange(n_win) / sr
    audio = (0.15 * np.sin(2 * np.pi * 440 * tt) + 0.05 * np.random.default_rng(4).standard_normal(n_win)).astype(np.float32)
    c0 = paged_cross.cross_attention_q8_kernel_stacked.launches
    sync()
    w0, s0 = time.perf_counter(), e4.decode_steps
    text4 = m4.transcribe(audio, final_chunk=True)
    sync()
    int4_ms, int4_steps = (time.perf_counter() - w0) * 1e3, e4.decode_steps - s0
    int4_launches = paged_cross.cross_attention_q8_kernel_stacked.launches - c0
    if m4.longform.buf.size != 0 or (cuda and int4_launches <= 0):
        raise AssertionError(f"int4 window: buffer {m4.longform.buf.size} left, {int4_launches} cross launches")

    # One full-width decoder_step, kernel routes vs plain routes, on the
    # prefill of the padded window the scheduler builds (rows >= n_active
    # copy row 0) through the engine's own front, prefill and int8 kernel
    # layout: at B=1 and at B=8 with 5 distinct windows.
    def step_routes(windows, n_active):
        B = len(windows)
        rows = np.stack([prepare_audio(w, 2 * cfg.max_source_positions) for w in windows])
        rows[n_active:] = rows[0]
        langs = torch.full((B,), lang_ids[0], dtype=torch.int64, device=dev)
        with torch.no_grad():
            _, xk, xv, prefix, _, _ = engine._window_front(torch.from_numpy(rows).to(dev), langs, detect=False)
            ck, cv, _, _ = engine._prefill_kv(prefix, xk, xv)
            kp, vp = engine._quantize_xkv(xk, xv)
            kq, vq = quantize_cross_kv(xk, xv)
            tok = torch.full((B,), st.zero_sec, dtype=torch.int64, device=dev)
            c0 = paged_cross.cross_attention_q8_kernel_stacked.launches
            lk, _, _ = decoder_step(params, cfg, tok, 3, ck.clone(), cv.clone(), kp, vp)
            launched = paged_cross.cross_attention_q8_kernel_stacked.launches - c0
            lp, _, _ = decoder_step(params, cfg.with_(self_kv_impl="xla", cross_kv_impl="einsum"), tok, 3,
                                    ck.clone(), cv.clone(), kq, vq)
        if cuda and launched != cfg.decoder_layers:
            raise AssertionError(f"B={B} kernel-route step launched {launched} cross kernels")
        # bf16 tolerance: both routes round q', p and the attention outputs
        # to bf16 at the same points but sum in other orders, so a hidden
        # value on a bf16 rounding boundary may flip by one ulp and carry to
        # the logits: 2% of the logits' range.
        err, scale = float((lk - lp).abs().max()), float(lp.abs().max())
        if not (torch.isfinite(lk).all() and lk.shape == (B, cfg.vocab_size) and err <= 0.02 * scale):
            raise AssertionError(f"full-width bf16 step B={B} kernel vs plain: max abs logit diff {err} "
                                 f"(|z| <= {scale})")
        return err, scale

    step_b1 = step_routes([audio], 1)
    step_b8 = step_routes([np.roll(audio, sr * i) for i in range(8)], 5)
    # The served round's encoder at B=8 (flash + int8 GEMM), CUDA events.
    mel = log_mel_spectrogram(
        torch.from_numpy(prepare_audio(audio, 2 * cfg.max_source_positions))[None].to(dev),
        n_mels=cfg.num_mel_bins, n_frames=2 * cfg.max_source_positions,
    )
    enc_ms = cuda_ms(lambda: engine.encode(mel.expand(8, -1, -1)), n=3) if cuda else float("nan")
    # The caller's params, which no engine prepped: a bare encode (w8a8, the
    # int8 GEMM over K-major copies made per call) equals the engine's, and
    # the w8a16 engine's encoder runs the w8 kernel over the same codes.
    with torch.no_grad():
        bare = encode(params, cfg, mel)
        prepped = engine.encode(mel)
        w8a16 = e16.encode(mel)
    if not torch.equal(bare, prepped) or not torch.isfinite(w8a16).all() or w8a16.shape != prepped.shape:
        raise AssertionError("a bare encode or the w8a16 engine's encode on the caller's params failed")
    # The same engine's B=8 window (8 active) called directly, twice, with
    # no audio being fed: the served rounds' wall against it.
    rows = np.stack([prepare_audio(np.roll(audio, sr * i), 2 * cfg.max_source_positions) for i in range(8)])
    direct_ms = []
    for _ in range(2):
        sync()
        w0 = time.perf_counter()
        engine.transcribe_window(torch.from_numpy(rows).to(dev), [lang_ids[0]] * 8, seed=1)
        sync()
        direct_ms.append((time.perf_counter() - w0) * 1e3)
    # The graph loop against the per-step eager loop on this B=8 window
    # (bf16: tokens equal), the device's idle share under torch.profiler,
    # and one B=8 window of the eager loop profiled: device-only ms per
    # launch of each kernel on this path (the same kernels the graphs
    # replay, each launched from the host).
    prof, modes, idle, one_read, gated, a8 = {}, {}, {}, {}, {}, {}
    if cuda:
        rows_t = torch.from_numpy(rows).to(dev)
        modes = window_modes(engine, rows_t, [lang_ids[0]] * 8, 1)
        modes_b1 = window_modes(engine, rows_t[:1], [lang_ids[0]], 1)
        if modes["graph"]["syncs"] != 1 or modes_b1["graph"]["syncs"] != 1:
            raise AssertionError(f"graph windows made {modes['graph']['syncs']} / {modes_b1['graph']['syncs']} host "
                                 "reads at B=8 / B=1, want 1")
        one_read = {8: one_read_window(engine, rows, [lang_ids[0]] * 8, 3, n_active=5)[1],
                    1: one_read_window(engine, rows[:1], [lang_ids[0]], 3)[1]}
        idle["graph"] = idle_share(lambda: engine.transcribe_window(rows_t, [lang_ids[0]] * 8, seed=1),
                                   "serving_graph")
        idle["eager"] = idle_share(lambda: engine.transcribe_window_eager(rows_t, [lang_ids[0]] * 8, seed=1),
                                   "serving_eager")
        prof = device_profile(
            lambda: engine.transcribe_window_eager(rows_t, [lang_ids[0]] * 8, seed=1),
            ["sample_step", "self_decode", "cross_decode", "flash_encoder", "q8a8", "w8_matmul"], "serving_profile",
        )
        rec.setdefault("profile", {}).update(prof)
        rec["serving_window"] = (engine, rows_t, [lang_ids[0]] * 8)  # phase 18's window
        gated = gated_warmup_check(params, cfg, st, lang_ids, rows, IdsTokenizer())
        a8 = a8_window_check(engine, params, cfg, st, lang_ids, rows, dev)
    b8 = [r["ms"] for r in rep["rounds"] if r["B"] == 8]
    b8_ms = dict(n=len(b8), median=float(np.median(b8)), min=min(b8), max=max(b8)) if b8 else None
    graphs = window_graph_stats(engine) if cuda else []
    rec["serving"].update(int4_ms=int4_ms, int4_steps=int4_steps, int4_launches=int4_launches,
                          step_b1=step_b1, step_b8=step_b8, encode_b8_ms=enc_ms, round_b8_ms=b8_ms,
                          direct_b8_ms=direct_ms, modes_b8=modes, idle_b8=idle, one_read=one_read, gated=gated,
                          graphs=graphs, a8=a8)
    chars = [len("".join(rep["texts"][i])) for i in range(n_streams)]
    b8_txt = (f"B=8 rounds n={b8_ms['n']} median {b8_ms['median']:.1f} ms (min {b8_ms['min']:.1f}, "
              f"max {b8_ms['max']:.1f}); direct B=8 windows {[round(x, 1) for x in direct_ms]} ms"
              if b8_ms else "no B=8 round")
    log(f"phase 9 serving: ok d_model={cfg.d_model} enc={cfg.encoder_layers} dec={cfg.decoder_layers} bf16 "
        f"w8a8/int8 + int8 cross-K/V kernel layout, BatchedTranscriber(max_streams=8) warmup "
        f"{rep['warm_s']:.1f} s; {n_streams} streams {seconds[0]:g}-{seconds[1]:g} s fed at {FEED_SPEED:g}x real time "
        f"served in {rep['wall_s']:.1f} s over {len(rep['rounds'])} rounds ({b8_txt}); CUDA graphs captured "
        f"during the served rounds (after warmup): {rep['captures']}; rounds per stream "
        f"{rep['stream_rounds']}; no audio or transcript drops; every receiver closed; "
        f"peak_mem={rep['peak'] / 2**30:.2f} GiB; launches={rep['launches']}; text chars={chars}; "
        f"int4 B=1 window(s) {int4_ms:.1f} ms, {int4_steps} steps, {int4_launches} cross launches, "
        f"{len(text4)} chars; B=8 encode {enc_ms:.1f} ms; profiled B=8 window: {profile_text(prof)}; "
        f"bf16 step kernel-vs-plain logit err "
        f"B=1 {step_b1[0]:.3g} (|z| <= {step_b1[1]:.3g}), B=8 n_active=5 {step_b8[0]:.3g} "
        f"(|z| <= {step_b8[1]:.3g})")
    if cuda:
        log(f"  serving B=8 window, graph vs per-step eager loop (tokens equal): {modes_text(modes)}")
        log(f"  serving B=1 window, graph vs per-step eager loop (tokens equal): {modes_text(modes_b1)}")
        log(f"  serving B=8 idle share under torch.profiler: " + "; ".join(
            f"{m}: wall {v[0]:.1f} ms, device busy {v[1]:.1f} ms, idle {v[2]:.1%} ({v[3]} device events)"
            for m, v in idle.items()))
        for B, r in one_read.items():
            log(f"  serving warm B={B} window: {one_read_text(r)}")
        log(f"  serving window graphs: {graph_stats_text(graphs)}; {smi_line()}")
        log(f"  serving warm-up, its silence finished by the gate (rows born finished; a fresh engine): "
            f"{gated['warm_s']:.1f} s, "
            f"{gated['warm_steps']} decode steps, {gated['warm_captures']} graphs captured; then live B=1 and B=8 "
            f"(5 active) windows: {gated['captures']} captured, {gated['steps']} steps, tokens per row "
            f"{gated['lens']}; graphs: {graph_stats_text(gated['graphs'])}")
        log(f"  serving a8 cross-attention (cross_kv_impl='a8': int8 q and softmax weights, exact int8 products "
            f"through f32): {a8_text(a8)}; {smi_line()}")


# "a8" on two devices (two implementations of its softmax): every element
# within A8_REL of the output's max, or within one code step
# (model/whisper.py::a8_code_step) where a weight code flipped at a
# rounding tie, in at most A8_FLIP_ROWS head rows; a bf16 output may also
# differ by one bf16 step where the f32 values straddle a rounding boundary.
A8_REL = 1e-5
A8_FLIP_ROWS = 2


def a8_gap(got, want, step, dh):
    """(max |got - want| / max |want|, head rows past A8_REL of the max);
    raises past the tolerance above."""
    import torch

    bf16 = got.dtype == torch.bfloat16
    got, want = got.detach().float().cpu(), want.detach().float().cpu()
    scale = float(want.abs().max())
    tol = A8_REL * scale + (2.0 ** -8 * want.abs() if bf16 else 0.0)
    gap = (got - want).abs()
    rows = int((gap > tol).reshape(*gap.shape[:-1], -1, dh).any(-1).sum())
    if bool((gap > tol + 1.01 * step.float()).any()) or rows > A8_FLIP_ROWS:
        raise AssertionError(f"a8 gap {float(gap.max())} (max |out| {scale}), {rows} head rows past {A8_REL} of "
                             f"the max")
    return float(gap.max()) / scale, rows


def a8_window_check(engine, params, cfg, st, lang_ids, rows, dev):
    """Phase 9's "a8" part: an engine with ``cross_kv_impl="a8"`` (int8 q and
    softmax weights, exact int8 products) and one with "einsum" on the same
    params beside ``engine`` (the cross kernel): each new engine's first B=8
    window captures its graph, then a warm B=8 window (5 active) dispatched
    under set_sync_debug_mode("error") must be one host read and capture
    nothing, though the cyclic collector frees a dropped engine's graphs
    inside that first capture; the three engines' warm B=8 walls in turns
    kernel, a8, einsum, einsum, a8, kernel; and one layer's "a8" output on the device against
    the same function on the CPU, on that window's int8 cross-K/V, f32 and
    bf16 q."""
    import gc

    import numpy as np
    import torch

    import norma_tpu_torch.decode.engine as engine_mod
    from norma_tpu_torch.decode import DecodeEngine
    from norma_tpu_torch.model.whisper import a8_code_step, attention_cross_q8_a8, int8_products, quantize_cross_kv

    cuda = torch.device(dev).type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    langs = [lang_ids[0]] * len(rows)
    rows_t = torch.from_numpy(rows).to(dev)
    engines = {"kernel": engine}
    warm = {}
    # A dropped engine's graphs freed by the cyclic collector while another
    # engine captures must not invalidate that capture (the engine collects
    # before it captures): drop one in a cycle, then collect inside the a8
    # engine's first capture.
    junk = DecodeEngine(params, cfg, st, language_token_ids=lang_ids, quantize_cross_kv=True)
    junk.transcribe_window(rows_t[:1], langs[:1], seed=1)
    junk.cycle = junk
    del junk
    inner = engine_mod.capture_nodes

    def collecting(stream):
        gc.collect()
        return inner(stream)

    for impl in ("a8", "einsum"):
        e = engines[impl] = DecodeEngine(params, cfg.with_(cross_kv_impl=impl), st, language_token_ids=lang_ids,
                                         quantize_cross_kv=True)
        sync()
        t0, c0 = time.perf_counter(), e.graph_captures
        engine_mod.capture_nodes = collecting if impl == "a8" else inner
        try:
            e.transcribe_window(rows_t, langs, seed=1)
        finally:
            engine_mod.capture_nodes = inner
        sync()
        warm[impl] = dict(first_ms=(time.perf_counter() - t0) * 1e3, captures=e.graph_captures - c0)
    read = one_read_window(engines["a8"], rows, langs, 3, n_active=5)[1] if cuda else None
    c0 = engines["a8"].graph_captures
    walls = {k: [] for k in engines}
    for impl in ("kernel", "a8", "einsum", "einsum", "a8", "kernel"):
        sync()
        t0 = time.perf_counter()
        engines[impl].transcribe_window(rows_t, langs, seed=1)
        sync()
        walls[impl].append((time.perf_counter() - t0) * 1e3)
    if engines["a8"].graph_captures != c0 or (cuda and warm["a8"]["captures"] != 1):
        raise AssertionError(f"a8 engine: {warm['a8']['captures']} captures in its first B=8 window, "
                             f"{engines['a8'].graph_captures - c0} in warm ones")
    # One layer, device against host, on the window's own cross-K/V.
    e = engines["a8"]
    with torch.no_grad():
        _, xk, xv, _, _, _ = e._window_front(rows_t, torch.full((len(rows),), lang_ids[0], device=dev), detect=False)
        kq, vq = quantize_cross_kv(xk, xv)
    kq0, vq0 = {k: v[0] for k, v in kq.items()}, {k: v[0] for k, v in vq.items()}
    H, D = cfg.decoder_attention_heads, cfg.d_model
    gen = torch.Generator().manual_seed(9)
    gaps = {}
    for dtype in (torch.float32, torch.bfloat16):
        q = torch.randn(len(rows), 1, D, generator=gen).to(dtype)
        got = attention_cross_q8_a8(q.to(dev), kq0, vq0, H)
        want = attention_cross_q8_a8(q, {k: v.cpu() for k, v in kq0.items()}, {k: v.cpu() for k, v in vq0.items()}, H)
        if got.dtype != dtype or not bool(torch.isfinite(got).all()):
            raise AssertionError(f"a8 layer on the device: {got.dtype}, finite {bool(torch.isfinite(got).all())}")
        gaps[str(dtype).split(".")[-1]] = a8_gap(got, want, a8_code_step(q, kq0, vq0, H), D // H)
    # The PV product exact on the device at the path's shape, TF32 on and
    # off: codes at 127 in a row make its sums over Ta keys reach Ta * 127**2
    # (24.2M at Ta 1500, past 2**24).
    Ta, dh = kq0["q"].shape[1], D // H
    w = torch.randint(0, 128, (len(rows), H, 1, Ta), generator=gen, dtype=torch.int8)
    v = torch.randint(-127, 128, (1, H, Ta, dh), generator=gen, dtype=torch.int8)
    w[0], v[..., 0] = 127, 127
    want = torch.matmul(w.long(), v.long())
    exact = {}
    prev = torch.backends.cuda.matmul.allow_tf32
    try:
        for tf32 in (False, True):
            torch.backends.cuda.matmul.allow_tf32 = tf32
            exact[f"tf32={tf32}"] = torch.equal(int8_products(w.to(dev), v.to(dev)).long().cpu(), want)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    if not all(exact.values()) or int(want.max()) != Ta * 127**2:
        raise AssertionError(f"int8_products on the device: exact {exact}, largest sum {int(want.max())}")
    out = dict(warm=warm, one_read=read, walls_ms=walls, median_ms={k: float(np.median(v)) for k, v in walls.items()},
               layer_gap=gaps, Ta=Ta, exact=exact, max_sum=int(want.max()),
               graphs=window_graph_stats(engines["a8"]) if cuda else None)
    del engines, e
    if cuda:
        torch.cuda.empty_cache()
    return out


def a8_text(a8) -> str:
    walls = "; ".join(f"{k} {[round(x, 1) for x in v]} ms (median {a8['median_ms'][k]:.1f})"
                      for k, v in a8["walls_ms"].items())
    gaps = ", ".join(f"{k} {g[0]:.3g} of the max ({g[1]} head rows past {A8_REL})" for k, g in a8["layer_gap"].items())
    read = one_read_text(a8["one_read"]) if a8["one_read"] else "not run"
    first = ", ".join(f"{k} {v['first_ms']:.1f} ms" for k, v in a8["warm"].items())
    return (f"first B=8 windows (capture) {first}; warm a8 B=8 window (5 active): {read}; warm B=8 walls in turns "
            f"kernel, a8, einsum, einsum, a8, kernel: {walls}; one layer device vs CPU (B=8, Ta {a8['Ta']}): "
            f"{gaps}; PV products exact {a8['exact']} (largest sum {a8['max_sum']}, 2**24 = {2**24}); a8 graphs: "
            f"{graph_stats_text(a8['graphs']) if a8['graphs'] else 'not run'}")


def gated_warmup_check(params, cfg, st, lang_ids, rows, tokenizer):
    """A fresh engine on ``params``: WhisperModel.warmup at B=1 and B=8 with
    the no-speech gate's outcome forced on its silence -- every row
    finished before its first step, as real weights leave silence -- then
    live B=1 and B=8 (5 active) windows on ``rows``, which must capture no
    CUDA graph and decode.  The gate is forced through its data path: the
    warm-up's rows go in as padding (``n_active=0``), which the ladder
    finishes at birth exactly as it does rows whose no-speech probability
    passes the threshold (``gated0``); patching the threshold instead would
    change the captured program, which holds it as a constant, as JAX's
    jitted ladder does.  Returns the warm-up's seconds, steps and captures,
    and the live windows'."""
    import torch

    from norma_tpu_torch.decode import DecodeEngine, LanguageState
    from norma_tpu_torch.models.whisper import WhisperModel

    eng = DecodeEngine(params, cfg, st, language_token_ids=lang_ids, quantize_cross_kv=True)
    model = WhisperModel(eng, tokenizer, LanguageState(const=lang_ids[0]))
    window = eng.transcribe_window
    eng.transcribe_window = lambda audio, langs, seed, n_active=None: window(audio, langs, seed, n_active=0)
    try:
        t0 = time.perf_counter()
        for B in (1, 8):
            model.warmup(batch=B)
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
    finally:
        del eng.transcribe_window
    warm = dict(warm_s=warm_s, warm_steps=eng.decode_steps, warm_captures=eng.graph_captures)
    c0, s0 = eng.graph_captures, eng.decode_steps
    r1, _ = eng.transcribe_window(rows[:1], [lang_ids[0]], 7)
    r8, _ = eng.transcribe_window(rows, [lang_ids[0]] * 8, 8, n_active=5)
    torch.cuda.synchronize()
    out = dict(warm, captures=eng.graph_captures - c0, steps=eng.decode_steps - s0,
               lens=[d and len(d.tokens) for d in r1 + r8], graphs=window_graph_stats(eng))
    if out["warm_steps"] or out["captures"] or not out["steps"] or r8[5:] != [None] * 3:
        raise AssertionError(f"a warm-up whose rows the gate finished ran {out['warm_steps']} steps; then live "
                             f"windows captured {out['captures']} graphs in {out['steps']} steps (rows {out['lens']})")
    del eng, model
    torch.cuda.empty_cache()
    return out


# --------------------------------------------------------------------------
# Phases 10-13: the int4 / int8 weight-streaming kernels, the fused log-mel
# kernel, and the public entry point at full width.
# --------------------------------------------------------------------------

HEAD_K, HEAD_N = 1280, V3


def _rel_err(k, p):
    """max |kernel - plain| and that over max |plain|."""
    err = float((k - p).abs().max())
    return err, err / max(float(p.abs().max()), 1e-30)


W4_ROWS = (1, 6, 8, 16, 48, 200)
W4_TIMED_ROWS = (1, 6, 8, 16)
W4_TILES = (66, 132, 264, 396, 528, 792)  # 128-column tiles: 0.5-6 per SM


def phase_w4(rec, dev):
    import math

    import torch

    from norma_tpu_torch.model.load import params_from_numpy
    from norma_tpu_torch.model.whisper import logits_head
    from norma_tpu_torch.ops import quant_matmul as qm

    g = torch.Generator(device=dev).manual_seed(10)
    w = torch.randn((HEAD_K, HEAD_N), generator=g, device=dev) * 0.02  # the tied embedding, transposed
    q4, s4 = qm.quantize_blockwise_int4(w)
    q4 = qm.pitched_codes(q4)  # the int4 head's layout (model/quant.py, DecodeEngine)
    q8, s8 = qm.quantize_per_channel(w)
    q8 = qm.pitched_codes(q8)
    wb = w.to(torch.bfloat16)
    wsq = torch.randn((1280, 1280), generator=g, device=dev) * 0.03
    shapes = {"head": (q4, s4), "1280x1280": qm.quantize_blockwise_int4(wsq)}
    # Tolerance: both sum f32 products of the same exact operands (bf16 or
    # f32 x, integer codes, bf16 scales widened) in other orders: 1e-5 of
    # the output's range.  One launch per product.
    worst, worst_abs, n_cases = 0.0, 0.0, 0
    for name, (q, sc) in shapes.items():
        K, N = 2 * q.shape[0], q.shape[1]
        for rows in W4_ROWS:
            for dtype in (torch.bfloat16, torch.float32):
                x = torch.randn((rows, K), generator=g, device=dev).to(dtype)
                before = qm.w4_matmul.launches
                ko = qm.w4_matmul(x, q, sc)
                launched = qm.w4_matmul.launches - before
                po = qm.w4_matmul_torch(x, q, sc)
                torch.cuda.synchronize()
                if launched != 1:
                    raise AssertionError(f"w4 {name} rows={rows}: {launched} launches for one product")
                if ko.shape != (rows, N) or ko.dtype != torch.float32 or not torch.isfinite(ko).all():
                    raise AssertionError(f"w4 {name} rows={rows} {dtype}: bad output")
                err, rel = _rel_err(ko, po)
                if not rel <= 1e-5:
                    raise AssertionError(f"w4 {name} rows={rows} {dtype}: err {err} ({rel:.3g} of max|y|)")
                worst, worst_abs, n_cases = max(worst, rel), max(worst_abs, err), n_cases + 1
    # Codes in another layout (contiguous rows of 51866 bytes) are copied
    # pitched for the call: the same product, bit for bit.
    x6 = torch.randn((6, HEAD_K), generator=g, device=dev).to(torch.bfloat16)
    if not torch.equal(qm.w4_matmul(x6, q4.contiguous(), s4), qm.w4_matmul(x6, q4, s4)):
        raise AssertionError("w4 on contiguous head codes differs from the pitched codes' product")
    # A tree as the JAX package's quantizer writes it (logical [K/2, N] and
    # [K, N] codes, contiguous), carried by params_from_numpy: the engine's
    # head layout pitches it, and logits_head runs each head's kernel.
    carried_txt = []
    for head, (q, sc, kern) in {"tok_emb_q4": (q4, s4, qm.w4_matmul), "tok_emb_q8": (q8, s8, qm.w8_matmul)}.items():
        tree = {"decoder": {head: {"q": q.contiguous().cpu().numpy(), "s": sc.float().cpu().numpy()}}}
        carried = params_from_numpy(tree, dev, dtype=None)["decoder"]
        dec = qm.head_kernel_layout(carried)
        cq, dq = carried[head]["q"], dec[head]["q"]
        if cq.stride(0) % 16 == 0 or dq.stride(0) % 16 or not torch.equal(dq, q):
            raise AssertionError(f"{head}: carried stride {cq.stride()}, engine layout stride {dq.stride()}")
        before = kern.launches
        y = logits_head(dec, x6)
        if kern.launches - before != 1:
            raise AssertionError(f"{head}: logits_head launched its kernel {kern.launches - before} times")
        plain = (qm.w4_matmul_torch if head == "tok_emb_q4" else qm.w8_matmul_torch)(x6, q, sc)
        err, rel = _rel_err(y, plain)
        if not rel <= 1e-5 or not torch.equal(logits_head(carried, x6), y):
            raise AssertionError(f"{head}: carried tree's logits err {err} ({rel:.3g}) or layouts disagree")
        carried_txt.append(f"{head} stride {cq.stride(0)} -> {dq.stride(0)}, err {rel:.3g} of max|y|")

    # Device times from CUDA graphs over enough weight copies to exceed the
    # 50 MB L2 (each call reads its head cold, as a decode step does): the
    # kernel against the bf16 cuBLAS head and the int8 head (w8 kernel), in
    # turns cuBLAS, w8, w4, w4, w8, cuBLAS.
    copies = lambda t: max(2, math.ceil(120e6 / (t.shape[0] * t.stride(0) * t.element_size())))
    q4s = [q4] + [qm.pitched_codes(q4.clone()) for _ in range(copies(q4) - 1)]
    q8s = [q8] + [qm.pitched_codes(q8.clone()) for _ in range(copies(q8) - 1)]
    wbs = [wb] + [wb.clone() for _ in range(copies(wb) - 1)]
    times = {}
    for rows in W4_TIMED_ROWS:
        x = torch.randn((rows, HEAD_K), generator=g, device=dev).to(torch.bfloat16)
        k4 = [lambda qq=qq: qm.w4_matmul(x, qq, s4) for qq in q4s]
        k8 = [lambda qq=qq: qm.w8_matmul(x, qq, s8) for qq in q8s]
        lib = [lambda ww=ww: qm.mm_f32(x, ww) for ww in wbs]
        l1, e1, a1, a2, e2, l2 = graph_ms(lib), graph_ms(k8), graph_ms(k4), graph_ms(k4), graph_ms(k8), graph_ms(lib)
        b_ms, b_by = bound(q4.shape[0] * HEAD_N + nbytes(s4, x) + 4 * rows * HEAD_N)
        times[rows] = dict(ms=(a1 + a2) / 2, int8_ms=(e1 + e2) / 2, cublas_ms=(l1 + l2) / 2, bound_ms=b_ms,
                           bound_by=b_by)
    times[6]["plain_ms"] = graph_ms([lambda qq=qq: qm.w4_matmul_torch(x6, qq, s4) for qq in q4s[:2]])
    # The plan's (cluster, warps) against other shapes at 6 rows, the same way.
    plan_w4, sweep = qm.w4_plan, {}
    try:
        for c, wp in ((1, 4), (1, 5), (1, 6), (2, 4), (2, 5)):
            qm.w4_plan = lambda M_, N_, K_, b_, c=c, wp=wp: dict(plan_w4(M_, N_, K_, b_), cluster=c, warps=wp)
            sweep[(c, wp)] = graph_ms([lambda qq=qq: qm.w4_matmul(x6, qq, s4) for qq in q4s])
    finally:
        qm.w4_plan = plan_w4
    p6 = plan_w4(6, HEAD_N, HEAD_K, 64)
    del q4s, q8s, wbs
    # Time against the number of 128-column tiles, w4 beside w8 (twice the
    # code bytes, the same tensor-core products per tile), at 6 rows over
    # cold weights: whether the time follows bytes or blocks.
    tiles = {}
    for nt in W4_TILES:
        wt = torch.randn((HEAD_K, 128 * nt), generator=g, device=dev) * 0.02
        t4, t4s = qm.quantize_blockwise_int4(wt)
        t8, t8s = qm.quantize_per_channel(wt)
        t4l = [t4] + [t4.clone() for _ in range(copies(t4) - 1)]
        t8l = [t8] + [t8.clone() for _ in range(copies(t8) - 1)]
        tiles[nt] = (graph_ms([lambda qq=qq: qm.w4_matmul(x6, qq, t4s) for qq in t4l]),
                     graph_ms([lambda qq=qq: qm.w8_matmul(x6, qq, t8s) for qq in t8l]))
        del wt, t4l, t8l
    # Host-launched back-to-back calls (the wrapper's Python included).
    host_k, host_p = turns(lambda: qm.w4_matmul_torch(x6, q4, s4), lambda: qm.w4_matmul(x6, q4, s4))
    prof = device_profile(lambda: [qm.w4_matmul(x6, q4, s4) for _ in range(20)], ["w4_matmul"], "w4")
    rec.setdefault("profile", {}).update(prof)
    t6 = times[6]
    head_bytes = dict(int4=q4.shape[0] * HEAD_N + 2 * s4.numel(), int8=q8.shape[0] * HEAD_N + 4 * s8.numel(),
                      bf16=2 * wb.numel())
    rec["w4_matmul"] = dict(max_abs_err=worst_abs, ms=t6["ms"], plain_ms=t6["plain_ms"], bound_ms=t6["bound_ms"],
                            bound_by=t6["bound_by"], library_ms=t6["cublas_ms"])
    rec["w4_detail"] = dict(rel_err=worst, times=times, sweep={f"C={c} W={wp}": v for (c, wp), v in sweep.items()},
                            plan6=p6, host_ms=host_k, host_plain_ms=host_p, bytes=head_bytes, tiles=tiles)
    txt = "; ".join(f"{r} rows {v['ms']:.4f} (int8 head {v['int8_ms']:.4f}, bf16 cuBLAS {v['cublas_ms']:.4f}, bound "
                    f"{v['bound_ms']:.4f}, {v['bound_ms'] / v['ms']:.0%})" for r, v in times.items())
    log(f"phase 10 w4_matmul: ok {n_cases} cases ([1280 -> 51866] pitched and 1280x1280, rows "
        f"{'/'.join(map(str, W4_ROWS))}, bf16/f32 x), one launch each; max err {worst_abs:.3g} ({worst:.3g} of "
        f"max|y|); contiguous codes copied pitched: equal; carried JAX-layout trees: {'; '.join(carried_txt)}; "
        f"device ms from CUDA graphs, cold weights, bf16 x: {txt}; plain at 6 rows {t6['plain_ms']:.4f} ms; by "
        f"(cluster, warps) at 6 rows (plan {p6['cluster']}, {p6['warps']}): "
        + ", ".join(f"{k}: {v:.4f}" for k, v in sweep.items())
        + "; by 128-column tiles at 6 rows (w4, w8 ms): " + ", ".join(
            f"{nt}: {a:.4f}, {b:.4f}" for nt, (a, b) in tiles.items())
        + f"; host-launched at 6 rows {host_k:.4f} ms vs plain {host_p:.4f} ms; head bytes int4 "
        f"{head_bytes['int4']} int8 {head_bytes['int8']} bf16 {head_bytes['bf16']}; profiler {profile_text(prof)}")


def graph_ms(calls, reps: int = 10) -> float:
    """Device ms per call of ``calls`` (a list of thunks), all captured in
    one CUDA graph and replayed ``reps`` times: the device's time without
    the host's launch cost."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for fn in calls[:3]:
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for fn in calls:
            fn()
    graph.replay()
    torch.cuda.synchronize()
    s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    s.record()
    for _ in range(reps):
        graph.replay()
    e.record()
    torch.cuda.synchronize()
    return s.elapsed_time(e) / (reps * len(calls))


W8_SHAPES = ((1280, 3840), (1280, 1280), (1280, 5120), (5120, 1280), (HEAD_K, HEAD_N))
W8_ROWS = (6, 8, 16)


def phase_w8(rec, dev):
    import math

    import torch

    from norma_tpu_torch.ops import quant_matmul as qm

    g = torch.Generator(device=dev).manual_seed(11)
    worst, worst_abs, n_cases, times = 0.0, 0.0, 0, {}
    for K, N in W8_SHAPES:
        q, s = qm.quantize_per_channel(torch.randn((K, N), generator=g, device=dev) * K**-0.5)
        q = qm.pitched_codes(q)
        for rows in (1,) + W8_ROWS + (24, 48, 200):
            for dtype in (torch.bfloat16, torch.float32):
                x = torch.randn((rows, K), generator=g, device=dev).to(dtype)
                before = qm.w8_matmul.launches
                ko = qm.w8_dense(x, q, s)
                launched = qm.w8_matmul.launches - before
                po = qm.w8_dense_torch(x, q, s)
                torch.cuda.synchronize()
                if launched != 1:
                    raise AssertionError(f"w8 K={K} N={N} rows={rows}: {launched} launches for one product")
                if ko.shape != (rows, N) or not torch.isfinite(ko).all():
                    raise AssertionError(f"w8 K={K} N={N} rows={rows} {dtype}: bad output")
                err, rel = _rel_err(ko, po)
                if not rel <= 1e-5:  # f32 summation order of exact products, as phase 10
                    raise AssertionError(f"w8 K={K} N={N} rows={rows} {dtype}: err {err} ({rel:.3g} of max|y|)")
                worst, worst_abs, n_cases = max(worst, rel), max(worst_abs, err), n_cases + 1
        # Device times from CUDA graphs over enough weight copies to exceed
        # the 50 MB L2 (each call reads its weight cold, as a decode step
        # does): the kernel against one bf16 cuBLAS product over a bf16
        # copy of the weight, in turns cuBLAS, kernel, kernel, cuBLAS.
        copies = min(64, max(2, math.ceil(120e6 / (K * N))))
        qs = [q] + [qm.pitched_codes(q.clone()) for _ in range(copies - 1)]
        wbs = [qq.to(torch.bfloat16) for qq in qs]
        for rows in W8_ROWS:
            x = torch.randn((rows, K), generator=g, device=dev).to(torch.bfloat16)
            kern = [lambda qq=qq: qm.w8_dense(x, qq, s) for qq in qs]
            lib = [lambda wb=wb: qm.mm_f32(x, wb) for wb in wbs]
            l1, k1, k2, l2 = graph_ms(lib), graph_ms(kern), graph_ms(kern), graph_ms(lib)
            plain_ms = graph_ms([lambda qq=qq: qm.w8_dense_torch(x, qq, s) for qq in qs[:4]])
            b_ms, b_by = bound(K * N + nbytes(s, x) + 4 * rows * N)
            times[(K, N, rows)] = dict(ms=(k1 + k2) / 2, cublas_ms=(l1 + l2) / 2, plain_ms=plain_ms,
                                       bound_ms=b_ms, bound_by=b_by)
        # The cluster size (the K split across blocks) against the plan's
        # choice, at 6 rows, the same way.
        x6, plan_w8, sweep = torch.randn((6, K), generator=g, device=dev).to(torch.bfloat16), qm.w8_plan, {}
        try:
            for c in (1, 2, 4, 8):
                if c == 1 or 4 * c <= math.ceil(K / 32):
                    qm.w8_plan = lambda M_, N_, K_, c=c: dict(plan_w8(M_, N_, K_), cluster=c)
                    sweep[c] = graph_ms([lambda qq=qq: qm.w8_dense(x6, qq, s) for qq in qs])
        finally:
            qm.w8_plan = plan_w8
        times[(K, N, 6)].update(cluster_ms=sweep, plan_cluster=plan_w8(6, N, K)["cluster"])
        del qs, wbs
        # Host-launched back-to-back calls (the wrapper's Python included).
        x = torch.randn((6, K), generator=g, device=dev).to(torch.bfloat16)
        kt = turns(lambda: qm.w8_dense_torch(x, q, s), lambda: qm.w8_dense(x, q, s))
        times[(K, N, 6)].update(host_ms=kt[0], host_plain_ms=kt[1])
    t = times[(1280, 3840, 6)]
    rec["w8_matmul"] = dict(max_abs_err=worst_abs, ms=t["ms"], plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
                            bound_by=t["bound_by"], library_ms=t["cublas_ms"])
    rec["w8_times"] = {f"K={k[0]} N={k[1]} M={k[2]}": v for k, v in times.items()}
    slow = [k for k, v in rec["w8_times"].items() if v["ms"] > v["cublas_ms"]]
    sweep_txt = "; ".join(f"K={k[0]} N={k[1]} (plan {v['plan_cluster']}): " + ", ".join(
        f"{c}: {ms:.4f}" for c, ms in v["cluster_ms"].items()) for k, v in times.items() if "cluster_ms" in v)
    txt = "; ".join(f"{k}: {v['ms']:.4f} vs cuBLAS {v['cublas_ms']:.4f}, plain {v['plain_ms']:.4f} ms, bound "
                    f"{v['bound_ms']:.4f} ({v['bound_ms'] / v['ms']:.0%})" for k, v in rec["w8_times"].items())
    log(f"phase 11 w8_matmul: ok {n_cases} cases (4 decoder shapes + head, rows 1/6/8/16/24/48/200, bf16/f32 x), "
        f"one launch each; max err {worst_abs:.3g} ({worst:.3g} of max|y|); device ms from CUDA graphs, cold "
        f"weights, bf16 x: {txt}; slower than cuBLAS at: {slow or 'none'}; host-launched at 6 rows 1280x3840 "
        f"{t['host_ms']:.4f} ms vs plain {t['host_plain_ms']:.4f} ms; device ms by cluster size at 6 rows: {sweep_txt}")


def phase_log_mel(rec, dev):
    import numpy as np
    import torch

    from norma_tpu_torch.frontend.mel import log_mel_spectrogram, prepare_audio
    from norma_tpu_torch.ops import mel_pallas as mp

    sr = 16000
    tt = np.arange(30 * sr) / sr
    rng = np.random.default_rng(12)
    raw = [(0.3 * np.sin(2 * np.pi * (220.0 + 50 * i) * tt) + 0.02 * rng.standard_normal(tt.size)).astype(np.float32)
           for i in range(8)]
    raw[1][: 10 * sr] = 0.0  # near-silent stretch: bins at the clamp floor
    batch = torch.from_numpy(np.stack([mp.pad_for_pallas(a) for a in raw])).to(dev)
    # ---- its own path: a B=8 batch of windows through the frontend kernel ----
    mp.log_mel_pallas.launches = 0
    mels = {n: mp.log_mel_pallas(batch, n_mels=n) for n in (80, 128)}
    torch.cuda.synchronize()
    launches = mp.log_mel_pallas.launches
    # ---- end of its path ----
    # Tolerance 5e-4 in whisper units, the JAX package's bound between two
    # f32 algorithms of this transform (tests/test_mel_pallas.py): the
    # kernel's three TF32 passes and the plain version's exact f32 sum in
    # other orders, magnified by log10 in low-power bins.  Cases: B 1 and 8,
    # and a row silent throughout beside a loud one (each row's clamp is
    # its own).
    silent = np.zeros_like(raw[0])
    cases = [(8, list(range(8)), batch), (1, [0], batch[:1]),
             (2, ["silent", 2], torch.from_numpy(np.stack([mp.pad_for_pallas(silent), mp.pad_for_pallas(raw[2])])).to(dev))]
    worst, n_cases = {"dft": 0.0, "rfft": 0.0}, 0
    for n_mels in (80, 128):
        for B, rows, audio in cases:
            ko = mels[n_mels] if B == 8 else mp.log_mel_pallas(audio, n_mels=n_mels)
            po = mp.log_mel_dft(audio, n_mels=n_mels)
            pcm = [silent if r == "silent" else raw[r] for r in rows]
            ro = log_mel_spectrogram(torch.from_numpy(np.stack([prepare_audio(a) for a in pcm])).to(dev), n_mels=n_mels)
            torch.cuda.synchronize()
            if ko.shape != (B, n_mels, 3000) or not torch.isfinite(ko).all():
                raise AssertionError(f"log_mel B={B} mels={n_mels}: bad output")
            for name, ref in (("dft", po), ("rfft", ro)):
                err = float((ko - ref).abs().max())
                if not err <= 5e-4:
                    raise AssertionError(f"log_mel B={B} rows {rows} mels={n_mels} vs {name}: err {err}")
                worst[name] = max(worst[name], err)
            # The silent row: log10(1e-10) = -10 throughout, its own max, so
            # (-10 + 4) / 4 = -1.5 everywhere (to f32 rounding of the log).
            if "silent" in rows and not (bool((ko[0] == ko[0, 0, 0]).all()) and abs(float(ko[0, 0, 0]) + 1.5) < 1e-6):
                raise AssertionError(f"log_mel: the silent row is not -1.5 throughout: {ko[0].min()} .. {ko[0].max()}")
            n_cases += 1
    k_ms, p_ms = turns(lambda: mp.log_mel_dft(batch, n_mels=128), lambda: mp.log_mel_pallas(batch, n_mels=128))
    b1 = batch[:1].contiguous()
    k1_ms, p1_ms = turns(lambda: mp.log_mel_dft(b1, n_mels=128), lambda: mp.log_mel_pallas(b1, n_mels=128))
    rfft_ms = cuda_ms(lambda: log_mel_spectrogram(batch[:, : (3000 - 1) * 160 + 400], n_mels=128))
    # Bound: the DFT as three TF32 passes (cos and sin, 400 x 201, per
    # frame) on the tensor cores, plus the mel projection's f32 operations
    # over the filters' bin ranges; against the PCM read once and the
    # [B, 128, 3000] log-mel written once.  The first form's bound (all of
    # it as f32 on the CUDA cores, dense mel, the matrices read once) beside
    # it for comparison.
    n_fft, n_freq, frames = 400, 201, 3000
    nnz = int(mp._mel_ranges(128)[1].sum())
    bounds = {}
    for B, audio in ((8, batch), (1, b1)):
        tf32_ops = B * frames * 2 * n_fft * 2 * n_freq * 3
        io = nbytes(audio) + 4 * B * 128 * frames
        bounds[B] = bound(io, {"tf32": tf32_ops, "f32": B * frames * 2 * nnz})
    b_ms, b_by = bounds[8]
    first_ops = 8 * frames * (2 * n_fft * n_freq * 2 + n_freq * 128 * 2)
    first_ms, _ = bound(nbytes(batch) + 4 * (2 * n_fft * n_freq + n_freq * 128) + 4 * 8 * 128 * frames,
                        first_ops, "f32")
    prof = device_profile(lambda: [mp.log_mel_pallas(batch, n_mels=128) for _ in range(5)], ["log_mel"], "log_mel_b8")
    prof1 = device_profile(lambda: [mp.log_mel_pallas(b1, n_mels=128) for _ in range(5)], ["log_mel"],
                           "log_mel_b1")["log_mel"]
    rec.setdefault("profile", {}).update(prof)
    d8 = prof["log_mel"]
    dev_txt = lambda d: "not measured" if d is None else (
        f"{d['ms_per_launch']:.4f} ms log-mel + {d['ms_total'] / d['launches'] - d['ms_per_launch']:.4f} ms clamp "
        f"= {d['ms_total'] / d['launches']:.4f} ms a call{tries_text(d)}")
    share = "" if d8 is None else f", {b_ms / (d8['ms_total'] / d8['launches']):.0%} of it"
    rec["log_mel"] = dict(launches=launches, max_abs_err=worst["dft"], ms=k_ms, plain_ms=p_ms, bound_ms=b_ms,
                          bound_by=b_by, library_ms=None)
    rec["log_mel_detail"] = dict(err_vs_rfft=worst["rfft"], b1_ms=k1_ms, b1_plain_ms=p1_ms, rfft_b8_ms=rfft_ms,
                                 b1_bound_ms=bounds[1][0], first_form_bound_ms=first_ms,
                                 device_b8=d8, device_b1=prof1)
    log(f"phase 12 log_mel: ok path B=8 x 30 s at 80 and 128 mels ({launches} launches); {n_cases} cases "
        f"(B 1/8, a silent row beside a loud one, 80/128 mels): max err vs log_mel_dft {worst['dft']:.3g}, vs "
        f"frontend/mel.py rFFT {worst['rfft']:.3g}; B=8 128 mels: kernel {k_ms:.4f} ms vs plain {p_ms:.4f} ms "
        f"(rFFT frontend rfft_b8_ms {rfft_ms:.4f} ms); B=1: kernel {k1_ms:.4f} ms vs plain {p1_ms:.4f} ms; "
        f"device-only B=8 {dev_txt(d8)} (first form 1.2876 ms){share}; B=1 {dev_txt(prof1)}; bound B=8 "
        f"{b_ms:.4f} ms ({b_by}: 3 TF32 passes of the DFT at 495 TFLOP/s, the {nnz} mel weights in f32, PCM in "
        f"and log-mel out at 3.35 TB/s), B=1 {bounds[1][0]:.4f} ms; the first form's bound (CUDA-core f32, "
        f"dense mel) {first_ms:.4f} ms")


# large-v3's special-token names beyond the text ids, in id order from the
# EOT (50257): the 99 languages, then Cantonese (v3's 100th).
def _v3_specials():
    from norma_tpu_torch.models.whisper.languages import ALL_LANGUAGES

    names = ["<|endoftext|>", "<|startoftranscript|>"] + [lang.token() for lang in ALL_LANGUAGES]
    names += ["<|yue|>", "<|translate|>", "<|transcribe|>", "<|startoflm|>", "<|startofprev|>",
              "<|nospeech|>", "<|notimestamps|>"]
    names += [f"<|{i * 0.02:.2f}|>" for i in range(1501)]
    return names


def write_v3_checkpoint(d, dev, seed=13, cfg=None):
    """A distil-large-v3-shaped checkpoint in ``d``: config.json, a
    WordLevel tokenizer.json (text ids w0..w50256, then the large-v3
    special ids of ST_V3) and a BF16 model.safetensors in HF names, of
    random weights drawn on ``dev`` from ``seed`` (linear weights
    N(0, 1/in), embeddings N(0, 0.02^2), LayerNorms 1 and 0).  ``cfg``
    (default: the distil-large-v3 preset) may shrink the widths and depths
    for a CPU rehearsal; the vocabulary stays large-v3's.  Returns the
    weights file's bytes."""
    import struct

    import numpy as np
    import torch

    from norma_tpu_torch.model import PRESETS

    cfg = cfg or PRESETS["distil-large-v3"].with_(max_source_positions=1500, max_target_positions=448)
    D, F, M, V = cfg.d_model, 4 * cfg.d_model, cfg.num_mel_bins, cfg.vocab_size
    specials = _v3_specials()
    n_text = ST_V3["eot"]
    if n_text + len(specials) != V or specials.index("<|transcribe|>") + n_text != ST_V3["task"]:
        raise AssertionError("the large-v3 token layout does not add up")
    with open(os.path.join(d, "config.json"), "w") as f:
        json.dump(dict(num_mel_bins=M, vocab_size=V, d_model=D, encoder_layers=cfg.encoder_layers,
                       encoder_attention_heads=cfg.encoder_attention_heads, decoder_layers=cfg.decoder_layers,
                       decoder_attention_heads=cfg.decoder_attention_heads,
                       max_source_positions=cfg.max_source_positions,
                       max_target_positions=cfg.max_target_positions, suppress_tokens=list(cfg.suppress_tokens)), f)
    tok = dict(
        version="1.0", truncation=None, padding=None, normalizer=None, post_processor=None, decoder=None,
        pre_tokenizer={"type": "Whitespace"},
        added_tokens=[dict(id=n_text + i, content=c, single_word=False, lstrip=False, rstrip=False,
                           normalized=False, special=True) for i, c in enumerate(specials)],
        model=dict(type="WordLevel", vocab={f"w{i}": i for i in range(n_text)}, unk_token="w0"),
    )
    with open(os.path.join(d, "tokenizer.json"), "w") as f:
        json.dump(tok, f)

    shapes = {"model.encoder.conv1.weight": (D, M, 3), "model.encoder.conv1.bias": (D,),
              "model.encoder.conv2.weight": (D, D, 3), "model.encoder.conv2.bias": (D,),
              "model.encoder.embed_positions.weight": (cfg.max_source_positions, D),
              "model.decoder.embed_tokens.weight": (V, D),
              "model.decoder.embed_positions.weight": (cfg.max_target_positions, D)}
    for side, n in (("encoder", cfg.encoder_layers), ("decoder", cfg.decoder_layers)):
        for i in range(n):
            p = f"model.{side}.layers.{i}"
            for attn in ("self_attn",) + (("encoder_attn",) if side == "decoder" else ()):
                for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
                    shapes[f"{p}.{attn}.{proj}.weight"] = (D, D)
                    if proj != "k_proj":
                        shapes[f"{p}.{attn}.{proj}.bias"] = (D,)
                ln = "self_attn_layer_norm" if attn == "self_attn" else "encoder_attn_layer_norm"
                shapes[f"{p}.{ln}.weight"] = shapes[f"{p}.{ln}.bias"] = (D,)
            shapes[f"{p}.fc1.weight"], shapes[f"{p}.fc1.bias"] = (F, D), (F,)
            shapes[f"{p}.fc2.weight"], shapes[f"{p}.fc2.bias"] = (D, F), (D,)
            shapes[f"{p}.final_layer_norm.weight"] = shapes[f"{p}.final_layer_norm.bias"] = (D,)
        shapes[f"model.{side}.layer_norm.weight"] = shapes[f"model.{side}.layer_norm.bias"] = (D,)

    g = torch.Generator(device=dev).manual_seed(seed)

    def tensor(name, shape):
        if name.endswith("norm.weight"):
            return torch.ones(shape, dtype=torch.bfloat16, device=dev)
        if name.endswith(".bias"):
            return torch.zeros(shape, dtype=torch.bfloat16, device=dev)
        scale = 0.02 if "embed" in name else (0.05 if "conv" in name else shape[1] ** -0.5)
        return (torch.randn(shape, generator=g, device=dev) * scale).to(torch.bfloat16)

    header, offset = {}, 0
    for name, shape in shapes.items():
        nb = 2 * int(np.prod(shape))
        header[name] = {"dtype": "BF16", "shape": list(shape), "data_offsets": [offset, offset + nb]}
        offset += nb
    hj = json.dumps(header).encode()
    path = os.path.join(d, "model.safetensors")
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(hj)))
        f.write(hj)
        for name, shape in shapes.items():
            f.write(tensor(name, shape).view(torch.int16).cpu().numpy().tobytes())
    return os.path.getsize(path)


def phase_definition(rec, dev, ckpt_dir=None, stream_s=36.0, min_fed_s=35.0, dtype=None):
    """The public entry point at full width (the defaults).  A CPU
    rehearsal passes the fixture checkpoint's directory, a short stream
    and torch.float32; it checks everything but the launch counts (the
    plain versions launch nothing)."""
    import contextlib
    import tempfile
    import threading

    import numpy as np
    import torch

    from norma_tpu_torch import Transcriber
    from norma_tpu_torch.audio.sources import SyntheticSource
    from norma_tpu_torch.input import Settings
    from norma_tpu_torch.models import SelectedDevice
    from norma_tpu_torch.models.whisper import monolingual, multilingual

    cuda = torch.device(dev).type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    device = SelectedDevice.cuda() if cuda else SelectedDevice.cpu()
    dtype = dtype or torch.bfloat16
    counters = kernel_counters()
    tmp = tempfile.TemporaryDirectory(prefix="norma_v3_ckpt_") if ckpt_dir is None else contextlib.nullcontext(ckpt_dir)
    with tmp as d:
        t0 = time.perf_counter()
        nbytes = write_v3_checkpoint(d, dev) if ckpt_dir is None else os.path.getsize(os.path.join(d, "model.safetensors"))
        write_s = time.perf_counter() - t0
        defn = monolingual.Definition(
            monolingual.ModelType.DISTIL_LARGE_EN_V3, device, local_dir=d, dtype=dtype,
            quantize_decoder=True, quantize_logits="int4", quantize_encoder=True, quantize_cross_kv=True,
            config_overrides={"encoder_attn_impl": "jax_flash", "cross_kv_impl": "kernel",
                              "self_kv_impl": "kernel"},
        )
        models = []
        build = defn.blocking_try_to_model
        defn.blocking_try_to_model = lambda: models.append(build()) or models[-1]
        t0 = time.perf_counter()
        jh, th = Transcriber.blocking_spawn(defn)
        load_s = time.perf_counter() - t0
        model = models[0]
        engine = model.engine
        dec = engine.params["decoder"]
        V, D = dec["tok_emb"].shape
        head_bytes = dict(int4=sum(t.numel() * t.element_size() for t in dec["tok_emb_q4"].buffers()),
                          int8=D * V + 4 * V)
        if "tok_emb_q8" in dec or dec["tok_emb_q4"]["s"].dtype != torch.bfloat16:
            raise AssertionError("the Definition did not build the int4 head alone")
        windows, fed, rings = [], [0], []
        inner_window, inner_transcribe = engine.transcribe_window, model.transcribe

        def timed_window(audio, langs, seed, n_active=None):
            sync()
            s0, h0, w0 = engine.decode_steps, engine.host_syncs, time.perf_counter()
            out = inner_window(audio, langs, seed, n_active)
            sync()
            windows.append(dict(ms=(time.perf_counter() - w0) * 1e3, steps=engine.decode_steps - s0,
                                syncs=engine.host_syncs - h0, audio=audio, langs=langs))
            return out

        def counted_transcribe(data, final_chunk):
            fed[0] += len(data)
            return inner_transcribe(data, final_chunk)

        open_stream = Transcriber._open_stream

        def keep_ring(self, settings):
            pipeline, ring = open_stream(self, settings)
            rings.append(ring)
            return pipeline, ring

        engine.transcribe_window, model.transcribe = timed_window, counted_transcribe
        Transcriber._open_stream = keep_ring
        texts = []
        try:
            model.warmup()  # first-use costs (kernel build, allocator) outside the measured stream
            windows.clear()
            # ---- the main path: counts from zero ----
            for c in counters.values():
                c.launches = 0
            if cuda:
                torch.cuda.reset_peak_memory_stats(dev)
            src = SyntheticSource(sample_rate=16000, channels=1, dtype=np.float32, freq=330.0, noise=0.05,
                                  realtime=True, seed=13)
            w0 = time.perf_counter()
            stream = th.blocking_start(Settings(source=src))
            reader = threading.Thread(target=lambda: texts.extend(stream), daemon=True)
            reader.start()
            time.sleep(stream_s)
            th.stop()
            reader.join(timeout=120)
            sync()
            wall_s = time.perf_counter() - w0
            launches = {k: c.launches for k, c in counters.items()}
            peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
            # ---- end of the main path ----
            th.close()
            jh.join(timeout=60)  # raises the run loop's error, if any
        finally:
            Transcriber._open_stream = open_stream
            engine.transcribe_window, model.transcribe = inner_window, inner_transcribe
        if reader.is_alive():
            raise AssertionError("the string stream never ended after stop()")
        if len(rings) != 1 or rings[0].dropped:
            raise AssertionError(f"audio dropped: rings {[r.dropped for r in rings]}")
        if fed[0] < min_fed_s * 16000:
            raise AssertionError(f"only {fed[0] / 16000:.1f} s of audio reached the model")
        if model.longform.buf.size:
            raise AssertionError(f"{model.longform.buf.size} samples left after the final chunk")
        missing = [k for k, v in launches.items() if v <= 0]
        if cuda and missing:
            raise AssertionError(f"kernels not launched during the streamed run: {missing}")
        # Segments decode one by one and concatenate: text is "wN" words.
        for text in texts:
            if not (re.fullmatch(r"(\s*w\d+)+\s*", text)
                    and all(int(i) < ST_V3["eot"] for i in re.findall(r"w(\d+)", text))):
                raise AssertionError(f"streamed text is not WordLevel text: {text[:80]!r}")
        for k in ("w8_matmul", "w4_matmul"):
            rec.setdefault(k, {})["launches"] = launches[k]
        # The first streamed window again, graph loop against the per-step
        # eager loop (bf16, int4 head: tokens equal).
        first = windows[0]
        modes13 = window_modes(engine, first["audio"], first["langs"], 0) if cuda else {}
        one_read13 = one_read_window(engine, first["audio"], first["langs"], 0)[1] if cuda else None
        windows = [{k: v for k, v in w.items() if k not in ("audio", "langs")} for w in windows]

        # Multilingual detect mode with the int8 self-KV cache: one window.
        mdef = multilingual.Definition(
            multilingual.ModelType.LARGE_V3, device, multilingual.Task.TRANSCRIBE, local_dir=d,
            dtype=dtype, quantize_self_kv=True, quantize_logits="int4",
            config_overrides={"self_kv_impl": "kernel"},
        )
        mmodel = mdef.blocking_try_to_model()
        sr = 16000
        tt = np.arange(30 * sr) / sr
        audio = (0.2 * np.sin(2 * np.pi * 250 * tt) + 0.05 * np.random.default_rng(14).standard_normal(tt.size))
        before = {k: c.launches for k, c in counters.items()}
        sync()
        m0, ms0 = time.perf_counter(), mmodel.engine.decode_steps
        mtext = mmodel.transcribe(audio.astype(np.float32), final_chunk=True)
        sync()
        multi_ms, multi_steps = (time.perf_counter() - m0) * 1e3, mmodel.engine.decode_steps - ms0
        moved = {k: c.launches - before[k] for k, c in counters.items()}
        if not (mmodel.engine.quantize_self_kv and multi_steps > 0 and (moved["w4_matmul"] > 0 or not cuda)):
            raise AssertionError(f"multilingual self-KV window: steps {multi_steps}, launches {moved}")
        if moved["self_decode"]:
            raise AssertionError("the self-decode kernel ran on an int8 self-KV cache")
        if mmodel.longform.buf.size or mmodel.longform.lang.detected is not None:
            raise AssertionError("detect-mode window did not drain or did not clear its language")
        del mmodel
        quant = quantized_checkpoint(d, defn, first, engine, device, dtype)
        example = file_transcribe_example(d, cuda)
    rec["definition"] = dict(windows=windows, modes=modes13, wall_s=wall_s, fed_s=fed[0] / 16000, peak_bytes=peak,
                             launches=launches, head_bytes=head_bytes, ckpt_bytes=nbytes, write_s=write_s,
                             load_s=load_s, multi_ms=multi_ms, multi_steps=multi_steps)
    log(f"phase 13 definition: ok distil-large-v3 BF16 checkpoint {nbytes / 2**30:.2f} GiB written in {write_s:.1f} s, "
        f"Definition + Transcriber.blocking_spawn {load_s:.1f} s; streamed {fed[0] / 16000:.1f} s real time in "
        f"{wall_s:.1f} s, no drops, stop/close/join clean; windows wall_ms={[round(w['ms'], 1) for w in windows]} "
        f"steps={[w['steps'] for w in windows]} host_syncs={[w['syncs'] for w in windows]}; {len(texts)} strings; "
        f"peak_mem={peak / 2**30:.2f} GiB; "
        f"launches={launches}; head bytes int4 {head_bytes['int4']} vs int8 {head_bytes['int8']}; multilingual "
        f"detect + int8 self-KV window {multi_ms:.1f} ms, {multi_steps} steps, self-decode launches 0, "
        f"{len(mtext)} chars")
    if modes13:
        log(f"  definition window, graph vs per-step eager loop (tokens equal): {modes_text(modes13)}")
        log(f"  definition warm window: {one_read_text(one_read13)}")
        rec["definition"]["one_read"] = one_read13
    log(f"  quantize_checkpoint {' '.join(quant['flags'])}: {quant['tool_s']:.1f} s, {quant['bytes'] / 2**30:.2f} GiB "
        f"params file; Definition(local_dir=<its output>) loaded in {quant['load_s']:.1f} s; the first streamed "
        f"window decodes the same tokens as the model quantized in memory ({quant['tokens']} tokens)")
    log(f"  norma_tpu_torch/examples/file_transcribe.py on this checkpoint, {example['audio_s']:g} s WAV: exit 0 in "
        f"{example['wall_s']:.1f} s, {len(example['lines'])} streamed line(s)")
    rec["definition"].update(quant=quant, example={k: v for k, v in example.items() if k != "lines"})


def quantized_checkpoint(d, defn, window, engine, device, dtype):
    """The port's offline quantizer on the checkpoint in ``d`` with the
    tiers ``defn`` quantized in memory (``engine``'s model); its output,
    served through a Definition's ``local_dir``, must decode ``window``
    (the first streamed window) to the same tokens."""
    import torch

    from norma_tpu_torch.models.whisper import monolingual
    from norma_tpu_torch.tools import quantize_checkpoint

    flags = ["--dtype", "bf16" if dtype == torch.bfloat16 else "f32", "--decoder", "--logits", "int4", "--encoder"]
    out = os.path.join(d, "quantized")
    t0 = time.perf_counter()
    path = quantize_checkpoint.main([d, out] + flags)
    tool_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    qmodel = monolingual.Definition(
        monolingual.ModelType.DISTIL_LARGE_EN_V3, device, local_dir=out, dtype=dtype, quantize_decoder=True,
        quantize_logits="int4", quantize_encoder=True, quantize_cross_kv=defn.quantize_cross_kv,
        config_overrides=defn.config_overrides,
    ).blocking_try_to_model()
    load_s = time.perf_counter() - t0
    want, _ = engine.transcribe_window(window["audio"], window["langs"], 0)
    got, _ = qmodel.engine.transcribe_window(window["audio"], window["langs"], 0)
    want, got = [r and r.tokens for r in want], [r and r.tokens for r in got]
    if got != want:
        raise AssertionError(f"the quantized checkpoint decodes other tokens: {got} vs {want}")
    return dict(flags=flags, tool_s=tool_s, load_s=load_s, bytes=os.path.getsize(path),
                tokens=sum(len(t or []) for t in want))


def file_transcribe_example(d, cuda, seconds=12.0):
    """``python -m norma_tpu_torch.examples.file_transcribe WAV d`` in a
    subprocess, on a WAV it writes (a tone and noise, 16-bit mono 16 kHz):
    exit 0 and at least one streamed line."""
    import wave

    import numpy as np

    sr = 16000
    t = np.arange(int(seconds * sr)) / sr
    pcm = 0.3 * np.sin(2 * np.pi * 300 * t) + 0.05 * np.random.default_rng(15).standard_normal(t.size)
    wav = os.path.join(d, "example.wav")
    with wave.open(wav, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes((pcm * 32767).astype(np.int16).tobytes())
    env = dict(os.environ)
    if not cuda:
        env["CUDA_VISIBLE_DEVICES"] = ""  # the example's SelectedDevice.auto() then takes the CPU
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "norma_tpu_torch.examples.file_transcribe", wav, d], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=600)
    wall_s = time.perf_counter() - t0
    lines = [x for x in r.stdout.splitlines() if x.strip()]
    if r.returncode != 0 or not lines:
        raise AssertionError(f"file_transcribe exited {r.returncode} with {len(lines)} lines; stderr: {r.stderr[-2000:]}")
    return dict(audio_s=seconds, wall_s=wall_s, lines=lines)


# --------------------------------------------------------------------------
# Phase 14: speculative decoding, a large-v3 target with a distil-large-v3
# draft.
# --------------------------------------------------------------------------

# The verify chunk's sampling rows, B x (K+1): B=1 K=4, B=8 K=4, B=8 K=12.
SPEC_ROWS = (5, 40, 104)
# The logits' spread in phase 14's weights (the decoders' final LayerNorm
# gain is set for it): a peaked softmax, so greedy decodes pass the
# logprob gate at rung 0.
SPEC_LOGIT_STD = 12.0


def device_params(cfg, seed, dtype, dev, encoder=None, logit_std=None):
    """Random params in the port's layout drawn on ``dev`` from ``seed``:
    linear weights N(0, 1/in), embeddings N(0, 0.02^2), convolutions
    N(0, 0.05^2), biases 0, LayerNorms 1 and 0, sinusoidal encoder
    positions (``model/load.py::init_params``'s laws, not its draws).
    ``encoder`` shares an existing encoder subtree (distil-large-v3's
    encoder is a copy of large-v3's); ``logit_std`` sets the decoder's final
    LayerNorm gain so that the logits spread about that much (a LayerNorm
    output of norm sqrt(D) x gain against N(0, 0.02^2) embeddings)."""
    import torch

    from norma_tpu_torch.model.load import Params, sinusoids

    g = torch.Generator(device=dev).manual_seed(seed)
    D, V, F = cfg.d_model, cfg.vocab_size, 4 * cfg.d_model

    def w(*shape, scale=None):
        scale = shape[-2] ** -0.5 if scale is None else scale
        return (torch.randn(shape, generator=g, device=dev) * scale).to(dtype)

    def const(v, *shape):
        return torch.full(shape, float(v), dtype=dtype, device=dev)

    def layers(L, cross):
        t = {}
        for px in ("", "x") if cross else ("",):
            t.update({f"{px}q_w": w(L, D, D), f"{px}q_b": const(0, L, D), f"{px}k_w": w(L, D, D),
                      f"{px}v_w": w(L, D, D), f"{px}v_b": const(0, L, D), f"{px}o_w": w(L, D, D),
                      f"{px}o_b": const(0, L, D)})
        for ln in ("attn", "mlp") + (("xattn",) if cross else ()):
            t[f"{ln}_ln_g"], t[f"{ln}_ln_b"] = const(1, L, D), const(0, L, D)
        t.update(fc1_w=w(L, D, F), fc1_b=const(0, L, F), fc2_w=w(L, F, D), fc2_b=const(0, L, D))
        return {k: t[k] for k in sorted(t)}

    if encoder is None:
        encoder = {
            "conv1_w": w(3, cfg.num_mel_bins, D, scale=0.05), "conv1_b": const(0, D),
            "conv2_w": w(3, D, D, scale=0.05), "conv2_b": const(0, D),
            "pos": torch.from_numpy(sinusoids(cfg.max_source_positions, D)).to(dev, dtype),
            "layers": layers(cfg.encoder_layers, False), "ln_g": const(1, D), "ln_b": const(0, D),
        }
    gain = 1.0 if logit_std is None else logit_std / (0.02 * D ** 0.5)
    decoder = {
        "tok_emb": w(V, D, scale=0.02), "pos_emb": w(cfg.max_target_positions, D, scale=0.02),
        "layers": layers(cfg.decoder_layers, True), "ln_g": const(gain, D), "ln_b": const(0, D),
    }
    return Params({"encoder": encoder, "decoder": decoder})


def spec_configs(cfg=None, dcfg=None, st=None, lang_ids=None):
    """Phases 14 and 20's speculative configs, full width (the defaults): a
    large-v3 target and a distil-large-v3 draft at mtp 448, their tokens."""
    from norma_tpu_torch.decode import SpecialTokens
    from norma_tpu_torch.model import PRESETS

    cfg = cfg or PRESETS["large-v3"].with_(max_target_positions=448, decode_buckets=(128, 256))
    dcfg = dcfg or PRESETS["distil-large-v3"].with_(max_target_positions=448)
    return cfg, dcfg, st or SpecialTokens(**ST_V3), lang_ids or LANG_IDS_V3


def spec_windows(cfg, seconds=30.0):
    """Phases 14 and 20's windows: {B: (audio [B, samples], active rows)}
    for B=1 and a padded B=8 (5 active), shifts of one gain of a sine in
    noise."""
    import numpy as np

    from norma_tpu_torch.frontend.mel import prepare_audio

    rng = np.random.default_rng(14)
    tt = np.arange(int(seconds * 16000)) / 16000
    base = (0.15 * np.sin(2 * np.pi * 440 * tt) + 0.05 * rng.standard_normal(tt.size)).astype(np.float32)
    batch = np.stack([prepare_audio(base * (1.0 + 0.1 * i), 2 * cfg.max_source_positions) for i in range(8)])
    return base, {1: (batch[:1], 1), 8: (batch, 5)}


def spec_params(cfg, dcfg, dev, quantized: bool):
    """Phases 14 and 20's seeded target and draft (the draft shares the
    target's encoder): f32 with fused QKV, or bf16 with the serving knobs
    (fused QKV, int8 decoder, int4 head, w8a8 encoder; an int8 draft)."""
    import torch

    from norma_tpu_torch.model import fuse_qkv
    from norma_tpu_torch.model.quant import quantize_decoder, quantize_encoder

    if not quantized:
        f32 = torch.float32
        params = fuse_qkv(device_params(cfg, 31, f32, dev, logit_std=SPEC_LOGIT_STD))
        return params, fuse_qkv(device_params(dcfg, 32, f32, dev, encoder=params["encoder"], logit_std=SPEC_LOGIT_STD))
    bf16 = torch.bfloat16
    pq = quantize_encoder(quantize_decoder(fuse_qkv(device_params(cfg, 31, bf16, dev, logit_std=SPEC_LOGIT_STD)),
                                           logits="int4"))
    return pq, quantize_decoder(fuse_qkv(device_params(dcfg, 32, bf16, dev, encoder=pq["encoder"],
                                                       logit_std=SPEC_LOGIT_STD)))


def spec_packed(spec, windows, B, k, dev, lang, eager=False):
    """The greedy speculative rung of window B on ``spec`` (a speculative
    engine, or a one-position mesh engine's replica), as the packed host
    rows: tokens, n, ..., live rounds last.  On the card one window graph
    (``SpeculativeEngine._spec_packed``: one host read); ``eager``: round
    by round, a host read before each."""
    import numpy as np

    eng = spec.replicas[0].engine if hasattr(spec, "replicas") else spec
    audio, na = windows[B]
    active = np.zeros(B, bool)
    active[:na] = True
    return eng._spec_packed(audio, np.full(B, lang), active, False, k, eager=eager)[0]


def spec_program(spec, windows, B, k):
    """The window graph ``spec_packed`` replays for window B at K ``k``
    (None before its first call, or off the card)."""
    eng = spec.replicas[0].engine if hasattr(spec, "replicas") else spec
    return eng._programs.get(("spec", B, windows[B][0].shape[-1], False, k))


# Phase 14's bf16 window walls while its round loop was read on the host
# in chunks of 8 rounds (PERF.md, section 5: NVIDIA H100 80GB HBM3, 700 W),
# printed beside this run's: B=1 medians and B=8 (its first window, with
# the captures), speculative and plain.
SPEC_WALLS_CHUNKED_MS = {1: dict(spec=5024.4, plain=5900.6), 8: dict(spec=13800.9, plain=8671.3)}


def phase_speculative(rec, dev, cfg=None, dcfg=None, st=None, lang_ids=None, public_cfgs=None, seconds=30.0):
    """Speculative decoding at full width (the defaults): a large-v3 target
    (32/32 layers) and a distil-large-v3 draft (2 decoder layers sharing
    the target's encoder), seeded random weights drawn on the card.  A CPU
    rehearsal passes tiny configs, their special tokens and ``public_cfgs``
    (tiny configs with large-v3's vocabulary for the checkpoint writer); it
    checks everything but the kernel launches and graphs."""
    import gc
    import tempfile

    import numpy as np
    import torch

    from norma_tpu_torch.decode import DecodeEngine, SpeculativeEngine
    from norma_tpu_torch.frontend.mel import log_mel_spectrogram
    from norma_tpu_torch.model import PRESETS, fuse_qkv
    from norma_tpu_torch.model.whisper import decoder_full, encode
    from norma_tpu_torch.models import SelectedDevice
    from norma_tpu_torch.models.whisper import monolingual
    from norma_tpu_torch.ops import flash_encoder, quant_matmul, sample_step

    cuda = torch.device(dev).type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    cfg, dcfg, st, lang_ids = spec_configs(cfg, dcfg, st, lang_ids)
    lang = lang_ids[0]
    Tmax, n_frames = cfg.max_target_positions, 2 * cfg.max_source_positions
    base, windows = spec_windows(cfg, seconds)  # B -> (audio, active rows)

    def cleanup(toks):  # the trailing-timestamp cleanup of every decode
        toks = list(toks)
        while len(toks) >= 2 and toks[-2] > st.no_timestamps:
            del toks[-2]
        return toks

    def greedy_rows(engine, B):
        """The plain engine's greedy (t=0) decode of window B."""
        audio, na = windows[B]
        return [d.tokens for d in engine.run_loop(engine.prefill_window(audio, lang), 0.0, 0)[:na]]

    def spec_rows(packed, na):
        """Each row's tokens; None for a no-speech row (born finished)."""
        return [None if packed[b, Tmax + 3] > 0.6 else cleanup(packed[b, :int(packed[b, Tmax])].astype(np.int64))
                for b in range(na)]

    def margin(engine, B, b, toks, i):
        """Top-2 logit margin of the target at the first differing position."""
        mel = log_mel_spectrogram(torch.from_numpy(windows[B][0][b:b + 1]).to(dev), n_mels=cfg.num_mel_bins,
                                  n_frames=n_frames)
        feats = encode(engine.params, engine.cfg, mel)
        top = decoder_full(engine.params, engine.cfg, torch.tensor([toks[:i]], device=dev), feats)[0, -1].topk(2)
        return float(top.values[0] - top.values[1])

    def check_equal(name, engine, B, want, got, gate=True):
        """Rows equal, or the first differing position and margin (raised
        when ``gate``); returns the rows equal."""
        equal = []
        for b, (w_, g_) in enumerate(zip(want, got)):
            if g_ is None:  # no-speech: the plain ladder decodes nothing either
                continue
            equal.append(w_ == g_)
            if w_ != g_:
                i = next((j for j, (x, y) in enumerate(zip(w_, g_)) if x != y), min(len(w_), len(g_)))
                msg = (f"{name}: B={B} row {b} differs from the plain engine at position {i} "
                       f"(plain {w_[i:i + 3]}, speculative {g_[i:i + 3]}), target top-2 logit margin there "
                       f"{margin(engine, B, b, w_, i):.3g}")
                if gate:
                    raise AssertionError(msg)
                log("  " + msg)
        return equal

    def rung0(r):  # a decoded row accepted at t=0 (not no-speech, not failed)
        return r is not None and r.no_speech_prob <= 0.6 and not r.avg_logprob < -1.0

    def free():
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()

    # What phase 20 compares its tp=2 engines with, in the same run.
    spec_ref = rec["_spec_ref"] = {}

    # ---- 1. f32, exact, the full target ----------------------------------
    f32 = torch.float32
    t0 = time.perf_counter()
    params, dparams = spec_params(cfg, dcfg, dev, quantized=False)
    sync()
    make_s = time.perf_counter() - t0
    plain = DecodeEngine(params, cfg, st, language_token_ids=lang_ids)
    spec4 = SpeculativeEngine(params, cfg, dparams, dcfg, st, language_token_ids=lang_ids, spec_k=4)
    f32_out = {}
    for B in (1, 8):
        sync()
        w0 = time.perf_counter()
        want = greedy_rows(plain, B)
        sync()
        plain_ms = (time.perf_counter() - w0) * 1e3
        h0, c0, w0 = spec4.host_syncs, spec4.graph_captures, time.perf_counter()
        packed = spec_packed(spec4, windows, B, 4, dev, lang)
        sync()
        spec_ms, reads = (time.perf_counter() - w0) * 1e3, spec4.host_syncs - h0
        check_equal("f32 spec_k=4", plain, B, want, spec_rows(packed, windows[B][1]))
        rounds = int(packed[:, -1].max())
        # The window is one program: one host read, its fetch; its round
        # loop's WHILE node ran one pass a round.
        prog = spec_program(spec4, windows, B, 4)
        passes = prog.passes if prog is not None else None
        if reads != 1 or (cuda and (passes != [rounds] or spec4.graph_captures - c0 != 1)):
            raise AssertionError(f"B={B}: {reads} host reads (want 1), WHILE passes {passes} for {rounds} rounds, "
                                 f"{spec4.graph_captures - c0} graphs captured (want 1)")
        f32_out[B] = dict(rounds=packed[:, -1].astype(int).tolist(), n=packed[:, Tmax].astype(int).tolist(),
                          reads=reads, passes=passes, plain_greedy_ms=plain_ms, spec_ms=spec_ms)
        spec_ref.setdefault("f32", {})[B] = packed  # phase 20 holds tp=2 to these rows
    graphs = window_graph_stats(spec4, kinds=("spec",)) if cuda else []
    del plain, spec4
    free()
    log(f"phase 14 speculative: f32 large-v3 target ({cfg.decoder_layers} decoder layers) + distil-large-v3 "
        f"draft ({dcfg.decoder_layers}), drawn in {make_s:.1f} s: spec_k=4 tokens equal to the plain greedy decode "
        f"at B=1 and B=8 (5 active); " + "; ".join(
            f"B={B}: rounds {v['rounds'][:windows[B][1]]} for n {v['n'][:windows[B][1]]}, {v['reads']} host read(s), "
            f"WHILE passes {v['passes']}, window {v['spec_ms']:.1f} ms with its capture (plain greedy loop "
            f"{v['plain_greedy_ms']:.1f} ms)" for B, v in f32_out.items()))
    log(f"  speculative window graphs (f32 spec_k=4): {graph_stats_text(graphs) if cuda else 'cpu'}")

    # ---- 1b. f32, the target's decoder cut to 4 layers: "auto", the
    # self-draft, the graphs against the round-by-round eager twin --------
    ccfg = cfg.with_(decoder_layers=min(4, cfg.decoder_layers))
    cut = fuse_qkv(device_params(ccfg, 33, f32, dev, encoder=params["encoder"], logit_std=SPEC_LOGIT_STD))
    plain = DecodeEngine(cut, ccfg, st, language_token_ids=lang_ids)
    auto = SpeculativeEngine(cut, ccfg, dparams, dcfg, st, language_token_ids=lang_ids, spec_k="auto")
    selfd = SpeculativeEngine(cut, ccfg, cut, ccfg, st, language_token_ids=lang_ids, spec_k=4)
    want = {B: greedy_rows(plain, B) for B in (1, 8)}
    # "auto": the public window (rows accepted at rung 0 compared), and
    # where none was, the greedy loop at the K the window used.
    compared, ks = 0, []
    for B in (1, 1, 8):
        out, _ = auto.transcribe_window(windows[B][0], [lang] * B, 0, n_active=windows[B][1])
        ks.append(auto.last_spec_k)
        rows = [(i, r) for i, r in enumerate(out[:windows[B][1]]) if rung0(r)]
        check_equal("f32 spec_k=auto", plain, B, [want[B][i] for i, _ in rows], [r.tokens for _, r in rows])
        compared += len(rows)
        if not rows:
            check_equal("f32 spec_k=auto (greedy loop)", plain, B, want[B],
                        spec_rows(spec_packed(auto, windows, B, ks[-1], dev, lang), windows[B][1]))
    # The self-draft accepts every proposal: each row's rounds are the fewest
    # that commit its tokens, K+1 a round but the last (which may add the
    # length limit's EOT).
    packed = spec_packed(selfd, windows, 1, 4, dev, lang)
    check_equal("f32 self-draft", plain, 1, want[1], spec_rows(packed, 1))
    r, committed = int(packed[0, -1]), int(packed[0, Tmax]) - 3
    if not (r >= 1 and (r - 1) * 5 < committed <= r * 5 + 1):
        raise AssertionError(f"self-draft did not accept every proposal: {committed} tokens in {r} rounds")
    selfdraft = dict(rounds=r, tokens=committed)
    # The window graph against the round-by-round eager window, warm: the
    # packed rows (rounds included) and the public window's results bit
    # for bit, in turns graph, eager, eager, graph.
    modes, rows_by_mode, results = {"graph": [], "eager": []}, {}, {}
    for mode in ("graph", "eager", "eager", "graph"):
        eager = mode == "eager"
        sync()
        h0, w0 = selfd.host_syncs, time.perf_counter()
        rows_by_mode[mode] = spec_packed(selfd, windows, 1, 4, dev, lang, eager=eager)
        sync()
        modes[mode].append(((time.perf_counter() - w0) * 1e3, selfd.host_syncs - h0))
    for mode in ("graph", "eager"):
        run = selfd.transcribe_window_eager if mode == "eager" else selfd.transcribe_window
        results[mode] = run(windows[1][0], [lang], 0)[0]
    if not np.array_equal(rows_by_mode["graph"], rows_by_mode["eager"], equal_nan=True):
        raise AssertionError("the speculative window graph and the round-by-round eager window differ")
    if not all(_same_result(a, b) for a, b in zip(results["graph"], results["eager"])):
        raise AssertionError("transcribe_window and transcribe_window_eager differ on the self-draft B=1 window")
    if any(reads != 1 for _, reads in modes["graph"]):
        raise AssertionError(f"self-draft window graph host reads {[x[1] for x in modes['graph']]}, want 1 each")
    modes = {k: dict(ms=[round(x[0], 1) for x in v], reads=[x[1] for x in v]) for k, v in modes.items()}
    del plain, auto, selfd, cut, params, dparams
    free()
    log(f"  f32 at {ccfg.decoder_layers} target decoder layers: 'auto' (K used {ks}) equal to the plain greedy "
        f"decode on {compared} rung-0 rows; self-draft {committed} tokens in {r} rounds (all accepted); self-draft "
        f"B=1 window graph {modes['graph']['ms']} ms ({modes['graph']['reads']} host reads) vs round by round eager "
        f"{modes['eager']['ms']} ms ({modes['eager']['reads']} reads): packed rows bit for bit; "
        f"transcribe_window equal to transcribe_window_eager")

    # ---- 2-4. bf16 serving knobs, the full target -------------------------
    bf16 = torch.bfloat16
    cfgq = cfg.with_(encoder_attn_impl="flash", encoder_q8_mode="w8a8")
    pq, dq = spec_params(cfg, dcfg, dev, quantized=True)
    plain = DecodeEngine(pq, cfgq, st, language_token_ids=lang_ids)
    spec = SpeculativeEngine(pq, cfgq, dq, dcfg, st, language_token_ids=lang_ids, spec_k=4)
    counters = {"sample_step": sample_step.sample_step, "w8_matmul": quant_matmul.w8_matmul,
                "w4_matmul": quant_matmul.w4_matmul, "flash_encoder": flash_encoder.flash_self_attention,
                "q8a8": quant_matmul.q8a8_dense}
    audio8, na8 = windows[8]
    fallbacks = []  # each speculative window's fallback runs (a second host read each)
    inner_fb = spec._fallback
    spec._fallback = lambda *a, **k: (fallbacks.append(1), inner_fb(*a, **k))[1]
    # ---- the speculative path: counts from zero ----
    for c in counters.values():
        c.launches = 0
    sync()
    w0 = time.perf_counter()
    out_s, _ = spec.transcribe_window(audio8, [lang] * 8, 0, n_active=na8)
    sync()
    spec8_ms = (time.perf_counter() - w0) * 1e3
    launches = {k: c.launches for k, c in counters.items()}
    # ---- end of the path ----
    rounds8 = (spec.last_spec_rounds, spec.last_tokens_per_round)
    spec_ref["bf16"] = {8: [None if r is None else r.tokens for r in out_s]}
    w0 = time.perf_counter()
    out_p, _ = plain.transcribe_window(audio8, [lang] * 8, 0, n_active=na8)
    sync()
    plain8_ms = (time.perf_counter() - w0) * 1e3
    equal_bf16 = [a is not None and b is not None and a.tokens == b.tokens for a, b in zip(out_p[:na8], out_s[:na8])]
    if cuda and any(v <= 0 for v in launches.values()):
        raise AssertionError(f"kernels not launched on the speculative path: {launches}")
    if any(r is None or not all(0 <= x < cfg.vocab_size for x in r.tokens) for r in out_s[:na8]):
        raise AssertionError("bf16 speculative rows out of range or empty")
    if any(r is not None for r in out_s[na8:]):
        raise AssertionError("pad rows gave results")
    # Warm walls, the two engines in turns (each one's first window of a
    # shape captures its graphs; at B=1 the median of three leaves that one
    # out).  A speculative window makes one host read, two with its
    # fallback.
    w = {(who, B): [] for who in ("plain", "spec") for B in (1, 8)}
    reads = {1: [], 8: []}
    for who, B in (("spec", 1), ("plain", 1), ("plain", 1), ("spec", 1), ("spec", 1), ("plain", 1),
                   ("spec", 8), ("plain", 8)):
        eng = plain if who == "plain" else spec
        audio, na = windows[B]
        sync()
        h0, f0, w0 = eng.host_syncs, len(fallbacks), time.perf_counter()
        res, _ = eng.transcribe_window(audio, [lang] * B, 0, n_active=na)
        sync()
        w[who, B].append((time.perf_counter() - w0) * 1e3)
        if who == "spec":
            spec_ref["bf16"][B] = [None if r is None else r.tokens for r in res]
            reads[B].append((eng.host_syncs - h0, len(fallbacks) - f0))
    if any(n != 1 + f for B in reads for n, f in reads[B]):
        raise AssertionError(f"speculative window host reads (reads, fallbacks) {reads}: want 1, 2 with a fallback")
    walls = dict(plain_ms=w["plain", 1], spec_ms=w["spec", 1], plain_median_ms=float(np.median(w["plain", 1])),
                 spec_median_ms=float(np.median(w["spec", 1])), rounds=spec.last_spec_rounds,
                 tokens_per_round=spec.last_tokens_per_round, spec_reads=reads,
                 b8=dict(spec_ms=spec8_ms, plain_ms=plain8_ms, rounds=rounds8[0], tokens_per_round=rounds8[1],
                         warm_spec_ms=w["spec", 8], warm_plain_ms=w["plain", 8]))
    del plain, spec, pq, dq
    free()
    smi = smi_line() if cuda else "cpu"
    log(f"  bf16 serving knobs (fuse_qkv, int8 decoder, int4 head, w8a8 + flash encoder; draft int8), full "
        f"target: B=8 (5 active) rows equal to the plain engine {equal_bf16} (printed, not gated: bf16 on random "
        f"weights); launches in that speculative window {launches}; its wall {spec8_ms:.1f} ms with first-use "
        f"captures (plain {plain8_ms:.1f} ms), {rounds8[0]} rounds, {rounds8[1]} tokens/round; warm B=8: "
        f"speculative {[round(x, 1) for x in w['spec', 8]]} ms, plain {[round(x, 1) for x in w['plain', 8]]} ms")
    log(f"  bf16 B=1 window walls on {smi}: plain {[round(x, 1) for x in walls['plain_ms']]} ms (median "
        f"{walls['plain_median_ms']:.1f}), speculative {[round(x, 1) for x in walls['spec_ms']]} ms (median "
        f"{walls['spec_median_ms']:.1f}); with the round loop read on the host in chunks (PERF.md, section 5), "
        f"speculative / plain ms: " + "; ".join(f"B={B} {v['spec']} / {v['plain']}" for B, v in
                                                 SPEC_WALLS_CHUNKED_MS.items())
        + f"; {walls['rounds']} rounds, {walls['tokens_per_round']} tokens/round; host reads, fallbacks by B {reads}")

    # ---- 5. the public entry: Definitions over checkpoints on disk -------
    tcfg5, dcfg5 = public_cfgs or (
        PRESETS["large-v3"].with_(encoder_layers=4, decoder_layers=4, max_target_positions=448),
        PRESETS["distil-large-v3"].with_(encoder_layers=4, max_target_positions=448),
    )
    device = SelectedDevice.cuda() if cuda else SelectedDevice.cpu()
    with tempfile.TemporaryDirectory(prefix="norma_spec_ckpt_") as d:
        dt, dd = os.path.join(d, "target"), os.path.join(d, "draft")
        os.makedirs(dt)
        os.makedirs(dd)
        t0 = time.perf_counter()
        nb = write_v3_checkpoint(dt, dev, seed=41, cfg=tcfg5) + write_v3_checkpoint(dd, dev, seed=42, cfg=dcfg5)
        write_s = time.perf_counter() - t0
        kw = dict(local_dir=dt, dtype=bf16, quantize_decoder=True, quantize_logits="int4")
        model = monolingual.Definition(monolingual.ModelType.DISTIL_LARGE_EN_V3, device, draft_local_dir=dd,
                                       spec_k=4, **kw).blocking_try_to_model()
        pmodel = monolingual.Definition(monolingual.ModelType.DISTIL_LARGE_EN_V3, device, **kw).blocking_try_to_model()
        if not (isinstance(model.engine, SpeculativeEngine) and model.engine.draft_cfg.decoder_layers
                == dcfg5.decoder_layers):
            raise AssertionError("the Definition with draft_local_dir did not build the speculative engine")
        fallback_runs = []
        inner = model.engine.warmup_fallback
        model.engine.warmup_fallback = lambda *a: (fallback_runs.append(a), inner(*a))[1]
        model.warmup()
        if not fallback_runs:
            raise AssertionError("warmup() did not run the speculative engine's fallback")
        caps0 = model.engine.graph_captures
        chunks = np.array_split(base, 3)
        texts = {}
        for name, m in (("spec", model), ("plain", pmodel)):
            sync()
            w0 = time.perf_counter()
            texts[name] = [m.transcribe(c, final_chunk=i == 2) for i, c in enumerate(chunks)]
            sync()
            texts[name + "_ms"] = (time.perf_counter() - w0) * 1e3
            if m.longform.buf.size:
                raise AssertionError(f"{name}: buffer not drained")
        if not all(isinstance(x, str) for x in texts["spec"]):
            raise AssertionError("the speculative model's transcripts are not strings")
        caps = model.engine.graph_captures - caps0
        if cuda and caps:
            raise AssertionError(f"the fixed-K speculative model captured {caps} CUDA graphs after warmup()")
    rec["speculative"] = dict(f32=f32_out, auto_ks=ks, selfdraft=selfdraft, modes=modes, bf16_equal=equal_bf16,
                              launches=launches, walls=walls, public=dict(write_s=write_s, ckpt_bytes=nb,
                              ms=(texts["spec_ms"], texts["plain_ms"]), equal=texts["spec"] == texts["plain"],
                              captures_after_warmup=caps))
    log(f"  public entry: monolingual.Definition(draft_local_dir=...) over two BF16 checkpoints "
        f"({nb / 2**30:.2f} GiB, written in {write_s:.1f} s; target {tcfg5.encoder_layers}/{tcfg5.decoder_layers} "
        f"layers, draft {dcfg5.encoder_layers}/{dcfg5.decoder_layers}), int8 decoder + int4 head: warmup ran the "
        f"fallback, {caps} graphs captured after it; {seconds:.0f} s in 3 chunks {texts['spec_ms']:.1f} ms (plain {texts['plain_ms']:.1f} ms), "
        f"transcripts equal to the plain model's: {texts['spec'] == texts['plain']} (bf16: printed, not gated)")


# --------------------------------------------------------------------------
# Phases 15-17: the microphone path, the accuracy tool, the serving soak.
# --------------------------------------------------------------------------


def kernel_counters():
    """The wrappers whose ``launches`` counters the paths read, by kernel."""
    from norma_tpu_torch.ops import launch_counters

    return launch_counters()


def build_alsa_stub() -> str:
    """Compile the stub libasound (``tests/stub_alsa/stub_asound.c``: one
    capture device "stubmic", S16/S32/FLOAT, 1-2 channels, 16-48 kHz, a
    440 Hz sine paced to real time) into the port's build directory."""
    from norma_tpu_torch.audio.native import BUILD_DIR

    os.makedirs(BUILD_DIR, exist_ok=True)
    out = os.path.join(BUILD_DIR, "libasound_stub.so")
    src = os.path.join(ROOT, "tests", "stub_alsa", "stub_asound.c")
    subprocess.run(["gcc", "-O2", "-shared", "-fPIC", "-o", out, src, "-lm"], check=True, capture_output=True,
                   timeout=60)
    return out


def phase_microphone(rec, dev, ckpt_dir=None, stream_s=33.0, short_s=3.0, dtype=None):
    """The README's Quick start with the microphone: the port's native ALSA
    runtime (built with g++ from its copy of norma_audio.cpp) over the stub
    libasound (``NTA_ALSA_LIB``, set before the native library first
    loads), on phase 13's distil-large-v3 checkpoint with the serving
    knobs.  A CPU rehearsal passes the fixture checkpoint's directory,
    short streams and torch.float32; it checks everything but the launch
    counts (the plain versions launch nothing)."""
    import contextlib
    import tempfile
    import threading

    import torch

    from norma_tpu_torch import Transcriber
    from norma_tpu_torch.audio import native
    from norma_tpu_torch.audio.native import alsa
    from norma_tpu_torch.errors import SelectedDeviceNotFound
    from norma_tpu_torch.input import OnError, Settings
    from norma_tpu_torch.models import SelectedDevice
    from norma_tpu_torch.models.whisper import monolingual

    cuda = torch.device(dev).type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    device = SelectedDevice.cuda() if cuda else SelectedDevice.cpu()
    dtype = dtype or torch.bfloat16
    counters = kernel_counters()

    t0 = time.perf_counter()
    stub = build_alsa_stub()
    if native._tried:
        raise AssertionError("the native audio library loaded before NTA_ALSA_LIB was set")
    os.environ["NTA_ALSA_LIB"] = stub
    lib = native.load()
    build_s = time.perf_counter() - t0
    if lib is None or not lib.nta_alsa_available():
        raise AssertionError("the native audio library or the stub libasound did not load")
    devices = alsa.list_devices(lib)
    configs = alsa.query_configs(lib, "stubmic")
    got = sorted((c.sample_format, c.min_sample_rate, c.max_sample_rate, c.channels) for c in configs)
    want = sorted((f, 16000, 48000, ch) for f in ("i16", "i32", "f32") for ch in (1, 2))
    if "stubmic" not in devices or got != want:
        raise AssertionError(f"not the stub's device and ranges: devices {devices}, configs {got}")

    opened = []  # (device, rate, channels, format code) of every capture the native side opened
    start_fmt = lib.nta_alsa_start_fmt
    lib.nta_alsa_start_fmt = lambda name, rate, ch, fmt, *a: (opened.append((name.decode(), rate, ch, fmt)),
                                                             start_fmt(name, rate, ch, fmt, *a))[1]
    tmp = tempfile.TemporaryDirectory(prefix="norma_v3_ckpt_") if ckpt_dir is None else contextlib.nullcontext(ckpt_dir)
    try:
        with tmp as d:
            if ckpt_dir is None:
                write_v3_checkpoint(d, dev)  # phase 13's checkpoint: the same writer and seed
            defn = monolingual.Definition(
                monolingual.ModelType.DISTIL_LARGE_EN_V3, device, local_dir=d, dtype=dtype,
                quantize_decoder=True, quantize_logits="int4", quantize_encoder=True, quantize_cross_kv=True,
                config_overrides={"encoder_attn_impl": "jax_flash", "cross_kv_impl": "kernel",
                                  "self_kv_impl": "kernel"},
            )
            models = []
            build = defn.blocking_try_to_model
            defn.blocking_try_to_model = lambda: models.append(build()) or models[-1]
            t0 = time.perf_counter()
            jh, th = Transcriber.blocking_spawn(defn)
            load_s = time.perf_counter() - t0
            model = models[0]
            engine = model.engine
            model.warmup()  # first-use costs (kernel build, allocator) outside the measured stream
            windows, calls, rings = [], [], []
            inner_window, inner_transcribe = engine.transcribe_window, model.transcribe
            open_stream = Transcriber._open_stream

            def timed_window(audio, langs, seed, n_active=None):
                sync()
                w0 = time.perf_counter()
                out = inner_window(audio, langs, seed, n_active)
                sync()
                windows.append((time.perf_counter() - w0) * 1e3)
                return out

            def counted_transcribe(data, final_chunk):
                text = inner_transcribe(data, final_chunk)
                calls.append((len(data), bool(final_chunk), time.perf_counter(), text))
                return text

            def keep_ring(self, settings):
                pipeline, ring = open_stream(self, settings)
                rings.append(ring)
                return pipeline, ring

            def stream(settings, seconds):
                """One stream: (strings, wall s from start() to stop(), calls)."""
                calls.clear()
                texts = []
                w0 = time.perf_counter()
                rx = th.blocking_start(settings)
                reader = threading.Thread(target=lambda: texts.extend(rx), daemon=True)
                reader.start()
                time.sleep(seconds)
                wall = time.perf_counter() - w0
                th.stop()
                reader.join(timeout=120)
                if reader.is_alive():
                    raise AssertionError("the string stream never ended after stop()")
                finals = [i for i, c in enumerate(calls) if c[1]]
                if finals != [len(calls) - 1]:
                    raise AssertionError(f"final chunks at calls {finals} of {len(calls)}: expected exactly the last")
                return texts, wall, list(calls), w0

            engine.transcribe_window, model.transcribe = timed_window, counted_transcribe
            Transcriber._open_stream = keep_ring
            try:
                windows.clear()
                # ---- the main path: counts from zero ----
                for c in counters.values():
                    c.launches = 0
                if cuda:
                    torch.cuda.reset_peak_memory_stats(dev)
                texts, wall_s, main_calls, w0 = stream(Settings(), stream_s)
                sync()
                launches = {k: c.launches for k, c in counters.items()}
                peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
                # ---- end of the main path ----
                main_windows = list(windows)
                main_ring = rings[-1]
                # The selected device, then an absent one under both policies.
                sel_texts, _, sel_calls, _ = stream(Settings(selected_device="stubmic"), short_s)
                dflt_texts, _, dflt_calls, _ = stream(
                    Settings(selected_device="no-such-mic", on_error=OnError.TRY_DEFAULT), short_s)
                n_open = len(opened)
                try:
                    th.blocking_start(Settings(selected_device="no-such-mic", on_error=OnError.ERROR))
                    raise AssertionError("an absent device under OnError.ERROR opened a stream")
                except SelectedDeviceNotFound:
                    pass
                if len(opened) != n_open:
                    raise AssertionError("OnError.ERROR opened a capture before raising")
                th.close()
                jh.join(timeout=60)  # raises the run loop's error, if any
            finally:
                Transcriber._open_stream = open_stream
                engine.transcribe_window, model.transcribe = inner_window, inner_transcribe
    finally:
        lib.nta_alsa_start_fmt = start_fmt

    fed = sum(c[0] for c in main_calls)
    ratio = fed / (wall_s * 16000)
    if not 0.95 <= ratio <= 1.05:
        raise AssertionError(f"captured {fed} samples in {wall_s:.2f} s: {ratio:.3f} x real time")
    if main_ring.dropped:
        raise AssertionError(f"the native ring dropped {main_ring.dropped} chunks")
    if not main_windows:
        raise AssertionError("no window was decoded during the microphone stream")
    # f32 model at 16 kHz: the ranked open is FLOAT at the model rate, mono
    # (cmp_mic_config: rate support > matching format > mono).
    f32 = 3  # wrappers.FMT_CODES["f32"]
    if opened != [("default", 16000, 1, f32), ("stubmic", 16000, 1, f32), ("default", 16000, 1, f32)]:
        raise AssertionError(f"unexpected captures opened: {opened}")
    if not (sum(c[0] for c in sel_calls) and sum(c[0] for c in dflt_calls)):
        raise AssertionError("the selected-device or the default stream captured nothing")
    missing = [k for k, v in launches.items() if v <= 0]
    if cuda and missing:
        raise AssertionError(f"kernels not launched during the microphone stream: {missing}")
    # Capture-to-text delay of the first partial: from the capture time of
    # the last sample of the chunk that produced the first text (stream
    # start + samples so far / 16 kHz) to the moment that text was returned.
    delay_s, cum = None, 0
    for n, _, t_out, text in main_calls:
        cum += n
        if text:
            delay_s = t_out - (w0 + cum / 16000)
            break
    smi = smi_line() if cuda else "cpu"
    rec["microphone"] = dict(build_s=build_s, load_s=load_s, wall_s=wall_s, fed=fed, ratio=ratio,
                             windows_ms=main_windows, first_partial_delay_s=delay_s, peak_bytes=peak,
                             launches=launches, opened=opened, strings=len(texts))
    log(f"phase 15 microphone: ok native audio + stub libasound built in {build_s:.1f} s; devices {devices}, "
        f"stubmic configs {len(configs)} (i16/i32/f32 x 1-2 ch, 16-48 kHz); Definition + Transcriber.blocking_spawn "
        f"{load_s:.1f} s; blocking_start(Settings()) opened {opened[0]} and captured {fed} samples in {wall_s:.2f} s "
        f"({ratio:.4f} x real time), ring dropped 0, {len(main_calls)} chunks, one final; windows wall_ms="
        f"{[round(w, 1) for w in main_windows]}; {len(texts)} strings; first partial "
        f"{'none' if delay_s is None else format(delay_s, '.3f') + ' s'} after its audio was captured; "
        f"peak_mem={peak / 2**30:.2f} GiB; launches={launches}; Settings(selected_device='stubmic') "
        f"{sum(c[0] for c in sel_calls)} samples, {len(sel_texts)} strings; absent device: TRY_DEFAULT opened the "
        f"default ({sum(c[0] for c in dflt_calls)} samples, {len(dflt_texts)} strings), ERROR raised "
        f"SelectedDeviceNotFound; {smi}")


def _fit_digest(afr, args, seed, dev):
    """(sha256 of the fitted f32 weights, loss at step 100, last loss) of
    the flip-rate tool's fit for ``seed`` at ``args``' widths."""
    import hashlib

    from norma_tpu_torch.model import params_to_numpy

    cfg = afr.make_config(args.dim, args.layers, args.mtp)
    p, losses = afr.fit_seed(cfg, seed, dev, args.train_steps, log=lambda *_: None)
    h = hashlib.sha256()

    def walk(tree):
        for v in tree.values():
            walk(v) if isinstance(v, dict) else h.update(v.tobytes())

    walk(params_to_numpy(p))
    return h.hexdigest()[:16], losses[min(100, len(losses) - 1)], losses[-1]


def _accuracy_kernels(afr, args, dev):
    """Each kernel the flip-rate tool's tiers launch, held to its plain
    version at the tool's shapes (d, H, Ta = max_source_positions, V), at
    the tolerances of phases 2, 6, 8 and 11: w8 on the decoder's products
    and the head at the rows of a step (1), the prompt's prefill (3) and a
    ladder (6) (rel 1e-5); q8a8 at one window's M = Ta (bit-equal);
    cross_decode over int8 and int4 codes at the rungs 1 and 6 with the
    path's bf16 q (4e-3); sample_step at the tool's V and specials (greedy
    exact, probabilities rtol 1e-5).  Returns the worst error of each."""
    import torch

    from norma_tpu_torch.decode.masks import SpecialTokens, build_masks
    from norma_tpu_torch.ops import paged_cross as pc
    from norma_tpu_torch.ops import quant_matmul as qm
    from norma_tpu_torch.ops import sample_step as ss

    cfg = afr.make_config(args.dim, args.layers, args.mtp)
    D, H, Ta, V, L = cfg.d_model, cfg.decoder_attention_heads, cfg.max_source_positions, cfg.vocab_size, \
        cfg.decoder_layers
    g = torch.Generator(device=dev).manual_seed(16)
    errs = dict(w8_matmul=0.0, q8a8=0.0, cross_decode=0.0, sample_step=0.0)
    for K, N in ((D, 3 * D), (D, D), (D, 4 * D), (4 * D, D), (D, V)):
        q, sc = qm.quantize_per_channel(torch.randn((K, N), generator=g, device=dev) * K**-0.5)
        q = qm.pitched_codes(q)
        for rows in (1, 3, 6):
            for dtype in (torch.bfloat16, torch.float32):
                x = torch.randn((rows, K), generator=g, device=dev).to(dtype)
                ko, po = qm.w8_dense(x, q, sc), qm.w8_dense_torch(x, q, sc)
                err, rel = _rel_err(ko, po)
                if ko.shape != (rows, N) or not torch.isfinite(ko).all() or not rel <= 1e-5:
                    raise AssertionError(f"w8 at the tool's K={K} N={N} rows={rows} {dtype}: err {err} "
                                         f"({rel:.3g} of max|y|)")
                errs["w8_matmul"] = max(errs["w8_matmul"], err)
    for K, N in ((D, 3 * D), (D, D), (D, 4 * D), (4 * D, D)):
        wq = qm.kmajor_codes(torch.randint(-127, 128, (K, N), device=dev, dtype=torch.int8, generator=g))
        ws, b = torch.rand((N,), device=dev, generator=g) * 0.02, torch.randn((N,), device=dev, generator=g)
        xq = torch.randint(-127, 128, (Ta, K), device=dev, dtype=torch.int8, generator=g)
        xs, ones_m, ones_n = torch.rand((Ta, 1), device=dev, generator=g) * 0.02, torch.ones((Ta, 1), device=dev), \
            torch.ones((N,), device=dev)
        if not torch.equal(qm.q8a8_dense(xq, ones_m, wq, ones_n), qm.q8a8_dense_torch(xq, ones_m, wq, ones_n)):
            raise AssertionError(f"q8a8 at the tool's M={Ta} K={K} N={N}: int32 accumulation differs")
        for out_dtype in (torch.float32, torch.bfloat16):
            ko = qm.q8a8_dense(xq, xs, wq, ws, b, out_dtype=out_dtype)
            po = qm.q8a8_dense_torch(xq, xs, wq, ws, b, out_dtype=out_dtype)
            if ko.dtype != out_dtype or not torch.equal(ko, po):
                raise AssertionError(f"q8a8 at the tool's M={Ta} K={K} N={N} {out_dtype}: epilogue err "
                                     f"{float((ko.float() - po.float()).abs().max())}")
    for int4 in (False, True):
        limit = 7.0 if int4 else 127.0
        xk, xv = (torch.randn((L, 1, Ta, D), generator=g, device=dev) for _ in range(2))
        kp, vp = (pc.prep_cross_kv_kernel4 if int4 else pc.prep_cross_kv_kernel)(
            _quant_xkv(xk, limit), _quant_xkv(xv, limit), H)
        for G in (1, 6):
            q = torch.randn((G, 1, D), generator=g, device=dev).to(torch.bfloat16)
            for li in range(L):
                ko = pc.cross_attention_q8_kernel_stacked(q, kp, vp, li, H, G)
                po = pc.cross_attention_decode_torch(q, kp, vp, li, H, G)
                err = float((ko.float() - po.float()).abs().max())
                if ko.dtype != q.dtype or ko.shape != po.shape or not err <= 4e-3:
                    raise AssertionError(f"cross_decode at the tool's Ta={Ta} D={D} H={H} int4={int4} G={G} "
                                         f"layer {li}: err {err}")
                errs["cross_decode"] = max(errs["cross_decode"], err)
    st = SpecialTokens(**afr.SPECIALS)
    m = build_masks(V, cfg.suppress_tokens, st)
    masks = tuple(torch.from_numpy(a).to(dev) for a in (m.suppress, m.non_timestamps, m.timestamps, m.first_token))
    for p1, p2, lts, step in ((st.task, st.sot, 0, 0), (st.zero_sec, st.task, st.zero_sec, 1),
                              (100, st.zero_sec, st.zero_sec, 2), (st.zero_sec + 3, 100, st.zero_sec + 3, 3)):
        for B in (1, 6):
            i32 = lambda v: torch.full((B,), v, dtype=torch.int32, device=dev)
            a = (torch.randn((B, V), generator=g, device=dev) * 2.0, *masks, i32(p1), i32(p2), i32(lts), step,
                 torch.zeros(B, device=dev))
            kn, kp_, kd = ss.sample_step(*a, eot=st.eot, no_timestamps=st.no_timestamps)
            pn, pp, pd = ss.sample_step_torch(*a, eot=st.eot, no_timestamps=st.no_timestamps, greedy_only=True)
            if not (torch.equal(kn, pn) and torch.equal(kd, pd)):
                raise AssertionError(f"sample_step at the tool's V={V}, B={B}, step {step}: greedy mismatch")
            torch.testing.assert_close(kp_, pp, rtol=1e-5, atol=0.0)
            errs["sample_step"] = max(errs["sample_step"], float((kp_ - pp).abs().max()))
    torch.cuda.synchronize()
    return errs


def phase_accuracy(rec, dev, argv=None, min_gap=3.0):
    """The port's flip-rate tool on the card at its default widths (d 512,
    4 encoder and 2 decoder layers, 80 mels, V = 51865, 6 s windows, mtp 48,
    350 Adam steps), both regimes and every tier, 2 seeds (cut from 3 for
    time); then each kernel the tiers launched, held to its plain version
    at the tool's shapes.  Gate: the trained regime's median top-2 logit
    gap is at least ``min_gap`` over the whole vocabulary and among the ids
    the first-token mask allows (the margin of the first decision), and
    every tier decodes all but at most one of its trained windows exactly.
    A CPU rehearsal passes ``argv`` with ``--cpu`` and small widths."""
    import torch

    from norma_tpu_torch.tools import accuracy_flip_rate as afr

    cuda = torch.device(dev).type == "cuda"
    args = afr.parse_args(argv if argv is not None else ["--seeds", "2"])
    counters = {k: c for k, c in kernel_counters().items() if k in ("w8_matmul", "q8a8", "cross_decode",
                                                                     "sample_step")}
    for c in counters.values():
        c.launches = 0
    t0 = time.perf_counter()
    out = afr.run(args, log=log)
    wall_s = time.perf_counter() - t0
    launches = {k: c.launches for k, c in counters.items()}
    trained = [r for r in out["rows"] if r["regime"] == "trained"]
    gap, first_gap = out["median_top2_gap"].get("trained"), out["median_first_token_gap"].get("trained")
    errs = _accuracy_kernels(afr, args, dev) if cuda else None
    repro = None
    if cuda and args.train_steps:
        # The fit must not depend on what the process ran before (with the
        # default, nondeterministic kernels the trained weights, hence the
        # tables, changed with the card's memory state): seed 1's fit again
        # with 30 GB of the card held gives the same weights, bit for bit.
        hog = torch.empty(30 * 2**30, dtype=torch.uint8, device=dev)
        again = _fit_digest(afr, args, 1, dev)
        del hog
        repro = (_fit_digest(afr, args, 1, dev), again)
        log(f"  fit reproducibility, seed 1: sha256 {repro[0][0]} (losses at steps 100 / last "
            f"{repro[0][1]:.6f} / {repro[0][2]:.6f}), again with 30 GB held {repro[1][0]} "
            f"({repro[1][1]:.6f} / {repro[1][2]:.6f})")
    for m in out["misses"]:
        if m["regime"] == "trained":
            log(f"  trained flip: tier {m['tier']} seed {m['seed']} {m['audio']}: first differing position "
                f"{m['first_diff']} (ref {m['ref_len']} tokens, tier {m['got_len']}; the window's top-2 gap among "
                f"the first token's allowed ids {m['first_token_gap']})")
    rec["accuracy"] = dict(wall_s=wall_s, launches=launches, gaps=out["median_top2_gap"], rows=out["rows"],
                           first_token_gaps=out["median_first_token_gap"], repro=repro, kernel_errs=errs)
    tiers = sorted(r["tier"] for r in trained)
    log(f"phase 16 accuracy: {out['config']}; median top-2 gap {out['median_top2_gap']} (among the first "
        f"token's allowed ids {out['median_first_token_gap']}); tiers {tiers}; "
        f"launches={launches}; kernels against their plain versions at the tool's shapes, max abs err {errs}; "
        f"{wall_s:.1f} s; {smi_line() if cuda else 'cpu'}")
    if repro is not None and repro[0] != repro[1]:
        raise AssertionError("the fit depends on the card's memory state: two fits of seed 1 differ")
    if gap is None or gap < min_gap or first_gap < min_gap:
        raise AssertionError(f"the fit gave no margins: trained median top-2 gap {gap}, {first_gap} among the "
                             f"first token's allowed ids; either < {min_gap}")
    bad = [(r["tier"], r["windows"] - r["exact_windows"]) for r in trained if r["windows"] - r["exact_windows"] > 1]
    if bad:
        raise AssertionError(f"trained tiers with more than one window flipped: {bad}")
    if cuda and ("xkv_int4" not in tiers or any(v <= 0 for v in launches.values())):
        raise AssertionError(f"the tiers did not reach the kernels: tiers {tiers}, launches {launches}")


def phase_soak(rec, dev, argv=None):
    """The port's soak tool: ``--minutes 1 --streams 8`` on the card's
    distil-large-v3 latency model (mtp 136, EOT unreachable, seed 0, bf16,
    fused QKV); it must print ``SOAK PASS``.  A CPU rehearsal passes
    ``argv`` with ``--cpu``."""
    import contextlib
    import io

    import torch

    from norma_tpu_torch.tools import soak_serving

    cuda = torch.device(dev).type == "cuda"
    argv = argv if argv is not None else ["--minutes", "1", "--streams", "8"]
    counters = kernel_counters()
    for c in counters.values():
        c.launches = 0
    buf = io.StringIO()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf):
            summary = soak_serving.main(argv)
    finally:
        sys.stdout.write(buf.getvalue())  # the tool's own lines, also when it fails
    wall_s = time.perf_counter() - t0
    if "SOAK PASS" not in buf.getvalue():
        raise AssertionError("the soak did not print SOAK PASS")
    if summary["graph_captures_after_warmup"]:
        raise AssertionError(f"the soak captured {summary['graph_captures_after_warmup']} CUDA graphs after warmup")
    launches = {k: c.launches for k, c in counters.items()}
    m = summary["metrics"]
    rec["soak"] = dict(wall_s=wall_s, summary=summary, launches=launches)
    log(f"phase 17 soak: ok SOAK PASS ({' '.join(argv)}): {summary['streams']} streams in {summary['waves']} waves, "
        f"{summary['empty']} without output; CUDA graphs captured after warmup "
        f"{summary['graph_captures_after_warmup']}; latency {json.dumps(m['latency'])}; round cost EMA ms by bucket "
        f"{m['round_cost_ema_ms']}; RSS growth {summary['rss_growth_mb']:.1f} MB; drops transcript "
        f"{m['transcript_drops']} audio {m['audio_drops']}; launches={launches}; {wall_s:.1f} s; "
        f"{smi_line() if cuda else 'cpu'}")


# --------------------------------------------------------------------------
# Phase 18: the device report (norma_tpu_torch.tracing) on phase 9's served
# configuration.
# --------------------------------------------------------------------------

# The served kernels (phase 9's counters) and the engine's named regions:
# an eager window's, then a window graph's replay.
SERVED_KERNELS = ("sample_step", "self_decode", "cross_decode", "flash_encoder", "q8a8", "w8_matmul")
REGIONS = ("window_front", "token_loop", "ladder_finish", "window_graph")


def region_ms(trace_dir):
    """Per named region of the trace: (count, device span ms, device-busy
    ms), the span from its ``gpu_user_annotation`` events and the busy time
    of the kernels, copies and fills that fall inside those spans."""
    from norma_tpu_torch import tracing

    spans, busy = {}, []
    for _, ev in tracing.trace_events(trace_dir):
        t0, t1 = float(ev.get("ts", 0.0)), float(ev.get("ts", 0.0)) + float(ev.get("dur", 0.0))
        if ev.get("cat") == "gpu_user_annotation" and ev.get("name") in REGIONS:
            spans.setdefault(ev["name"], []).append((t0, t1))
        elif ev.get("cat") in tracing.BUSY_LINES:
            busy.append((t0, t1))
    busy.sort()
    out = {}
    for name, sp in spans.items():
        inside = sum(max(0.0, min(e, b1) - max(s, b0)) for s, e in sp for b0, b1 in busy if b0 < e and b1 > s)
        out[name] = (len(sp), sum(e - s for s, e in sp) / 1e3, inside / 1e3)
    return out


# The records a graph window's trace may lose of one kernel's launches:
# the trace of kernels inside WHILE bodies has come back short by 2 of 5785
# w8 launches (H100).  A trace holding only each WHILE body's first pass
# falls short by hundreds.
def trace_slack(launches: int) -> int:
    return max(4, launches // 1000)


def device_span_ms(trace_dir):
    """(ms from the first device event's start to the last one's end, kernel
    events) over the traces under ``trace_dir``."""
    from norma_tpu_torch import tracing

    t0, t1, kernels = float("inf"), float("-inf"), 0
    for _, ev in tracing.trace_events(trace_dir):
        if ev.get("cat") in tracing.BUSY_LINES:
            a = float(ev.get("ts", 0.0))
            t0, t1 = min(t0, a), max(t1, a + float(ev.get("dur", 0.0)))
            kernels += ev.get("cat") == "kernel"
    return (t1 - t0) / 1e3, kernels


def phase_device_report(rec, dev):
    """One eager and one graph B=8 window of phase 9's served engine through
    the package's measurement path (tracing.profiled_device_ms, traces
    under build/traces/report_*).  Per served kernel, the report's kernel
    events against the wrapper's launch counter over the same window: equal
    for the eager window; for the graph window (one CUDA graph, its token
    loops WHILE nodes, its counters scaled by the passes the device
    counted) at most the counter and short of it by no more than
    :func:`trace_slack`, the window taken again (three times at most) when
    it falls outside.  The graph window's counters must equal the eager
    window's.  Device-busy ms <= wall ms.  Named regions on the device
    timeline: the eager window's three, the graph window's replay
    (``window_graph``).  The idle time splits into the host's ends (wall -
    the device span from the first device event to the last) and the gaps
    between device events inside the span."""
    import torch

    from norma_tpu_torch import tracing

    if "serving_window" not in rec:
        raise RuntimeError("device_report needs the serving phase: it profiles phase 9's served engine")
    from norma_tpu_torch.ops.loop_cond import loop_cond

    engine, rows_t, langs = rec.pop("serving_window")
    counters = dict(kernel_counters(), loop_cond=loop_cond)
    res = {}
    for mode in ("eager", "graph"):
        run = engine.transcribe_window_eager if mode == "eager" else engine.transcribe_window
        tries = []
        for _ in range(3):
            walls, counts = [], {}

            def window():
                for c in counters.values():
                    c.launches = 0
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                run(rows_t, langs, seed=1)
                torch.cuda.synchronize()
                walls.append((time.perf_counter() - t0) * 1e3)
                counts.update({k: c.launches for k, c in counters.items()})

            d = os.path.join(TRACES, f"report_{mode}")
            busy, top = tracing.profiled_device_ms(window, 1, d, ops=12)
            rep = tracing.device_time_report(d)
            seen = {k: sum(c for name, (_, c) in rep.items() if KERNEL_FUNCS[k][0] in name) for k in SERVED_KERNELS}
            if mode == "eager":
                off = {k: (seen[k], counts[k]) for k in SERVED_KERNELS if seen[k] != counts[k] or counts[k] <= 0}
            else:
                off = {k: (seen[k], counts[k]) for k in SERVED_KERNELS
                       if counts[k] <= 0 or not counts[k] - trace_slack(counts[k]) <= seen[k] <= counts[k]}
            tries.append(off)
            if not off or mode == "eager":
                break
        if off:
            raise AssertionError(f"{mode} window: report launches against wrapper counters (report, counter) in "
                                 f"each of {len(tries)} sessions: {tries}")
        span, kernels = device_span_ms(d)
        gaps = span - tracing.busy_union_ms(d)
        untraced = []
        for _ in range(2 if mode == "graph" else 0):  # the same window without the tracer
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run(rows_t, langs, seed=1)
            torch.cuda.synchronize()
            untraced.append((time.perf_counter() - t0) * 1e3)
        res[mode] = dict(wall_ms=walls[-1], busy_ms=busy, idle=1.0 - busy / walls[-1], counters=counts, seen=seen,
                         top=top, regions=region_ms(d), sessions=tracing.last_profile["sessions"],
                         lost=list(tracing.last_profile["lost"]), kernels=sum(c for _, c in rep.values()),
                         launch_to_start_us=tracing.last_session["launch_to_start_us"], attempts=len(tries),
                         short=[{k: v[1] - v[0] for k, v in t.items()} for t in tries[:-1]],
                         span_ms=span, ends_ms=walls[-1] - span, gaps_ms=gaps, gap_us_per_kernel=gaps * 1e3 / kernels,
                         untraced_ms=untraced)
        if busy > walls[-1]:
            raise AssertionError(f"{mode} window: device busy {busy:.1f} ms > wall {walls[-1]:.1f} ms")
        want = REGIONS[:3] if mode == "eager" else REGIONS[3:]
        missing = set(want) - set(res[mode]["regions"])
        if missing:
            raise AssertionError(f"{mode} window: regions {sorted(missing)} not on the device timeline")
    # The WHILE nodes' stop test, device-only in the graph window (its
    # launches: one a WHILE node and one a pass).
    cond = [(c, t) for k, (t, c) in tracing.device_time_report(os.path.join(TRACES, "report_graph")).items()
            if KERNEL_FUNCS["loop_cond"][0] in k and t > 0]
    if cond:
        n = sum(c for c, _ in cond)
        rec.setdefault("profile", {})["loop_cond"] = dict(
            launches=n, ms_per_launch=sum(t for _, t in cond) / n, ms_total=sum(t for _, t in cond),
            tries=res["graph"]["sessions"], missed=res["graph"]["lost"], counted=res["graph"]["counters"].get("loop_cond"))
    served = lambda c: {k: v for k, v in c.items() if k in SERVED_KERNELS}  # noqa: E731
    if served(res["graph"]["counters"]) != served(res["eager"]["counters"]):
        raise AssertionError(f"graph window counters {served(res['graph']['counters'])} != eager "
                             f"{served(res['eager']['counters'])}")
    rec["device_report"] = res
    smi = smi_line()
    for mode, r in res.items():
        lost = "" if r["sessions"] == 1 else f" (device events in the lost ones: {r['lost']})"
        retaken = "" if r["attempts"] == 1 else f"; windows taken again after traces short by {r['short']}"
        bare = (f"; untraced wall {[round(x, 1) for x in r['untraced_ms']]} ms (idle "
                f"{1.0 - r['busy_ms'] / min(r['untraced_ms']):.1%} against the traced busy)" if r["untraced_ms"] else "")
        log(f"phase 18 device report, {mode} B=8 window: wall {r['wall_ms']:.1f} ms, device busy {r['busy_ms']:.1f} ms "
            f"(idle {r['idle']:.1%}: host ends {r['ends_ms']:.1f} ms outside the device span of {r['span_ms']:.1f} "
            f"ms, gaps between device events {r['gaps_ms']:.1f} ms inside it, {r['gap_us_per_kernel']:.2f} us a "
            f"kernel){bare}, {r['kernels']} kernel events, {r['sessions']} profiler session(s){lost}{retaken}, least "
            f"launch-to-start {r['launch_to_start_us']:.1f} us; launches (report, counters) {r['seen']}, "
            f"{served(r['counters'])}; regions (count, device span ms, busy ms) "
            + "; ".join(f"{k} {v[0]} x {v[1]:.1f} / {v[2]:.1f}" for k, v in r["regions"].items()) + f"; {smi}")
        log(f"  top 12 kernels ({mode}, ms per window, launches): " + "; ".join(
            f"{row['op'][:60]} {row['ms_per_call']:.3f} x {row['n']}" for row in r["top"]))
    lc_prof = rec.get("profile", {}).get("loop_cond")
    log("  loop_cond in the graph B=8 window: " + (
        f"{lc_prof['ms_per_launch']:.4f} device ms per launch over {lc_prof['launches']} traced launches "
        f"({lc_prof['counted']} counted), {lc_prof['ms_total']:.2f} ms in all" if lc_prof else "not measured"))
    log(f"phase 18 device report: ok; the graph window's counters equal the eager window's, and its trace holds "
        f"them within {{n: max(4, n // 1000)}} records (eager = counters {res['eager']['seen']}; graph trace "
        f"{res['graph']['seen']}); {smi}")


# --------------------------------------------------------------------------
# Phase 19: data parallelism -- replica engines over a mesh's dp axis.
# --------------------------------------------------------------------------

SERVED_COUNTERS = ("sample_step", "self_attention_decode", "cross_attention_q8_kernel_stacked",
                   "flash_self_attention", "q8a8_dense", "w8_matmul")


def _same_result(a, b) -> bool:
    """Two DecodingResults bit for bit (tokens, and both floats' bits), or
    both None."""
    import numpy as np

    if a is None or b is None:
        return a is None and b is None
    bits = lambda x: np.float64(x).tobytes()
    return (a.tokens == b.tokens and bits(a.avg_logprob) == bits(b.avg_logprob)
            and bits(a.no_speech_prob) == bits(b.no_speech_prob))


def mesh_replica_check(mesh, params, cfg, st, lang_ids, rows, n_active, single):
    """The serving config's padded window over ``mesh``'s replicas: each
    replica's rows bit for bit against ``single`` (a one-device engine) on
    the same rows and active count; then each replica alone, its counters
    from 0, must move the six serving kernels' counters (on the card: the
    CPU's plain versions launch nothing; a replica in worker processes
    counts in its workers).  Returns (per-replica launches, dp engine) --
    the caller closes the engine."""
    import torch

    from norma_tpu_torch.decode import DecodeEngine
    from norma_tpu_torch.parallel import shard_params

    from norma_tpu_torch.ops import flash_encoder, paged_cross, quant_matmul, sample_step, self_decode

    counters = (sample_step.sample_step, self_decode.self_attention_decode,
                paged_cross.cross_attention_q8_kernel_stacked, flash_encoder.flash_self_attention,
                quant_matmul.q8a8_dense, quant_matmul.w8_matmul)
    dp_eng = DecodeEngine(shard_params(params, mesh), cfg, st, language_token_ids=lang_ids, quantize_cross_kv=True)
    dp = mesh.shape["dp"]
    B = len(rows)
    b = B // dp
    langs = [lang_ids[0]] * B
    got, _ = dp_eng.transcribe_window(rows, langs, seed=1, n_active=n_active)
    for i in range(dp):
        na = min(max(n_active - i * b, 0), b)
        want, _ = single.transcribe_window(rows[i * b:(i + 1) * b], langs[:b], seed=1, n_active=na)
        bad = [k for k, (w, g) in enumerate(zip(want, got[i * b:(i + 1) * b])) if not _same_result(w, g)]
        if bad:
            w, g = want[bad[0]], got[i * b + bad[0]]
            raise AssertionError(
                f"replica {i} ({mesh.devices[i, 0]}): rows {bad} differ from the one-device engine's; row {bad[0]}: "
                f"{None if w is None else (w.tokens[:12], w.avg_logprob)} vs {None if g is None else (g.tokens[:12], g.avg_logprob)}")
    sync = torch.cuda.synchronize if dp_eng.device.type == "cuda" else (lambda: None)
    launches = []
    for i, rep in enumerate(dp_eng.replicas):
        sync()
        for c in counters:
            c.launches = 0
        if rep.remote:
            rep.engine.launches(reset=True)
        rep.submit(rep.engine.transcribe_window, rows[i * b:(i + 1) * b], langs[:b], 1, b).result()
        sync()
        counts = {c.__name__: c.launches for c in counters}
        if rep.remote:
            counts = worker_launches(rep.engine.launches(), counters)
        if rep.device.type == "cuda" and any(v <= 0 for v in counts.values()):
            raise AssertionError(f"replica {i} alone did not launch every serving kernel: {counts}")
        launches.append(counts)
    return launches, dp_eng


def worker_launches(ranks, counters):
    """Worker ranks' launch counters (``WorkerEngine.launches``) summed, by
    the names of ``counters`` (the parent's wrappers)."""
    from norma_tpu_torch.ops import launch_counters

    names = {k: c.__name__ for k, c in launch_counters().items()}
    want = {c.__name__ for c in counters}
    out = dict.fromkeys(sorted(want), 0)
    for rank in ranks:
        for k, n in rank.items():
            if names[k] in want:
                out[names[k]] += n
    return out


def wait_gil_probe(wait_ms: float = 200.0):
    """How far a second Python thread gets while this one waits for the card
    in each way a host read can wait: {way: (iterations a ms of the wait,
    wait ms)}.  Data-parallel replicas each wait in their own thread, so a
    wait that holds the interpreter lock runs them one after another.  The
    card spins ``wait_ms`` (``torch.cuda._sleep``) before each read."""
    import threading
    import types

    import torch

    from norma_tpu_torch.decode import DecodeEngine

    dev = torch.device("cuda", 0)
    cycles = int(wait_ms * 1e-3 * torch.cuda.get_device_properties(dev).clock_rate * 1e3)
    stream = torch.cuda.current_stream(dev)
    torch.cuda._sleep(1000)  # the spin kernel's first launch loads it

    def poll(t):
        ev = torch.cuda.Event()
        ev.record()
        while not ev.query():
            time.sleep(0)
        return t.cpu()

    ways = {
        "t.cpu()": lambda t: t.cpu(),
        "bool(t)": lambda t: bool(t),
        "t.item()": lambda t: t.item(),
        "pinned + stream.synchronize()": lambda t: (t.to("cpu", non_blocking=True), stream.synchronize()),
        "event.synchronize()": _event_sync,
        "event.query() poll": poll,
        "DecodeEngine._host": lambda t: DecodeEngine._host(types.SimpleNamespace(host_syncs=0), t),
    }
    out = {}
    for name, read in ways.items():
        torch.cuda.synchronize()
        stop, count = threading.Event(), [0]

        def spin():
            while not stop.is_set():
                count[0] += 1

        th = threading.Thread(target=spin)
        th.start()
        time.sleep(0.02)
        torch.cuda._sleep(cycles)
        t = torch.ones((), device=dev) > 0
        c0, w0 = count[0], time.perf_counter()
        read(t)
        ms = (time.perf_counter() - w0) * 1e3
        c1 = count[0]
        stop.set()
        th.join()
        out[name] = ((c1 - c0) / ms, ms)
    return out


def _event_sync(t):
    import torch

    ev = torch.cuda.Event()
    ev.record()
    ev.synchronize()
    return t


def mesh_device_guard_check():
    """With cuda:0 current, the sampling kernel on every other card's
    tensors (the wrapper must enter that card: its launch, its stream and
    its function attributes are that card's) against its plain version on
    the host, greedy rows bit for bit; returns the cards checked."""
    import numpy as np
    import torch

    from norma_tpu_torch.ops.sample_step import sample_step, sample_step_torch

    rng = np.random.default_rng(19)
    B = 8
    ll = torch.from_numpy(rng.standard_normal((B, V3)).astype(np.float32) * 4)
    ints = lambda lo, hi: torch.from_numpy(rng.integers(lo, hi, B).astype(np.int32))
    p1, p2, lts = ints(0, V3), ints(0, V3), torch.zeros(B, dtype=torch.int32)
    temp = torch.zeros(B)
    want = sample_step_torch(ll, *_v3_masks("cpu"), p1, p2, lts, 3, temp, eot=ST_V3["eot"],
                             no_timestamps=ST_V3["no_timestamps"])
    checked = []
    torch.cuda.set_device(0)
    for i in range(1, torch.cuda.device_count()):
        d = torch.device("cuda", i)
        on = lambda t: t.to(d)
        got = sample_step(on(ll), *_v3_masks(d), on(p1), on(p2), on(lts), 3, on(temp), eot=ST_V3["eot"],
                          no_timestamps=ST_V3["no_timestamps"], greedy_only=True)
        torch.cuda.synchronize(d)
        if torch.cuda.current_device() != 0:
            raise AssertionError(f"the launch on {d} left cuda:{torch.cuda.current_device()} current")
        if not torch.equal(got[0].cpu(), want[0].to(torch.int32)):
            raise AssertionError(f"sample_step on {d} from cuda:0: {got[0].cpu().tolist()} vs {want[0].tolist()}")
        checked.append(str(d))
    return checked


def phase_mesh(rec, dev, cfg=None, params=None, st=None, lang_ids=None, f32=None, seconds=(20.0, 40.0)):
    """Data parallelism on the card (phase 19); a CPU rehearsal passes a
    tiny serving config, its params, tokens, an f32 (cfg, params) pair and
    shorter streams."""
    import gc

    import numpy as np
    import torch

    from norma_tpu_torch import tracing
    from norma_tpu_torch.decode import DecodeEngine, LanguageState, SpecialTokens
    from norma_tpu_torch.frontend.mel import prepare_audio
    from norma_tpu_torch.model import PRESETS
    from norma_tpu_torch.models.whisper import WhisperModel
    from norma_tpu_torch.parallel import make_mesh, shard_params
    from norma_tpu_torch.parallel.dryrun import dryrun_multichip

    dev = torch.device(dev)
    cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    if cfg is None:
        cfg = PRESETS["distil-large-v3"].with_(
            max_target_positions=448, decode_buckets=(128, 256), encoder_attn_impl="jax_flash",
            cross_kv_impl="kernel", self_kv_impl="kernel",
        )
        st, lang_ids = SpecialTokens(**ST_V3), LANG_IDS_V3
    t0 = time.perf_counter()
    if params is None:
        params = _serving_params(cfg, dev)
    sync()
    make_s = time.perf_counter() - t0
    meshes = [("virtual", make_mesh(dp=2, devices=[dev, dev]))]
    if cuda and torch.cuda.device_count() > 1:
        meshes.append((f"{torch.cuda.device_count()} cards", make_mesh(dp=torch.cuda.device_count())))

    class IdsTokenizer:
        def decode(self, ids, skip_special_tokens=True):
            return " ".join(str(int(i)) for i in ids)

    sr = 16000
    n_win = 2 * cfg.max_source_positions
    n_samp = (n_win - 1) * 160 + 400
    tt = np.arange(n_samp) / sr
    audio = (0.15 * np.sin(2 * np.pi * 440 * tt) + 0.05 * np.random.default_rng(4).standard_normal(n_samp)).astype(np.float32)
    out = {}

    # ---- 1. replicas against a one-device engine, bit for bit ----
    single = DecodeEngine(params, cfg, st, language_token_ids=lang_ids, quantize_cross_kv=True)
    served_mesh = meshes[0][1]
    engines = {}
    for name, mesh in meshes:
        dp = mesh.shape["dp"]
        B = 4 * dp
        rows = np.stack([prepare_audio(np.roll(audio, sr * i), n_win) for i in range(B)])
        n_active = B - 3  # the last replica decodes one row beside three pad rows
        rows[n_active:] = rows[0]
        # Replicas in threads of this process, over the cards too (phase 21
        # runs worker processes beside them).
        launches, dp_eng = mesh_replica_check(mesh, params, cfg, st, lang_ids, rows, n_active, single)
        walls = {}
        if name == "virtual":
            # The same B=8 window, one engine against two replicas on the
            # card, warm, in turns one, dp, dp, one.
            for eng in (single, dp_eng):  # graphs at this batch captured before the timed turns
                eng.transcribe_window(rows, [lang_ids[0]] * B, seed=1, n_active=n_active)
            for who, eng in (("one", single), ("dp", dp_eng), ("dp", dp_eng), ("one", single)):
                sync()
                w0 = time.perf_counter()
                eng.transcribe_window(rows, [lang_ids[0]] * B, seed=1, n_active=n_active)
                sync()
                walls.setdefault(who, []).append((time.perf_counter() - w0) * 1e3)
        elif cuda:
            # Over the cards: one row a card, all replicas at once, then each
            # replica alone in its thread, then one engine on cuda:0 (B=1),
            # warm, in turns.
            one_row = [lang_ids[0]]
            single.transcribe_window(rows[:1], one_row, seed=1)
            dp_eng.transcribe_window(rows[:dp], one_row * dp, seed=1)
            for _ in range(2):
                for who, call in [("one", lambda: single.transcribe_window(rows[:1], one_row, seed=1)),
                                  ("dp", lambda: dp_eng.transcribe_window(rows[:dp], one_row * dp, seed=1))] + [
                        (f"replica {i} alone", lambda r=r: r.submit(r.engine.transcribe_window, rows[:1], one_row,
                                                                     1).result())
                        for i, r in enumerate(dp_eng.replicas)]:
                    sync()
                    w0 = time.perf_counter()
                    call()
                    for d in range(torch.cuda.device_count()):
                        torch.cuda.synchronize(d)
                    walls.setdefault(who, []).append((time.perf_counter() - w0) * 1e3)
        if name == "virtual" and cuda:
            out["one_read"] = one_read_window(dp_eng, rows, [lang_ids[0]] * B, 1, n_active=n_active)[1]
            log(f"  mesh {name}: warm B={B} window over the replicas: {one_read_text(out['one_read'])}")
            walls["idle"] = {who: tracing.idle_share(
                lambda eng=eng: eng.transcribe_window(rows, [lang_ids[0]] * B, seed=1, n_active=n_active),
                os.path.join(TRACES, f"mesh_idle_{who}")) for who, eng in (("one", single), ("dp", dp_eng))}
        out[name] = dict(devices=[str(d) for d in mesh.devices.flat], launches=launches, walls=walls)
        log(f"  mesh {name} {out[name]['devices']}: B={B} window ({n_active} active), each replica's rows equal "
            f"the one-device engine's bit for bit; each replica alone launched {launches}")
        if "one" in walls:
            log(f"  mesh {name}: {'that window' if name == 'virtual' else 'one row a replica'}: walls ms in turns, "
                + ", ".join(f"{who} {[round(x, 1) for x in v]}" for who, v in walls.items() if who != "idle"))
        for who, v in walls.get("idle", {}).items():
            log(f"  mesh {name}: {who} window under torch.profiler: wall {v[0]:.1f} ms, device busy (union) "
                f"{v[1]:.1f} ms of {v[4]:.1f} ms summed device time, idle {v[2]:.1%} ({v[3]} device events)")
        engines[name] = dp_eng
    del single
    gc.collect()

    # ---- 2. the served rounds: on the virtual mesh, and over every card
    # where the 8 streams divide over them ----
    p9 = rec.get("serving", {}).get("round_b8_ms")
    p9_txt = (f"phase 9 (one engine) median {p9['median']:.1f} ms ({p9['min']:.1f}-{p9['max']:.1f}, "
              f"{p9['n']} rounds)" if p9 else "phase 9 not run")
    for name, mesh in meshes:
        eng, dp = engines.pop(name), mesh.shape["dp"]
        if 8 % dp:
            eng.close()
            log(f"  mesh {name}: not served (8 streams do not divide over dp={dp})")
            continue
        model = WhisperModel(eng, IdsTokenizer(), LanguageState(const=lang_ids[0]), language_tokens=lang_ids)
        try:
            rep = serve_streams(model, 8, seconds, mesh=mesh)
        finally:
            eng.close()
        check_served(rep, 8)
        if rep["captures"]:
            raise AssertionError(f"{rep['captures']} CUDA graphs captured during the served dp rounds, after warmup")
        b8 = [r["ms"] for r in rep["rounds"] if r["B"] == 8]
        b8_ms = dict(n=len(b8), median=float(np.median(b8)), min=min(b8), max=max(b8)) if b8 else None
        out["served" if name == "virtual" else f"served {name}"] = dict(
            rounds=len(rep["rounds"]), stream_rounds=rep["stream_rounds"], peak=rep["peak"], launches=rep["launches"],
            warm_s=rep["warm_s"], wall_s=rep["wall_s"], round_b8_ms=b8_ms)
        b8_txt = (f"median {b8_ms['median']:.1f} ms ({b8_ms['min']:.1f}-{b8_ms['max']:.1f}, {b8_ms['n']} rounds)"
                  if b8_ms else "no B=8 round")
        for r in rep["rounds"]:
            log(f"  mesh {name} served round: B={r['B']} n_active={r['n_active']} wall_ms={r['ms']:.1f} "
                f"decode_steps={r['steps']} host_syncs={r['syncs']}")
        log(f"  mesh {name} served: BatchedTranscriber(max_streams=8, mesh=dp{dp} over {name}) warmup "
            f"{rep['warm_s']:.1f} s; 8 streams {seconds[0]:g}-{seconds[1]:g} s at {FEED_SPEED:g}x real time served in "
            f"{rep['wall_s']:.1f} s over {len(rep['rounds'])} rounds: B=8 rounds {b8_txt} beside {p9_txt}; rounds per "
            f"stream {rep['stream_rounds']}; CUDA graphs captured after warmup: {rep['captures']}; no drops; "
            f"peak_mem on {rep['peak_device']}={rep['peak'] / 2**30:.2f} GiB; launches={rep['launches']}")
        del model, eng
    s8 = out["served"]["round_b8_ms"]
    s8_txt = (f"median {s8['median']:.1f} ms ({s8['min']:.1f}-{s8['max']:.1f}, {s8['n']} rounds)" if s8
              else "no B=8 round")
    del params
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    # ---- 3. f32, exact: dp=2 greedy tokens at B=8 against one engine ----
    if f32 is None:
        cfg5 = PRESETS["distil-large-v3"].with_(max_target_positions=448, decode_buckets=(128, 256),
                                                self_kv_impl="kernel")
        f32 = (cfg5, device_params(cfg5, 5, torch.float32, dev))  # drawn on the card: seconds, not minutes
    cfg5, params5 = f32
    rng = np.random.default_rng(0)
    t30 = np.arange(30 * sr) / sr
    a5 = (0.15 * np.sin(2 * np.pi * 440 * t30) + 0.05 * rng.standard_normal(30 * sr)).astype(np.float32)
    batch = np.stack([prepare_audio(a5 * (1.0 + 0.1 * i), 2 * cfg5.max_source_positions) for i in range(8)])
    one5 = DecodeEngine(params5, cfg5, st, language_token_ids=lang_ids)
    want = one5.run_loop(one5.prefill_window(batch, lang_ids[0]), 0.0, 0)
    dp5 = DecodeEngine(shard_params(params5, served_mesh), cfg5, st, language_token_ids=lang_ids)
    try:
        got = dp5.run_loop(dp5.prefill_window(batch, lang_ids[0]), 0.0, 0)
    finally:
        dp5.close()
    differ = [k for k, (w, g) in enumerate(zip(want, got)) if w.tokens != g.tokens]
    if differ:
        k = differ[0]
        w_, g_ = want[k].tokens, got[k].tokens
        i = next((j for j, (x, y) in enumerate(zip(w_, g_)) if x != y), min(len(w_), len(g_)))
        raise AssertionError(f"f32 dp=2 greedy rows {differ} differ from the one-device engine's at B=8; row {k} "
                             f"first at position {i}: {w_[i:i + 3]} vs {g_[i:i + 3]}")
    out["f32"] = dict(rows=len(want), tokens=[len(w.tokens) for w in want])
    log(f"  mesh f32 (phase 5's config, weights drawn on the card): dp=2 greedy tokens equal the one-device "
        f"engine's at B=8 ({out['f32']['tokens']} tokens)")
    del one5, dp5, params5, f32
    gc.collect()

    if len(meshes) > 1:
        out["guard"] = mesh_device_guard_check()
        log(f"  mesh device guard: sample_step on {out['guard']} from cuda:0 equals its plain version")

    # ---- 4. the dry run on the card (virtual devices, and every card) ----
    out["dryrun"] = [dryrun_multichip(2, devices=[dev, dev])]
    if len(meshes) > 1:
        out["dryrun"].append(dryrun_multichip(torch.cuda.device_count()))
    if cuda:
        out["waits"] = waits = wait_gil_probe()
        log("  mesh host waits, another thread's Python iterations a ms while this one waits on the card: "
            + "; ".join(f"{k} {v[0]:.0f} over {v[1]:.1f} ms" for k, v in waits.items()))
        held = [k for k in ("bool(t)", "DecodeEngine._host") if waits[k][0] < 1000]
        if held:
            raise AssertionError(f"the engine's host reads hold the interpreter lock while they wait: {held}")
    rec["mesh"] = out

    log(f"phase 19 mesh: ok; serving params {make_s:.1f} s to make; meshes {[n for n, _ in meshes]}; served dp=2 "
        f"B=8 rounds {s8_txt} beside {p9_txt}; peak_mem={out['served']['peak'] / 2**30:.2f} GiB; f32 tokens equal; "
        f"{len(out['dryrun'])} dry run(s) ok; {smi_line() if cuda else 'cpu'}")


TP4_Q8_SHAPES = ((1280, 960), (320, 1280), (1280, 1280))  # [K, N] of distil-large-v3's w8a8 products at tp=4


def tp_window_check(eng, one, rows, langs, n_active, tol):
    """A padded window on the tp engine ``eng`` beside the one-device engine
    ``one``: the prefill's logits and no-speech probabilities within ``tol``
    (max |diff| of each; a worker engine returns its rank 0's logits), then
    the whole window on both.  Returns a dict of the differences, the tp
    prefill's logits and both engines' results."""
    import numpy as np

    from norma_tpu_torch.parallel.collectives import first

    eng0 = eng.replicas[0].engine if hasattr(eng, "replicas") else eng
    lang = langs[0]
    s1 = one.prefill_window(rows, lang)
    s2 = eng0.prefill_window(rows, lang)
    l1 = s1["next_logits"].float().cpu().numpy()
    l2 = first(s2["next_logits"])
    l2 = l2.float().cpu().numpy() if hasattr(l2, "cpu") else np.asarray(l2, np.float32)
    nsp = float(np.abs(np.asarray(s1["no_speech_prob"]) - np.asarray(s2["no_speech_prob"])).max())
    dl = float(np.abs(l1 - l2).max())
    if not (nsp <= tol["no_speech"] and dl <= tol["logits"]):
        raise AssertionError(f"tp prefill against one engine: max |d logits| {dl}, max |d no_speech| {nsp} "
                             f"(tolerance {tol})")
    got, _ = eng.transcribe_window(rows, langs, seed=1, n_active=n_active)
    want, _ = one.transcribe_window(rows, langs, seed=1, n_active=n_active)
    same = sum(1 for a, b in zip(got, want) if _same_result(a, b))
    return dict(d_logits=dl, d_no_speech=nsp, logits=l2, got=got, want=want, rows_equal=same,
                pad_ok=all(g is None for g in got[n_active:]))


# bf16 tolerance of a tp engine against one engine (the partial sums add in
# another order, and bf16 rounds each layer's output): the prefill's f32
# logits and no-speech probabilities.
TP_TOL = dict(logits=0.5, no_speech=0.02)


class _IdsTokenizer:
    def decode(self, ids, skip_special_tokens=True):
        return " ".join(str(int(i)) for i in ids)


def _tp_serving(dev):
    """Phase 9's serving config for phases 20 and 21: (cfg, st, lang_ids)."""
    from norma_tpu_torch.decode import SpecialTokens
    from norma_tpu_torch.model import PRESETS

    cfg = PRESETS["distil-large-v3"].with_(
        max_target_positions=448, decode_buckets=(128, 256), encoder_attn_impl="jax_flash",
        cross_kv_impl="kernel", self_kv_impl="kernel",
    )
    return cfg, SpecialTokens(**ST_V3), LANG_IDS_V3


def _tp_rows(cfg, lang_ids):
    """Phases 20 and 21's audio: (one window of audio, a padded B=8 batch of
    its shifts, the active rows, the rows' languages)."""
    import numpy as np

    from norma_tpu_torch.frontend.mel import prepare_audio

    sr = 16000
    n_win = 2 * cfg.max_source_positions
    n_samp = (n_win - 1) * 160 + 400
    tt = np.arange(n_samp) / sr
    audio = (0.15 * np.sin(2 * np.pi * 440 * tt) + 0.05 * np.random.default_rng(4).standard_normal(n_samp)).astype(np.float32)
    rows = np.stack([prepare_audio(np.roll(audio, sr * i), n_win) for i in range(8)])
    n_active = 5
    rows[n_active:] = rows[0]
    return audio, rows, n_active, [lang_ids[0]] * 8


def phase_tp(rec, dev, cfg=None, params=None, st=None, lang_ids=None, f32=None, seconds=(12.0, 24.0),
             tol=None, spec=None):
    """Tensor parallelism on one device (phase 20); a CPU rehearsal passes a
    tiny serving config, its params, tokens, an f32 (cfg, params) pair,
    shorter streams and ``spec``, the keyword arguments of
    :func:`tp_speculative` (tiny speculative configs): tp=2 and tp=4 over
    virtual devices (one process, a LocalGroup).  Phase 21 runs tp over the
    cards."""
    import gc

    import numpy as np
    import torch

    from norma_tpu_torch.decode import DecodeEngine, LanguageState
    from norma_tpu_torch.frontend.mel import log_mel_spectrogram, prepare_audio
    from norma_tpu_torch.model import PRESETS
    from norma_tpu_torch.models.whisper import WhisperModel
    from norma_tpu_torch.ops import launch_counters
    from norma_tpu_torch.parallel import make_mesh, shard_params

    dev = torch.device(dev)
    cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    tol = tol or TP_TOL
    if cfg is None:
        cfg, st, lang_ids = _tp_serving(dev)
    t0 = time.perf_counter()
    if params is None:
        params = _serving_params(cfg, dev)
    sync()
    make_s = time.perf_counter() - t0
    sr, n_win = 16000, 2 * cfg.max_source_positions
    audio, rows, n_active, langs = _tp_rows(cfg, lang_ids)
    serving = ("sample_step", "self_decode", "cross_decode", "flash_encoder", "q8a8", "w8_matmul")
    counters = {k: c for k, c in launch_counters().items() if k in serving}
    out = {}

    def counted(fn):
        sync()
        for c in counters.values():
            c.launches = 0
        fn()
        sync()
        return {k: c.launches for k, c in counters.items()}

    one = DecodeEngine(params, cfg, st, language_token_ids=lang_ids, quantize_cross_kv=True)
    # ---- 1. tp=2 on one device: a LocalGroup ----
    mesh2 = make_mesh(tp=2, devices=[dev, dev])
    tp2 = DecodeEngine(shard_params(params, mesh2), cfg, st, language_token_ids=lang_ids, quantize_cross_kv=True)
    try:
        r0 = tp2.replicas[0].engine
        # Ranks bit for bit: each rank's encoder output, computed on its own
        # shard from the shared sums.
        mel = log_mel_spectrogram(torch.from_numpy(rows[:2]).to(dev), n_mels=cfg.num_mel_bins, n_frames=n_win)
        with torch.no_grad():
            feats = r0._fan("encode", r0._rp, cfg, mel)
        if not all(torch.equal(feats[0], f) for f in feats[1:]):
            raise AssertionError("tp=2 ranks' encoder outputs differ")
        chk = tp_window_check(tp2, one, rows, langs, n_active, tol)
        if not chk["pad_ok"]:
            raise AssertionError("tp=2: pad rows gave results")
        # The LocalGroup engine's window is one graph, its collectives inside
        # the WHILE bodies: its results equal its per-step eager window's, and
        # a warm window is one host read, dispatched without waiting.
        eager2, _ = r0.transcribe_window_eager(rows, langs, seed=1, n_active=n_active)
        if not all(_same_result(a, b) for a, b in zip(chk["got"], eager2)):
            raise AssertionError("tp=2 window graph results differ from its per-step eager window's")
        read2 = one_read_window(tp2, rows, langs, 1, n_active=n_active)[1] if cuda else None
        # Launches per window, one engine and tp=2 (graphs captured above):
        # the encoder's kernels run once per rank, so tp=2 launches twice
        # one engine's; every serving kernel launched.
        c1 = counted(lambda: one.transcribe_window(rows, langs, seed=1, n_active=n_active))
        c2 = counted(lambda: tp2.transcribe_window(rows, langs, seed=1, n_active=n_active))
        if cuda:
            bad = [k for k in serving if c2[k] <= 0]
            if bad or c2["flash_encoder"] != 2 * c1["flash_encoder"] or c2["q8a8"] != 2 * c1["q8a8"]:
                raise AssertionError(f"tp=2 launches {c2} against one engine's {c1}")
        out["tp2_window"] = dict(d_logits=chk["d_logits"], d_no_speech=chk["d_no_speech"],
                                 rows_equal=chk["rows_equal"], launches=c2, launches_one=c1,
                                 collectives=r0._group.collectives, one_read=read2,
                                 graphs=window_graph_stats(tp2) if cuda else None)
        log(f"  tp=2 over {[str(d) for d in mesh2.devices.flat]} (one process): ranks' encoder outputs equal bit for "
            f"bit; padded B=8 window ({n_active} active) against one engine: prefill max |d logits| "
            f"{chk['d_logits']:.4g}, max |d no_speech| {chk['d_no_speech']:.3g} (tolerance {tol}); "
            f"{chk['rows_equal']}/8 rows equal bit for bit; launches a window {c2} (one engine {c1})")
        if cuda:
            log(f"  tp=2 (LocalGroup) window graph: results equal its per-step eager window's; warm window "
                f"{one_read_text(read2)}; graphs: {graph_stats_text(out['tp2_window']['graphs'])}")
        # Served: BatchedTranscriber over the tp mesh.
        model = WhisperModel(tp2, _IdsTokenizer(), LanguageState(const=lang_ids[0]), language_tokens=lang_ids)
        rep = serve_streams(model, 8, seconds, mesh=mesh2)
        check_served(rep, 8)
        if rep["captures"]:
            raise AssertionError(f"{rep['captures']} CUDA graphs captured during the served tp rounds, after warmup")
        b8 = [r["ms"] for r in rep["rounds"] if r["B"] == 8]
        out["tp2_served"] = dict(rounds=len(rep["rounds"]), peak=rep["peak"], launches=rep["launches"],
                                 warm_s=rep["warm_s"], wall_s=rep["wall_s"], captures=rep["captures"],
                                 round_b8_ms=dict(n=len(b8), median=float(np.median(b8)), min=min(b8), max=max(b8))
                                 if b8 else None)
        b8_txt = (f"median {np.median(b8):.1f} ms ({min(b8):.1f}-{max(b8):.1f}, {len(b8)} rounds)" if b8
                  else "no B=8 round")
        log(f"  tp=2 served: BatchedTranscriber(max_streams=8, mesh=tp2) warmup {rep['warm_s']:.1f} s; 8 streams "
            f"{seconds[0]:g}-{seconds[1]:g} s served in {rep['wall_s']:.1f} s over {len(rep['rounds'])} rounds: "
            f"B=8 rounds {b8_txt}; CUDA graphs captured after warmup: {rep['captures']}; "
            f"peak_mem={rep['peak'] / 2**30:.2f} GiB; launches={rep['launches']}")
        del model
    finally:
        tp2.close()
    del tp2
    gc.collect()

    # ---- 2. tp=4 on one device: B=1 (the ragged int8 head, q8a8 at K 320 / N 960) ----
    mesh4 = make_mesh(tp=4, devices=[dev] * 4)
    tp4 = DecodeEngine(shard_params(params, mesh4), cfg, st, language_token_ids=lang_ids, quantize_cross_kv=True)
    try:
        r4 = tp4.replicas[0].engine
        heads = [p["decoder"]["tok_emb_q8"]["q"].shape[1] for p in r4._rp]
        chk4 = tp_window_check(tp4, one, rows[:1], langs[:1], 1, tol)
        c4 = counted(lambda: tp4.transcribe_window(rows[:1], langs[:1], seed=1))
        if cuda and any(c4[k] <= 0 for k in serving):
            raise AssertionError(f"tp=4 B=1 window launches {c4}")
        out["tp4_b1"] = dict(d_logits=chk4["d_logits"], d_no_speech=chk4["d_no_speech"], head_shards=heads,
                             launches=c4)
        log(f"  tp=4 over {[str(d) for d in mesh4.devices.flat]}: int8 head shards {heads}; B=1 window against one "
            f"engine: prefill max |d logits| {chk4['d_logits']:.4g}, max |d no_speech| {chk4['d_no_speech']:.3g}; "
            f"tokens {'equal' if chk4['rows_equal'] else 'differ'}; launches {c4}")
    finally:
        tp4.close()
    del tp4
    gc.collect()
    if cuda:  # phase 8's checks at the tp=4 shapes: tails in K and N
        q8 = {}
        phase_q8a8(q8, dev, rows=(12000, 1500, 1507), shapes=TP4_Q8_SHAPES)
        out["q8a8_tp4"] = q8["q8a8_times"]

    # ---- 3. f32, exact: tp=2 greedy tokens at B=8 against one engine ----
    if f32 is None:
        cfg5 = PRESETS["distil-large-v3"].with_(max_target_positions=448, decode_buckets=(128, 256),
                                                self_kv_impl="kernel")
        f32 = (cfg5, device_params(cfg5, 5, torch.float32, dev))
    cfg5, params5 = f32
    rng = np.random.default_rng(0)
    t30 = np.arange(30 * sr) / sr
    a5 = (0.15 * np.sin(2 * np.pi * 440 * t30) + 0.05 * rng.standard_normal(30 * sr)).astype(np.float32)
    batch = np.stack([prepare_audio(a5 * (1.0 + 0.1 * i), 2 * cfg5.max_source_positions) for i in range(8)])
    def f32_rows(cfg_, **kw):
        """Greedy rows of the B=8 batch on one device and at tp=2 (equal)."""
        one5 = DecodeEngine(params5, cfg_, st, language_token_ids=lang_ids, **kw)
        want5 = one5.run_loop(one5.prefill_window(batch, lang_ids[0]), 0.0, 0)
        del one5
        tp5 = DecodeEngine(shard_params(params5, mesh2), cfg_, st, language_token_ids=lang_ids, **kw)
        try:
            got5 = tp5.run_loop(tp5.prefill_window(batch, lang_ids[0]), 0.0, 0)
        finally:
            tp5.close()
        differ = [k for k, (w, g) in enumerate(zip(want5, got5)) if w.tokens != g.tokens]
        if differ:
            k = differ[0]
            w_, g_ = want5[k].tokens, got5[k].tokens
            i = next((j for j, (x, y) in enumerate(zip(w_, g_)) if x != y), min(len(w_), len(g_)))
            raise AssertionError(f"f32 tp=2 greedy rows {differ} differ from the one-device engine's at B=8 "
                                 f"({cfg_.cross_kv_impl}, {kw}); row {k} first at position {i}: {w_[i:i + 3]} vs "
                                 f"{g_[i:i + 3]}")
        return [len(w.tokens) for w in want5]

    out["f32"] = dict(tokens=f32_rows(cfg5))
    log(f"  tp f32 (phase 5's config): tp=2 greedy tokens equal the one-device engine's at B=8 "
        f"({out['f32']['tokens']} tokens)")
    # "a8" over int8 cross-K/V: q's row scale is the max over both ranks'
    # columns (one more collective a layer), so the rows are tp=1's.
    t0 = time.perf_counter()
    out["f32_a8"] = dict(tokens=f32_rows(cfg5.with_(cross_kv_impl="a8"), quantize_cross_kv=True))
    log(f"  tp f32 a8 (phase 5's config, cross_kv_impl='a8', int8 cross-K/V): tp=2 greedy tokens equal the "
        f"one-device engine's at B=8 ({out['f32_a8']['tokens']} tokens; {time.perf_counter() - t0:.1f} s)")
    del params5, f32
    gc.collect()

    del one, params
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    # ---- 4. speculative decoding at tp=2 on one device ----
    out["speculative"] = tp_speculative(rec, dev, **(spec or {}))
    rec["tp"] = out
    log(f"phase 20 tp: ok; serving params {make_s:.1f} s to make; tp=2 and tp=4 on one device, f32 tokens equal "
        f"(einsum and a8 cross-attention), speculative tp=2 f32 tokens equal; {smi_line() if cuda else 'cpu'}")


# bf16 tolerance of the tp=2 verify chunk's f32 logits against one
# engine's at phase 14's full depth: the partial sums add in another order
# in each of the target's 32 layers, and the logits spread 12
# (SPEC_LOGIT_STD).  Read on the H100: 0.73 at B=1, 0.81 at B=8; a wrong
# shard or gather moves them by the spread.
VERIFY_TOL = 2.0
SPEC_PATH = ("sample_step", "w8_matmul", "w4_matmul", "flash_encoder", "q8a8")  # the speculative path's kernels


def _spec_tokens(packed, na, Tmax):
    """Each active row's greedy tokens from a packed speculative window."""
    return [packed[b, :int(packed[b, Tmax])].astype(int).tolist() for b in range(na)]


def tp_speculative(rec, dev, cfg=None, dcfg=None, st=None, lang_ids=None, seconds=30.0):
    """Phase 20's speculative part: tp=2 over the device named twice (one
    process, a LocalGroup) on phase 14's configs, full width and depth.
    (1) f32: the greedy speculative rung of a B=1 and a padded B=8 window
    (5 active) gives tp=1's tokens (phase 14's rows of this run, or a tp=1
    engine's where phase 14 did not run); a B=1 window whose rows are all
    finished before the first round, run first, captures the round loop's
    graph, so the live B=1 window captures none.  (2) The serving knobs
    (bf16, fused QKV, int8 decoder, int4 head, w8a8 + flash encoder; int8
    draft): w8_dense against its plain version on both ranks' shards at
    the path's rows; the verify chunk's logits within ``TP_TOL`` of tp=1's
    on the same prefill; after a warm-up (a window of padding rows at B=1
    and B=8, as silence under the no-speech gate), a B=8 window (5
    active) with valid tokens and every kernel of the path launched, a
    B=1 window, no graph captured after the warm-up;
    walls beside phase 14's tp=1 walls and tokens against its rows
    (printed, not gated: bf16 on random weights).  (3)
    :func:`spec_warmup_check`: ``WhisperModel.warmup`` at a cut depth, then
    a live and a forced-fallback window, no capture.  A CPU rehearsal
    passes tiny configs; it checks all but the launches and captures."""
    import gc

    import torch

    from norma_tpu_torch.decode import DecodeEngine, SpeculativeEngine
    from norma_tpu_torch.ops import launch_counters
    from norma_tpu_torch.parallel import make_mesh, shard_params

    dev = torch.device(dev)
    cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    cfg, dcfg, st, lang_ids = spec_configs(cfg, dcfg, st, lang_ids)
    lang, Tmax = lang_ids[0], cfg.max_target_positions
    _, windows = spec_windows(cfg, seconds)
    mesh = make_mesh(tp=2, devices=[dev, dev])
    ref = rec.get("_spec_ref", {})
    out = {}

    def free():
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()

    # ---- 1. f32, exact: tp=2 greedy tokens equal tp=1's ----
    params, dparams = spec_params(cfg, dcfg, dev, quantized=False)
    want, src = ref.get("f32"), "phase 14's tp=1 rows of this run"
    if want is None:
        src = "a tp=1 engine's (phase 14 not run)"
        one = SpeculativeEngine(params, cfg, dparams, dcfg, st, language_token_ids=lang_ids, spec_k=4)
        want = {B: spec_packed(one, windows, B, 4, dev, lang) for B in (1, 8)}
        del one
    eng = SpeculativeEngine(shard_params(params, mesh), cfg, shard_params(dparams, mesh), dcfg, st,
                            language_token_ids=lang_ids, spec_k=4)
    got, ms, caps, reads = {}, {}, [], []
    r0 = eng.replicas[0].engine
    try:
        # A B=1 window whose rows are all finished before the first round
        # (as silence is under the no-speech gate) captures the window's
        # graph, its round loop included, so the live B=1 window after it
        # captures nothing.  Each window makes one host read.
        c0, h0 = eng.graph_captures, r0.host_syncs
        spec_packed(eng, {1: (windows[1][0], 0)}, 1, 4, dev, lang)
        caps.append(eng.graph_captures - c0)
        reads.append(r0.host_syncs - h0)
        for B in (1, 8):
            c0, h0 = eng.graph_captures, r0.host_syncs
            sync()
            w0 = time.perf_counter()
            got[B] = spec_packed(eng, windows, B, 4, dev, lang)
            sync()
            ms[B] = (time.perf_counter() - w0) * 1e3
            caps.append(eng.graph_captures - c0)
            reads.append(r0.host_syncs - h0)
    finally:
        eng.close()
    if (cuda and caps != [1, 0, 1]) or reads != [1, 1, 1]:
        raise AssertionError(f"speculative tp=2 captures: {caps} for the all-finished B=1 window, the live B=1 and "
                             f"B=8 windows; expected [1, 0, 1]; host reads {reads}, expected one each")
    del eng, params, dparams
    free()
    for B in (1, 8):
        na = windows[B][1]
        tw, tg = _spec_tokens(want[B], na, Tmax), _spec_tokens(got[B], na, Tmax)
        for b, (w_, g_) in enumerate(zip(tw, tg)):
            if w_ != g_:
                i = next((j for j, (x, y) in enumerate(zip(w_, g_)) if x != y), min(len(w_), len(g_)))
                raise AssertionError(f"f32 speculative tp=2: B={B} row {b} differs from tp=1 at position {i} "
                                     f"(tp=1 {w_[i:i + 3]}, tp=2 {g_[i:i + 3]})")
        out[f"f32_b{B}"] = dict(n=[len(x) for x in tg], rounds_tp1=want[B][:na, -1].astype(int).tolist(),
                                rounds_tp2=got[B][:na, -1].astype(int).tolist(), ms=ms[B])
    out["f32_captures"], out["f32_reads"] = caps, reads
    log(f"  speculative tp=2 over {[str(d) for d in mesh.devices.flat]} (one process), f32 {cfg.decoder_layers}-layer "
        f"target + {dcfg.decoder_layers}-layer draft, spec_k=4: greedy tokens equal {src} at B=1 and B=8 "
        f"({windows[8][1]} active); " + "; ".join(
            f"B={B}: n {v['n']}, rounds tp=2 {v['rounds_tp2']} (tp=1 {v['rounds_tp1']}), window "
            f"{v['ms']:.1f} ms" for B, v in ((1, out["f32_b1"]), (8, out["f32_b8"])))
        + f"; graphs captured by an all-finished B=1 window, then the live B=1 and B=8 windows: {caps}, host "
        f"reads {reads}")

    # ---- 2. the serving knobs, bf16, full depth ----
    cfgq = cfg.with_(encoder_attn_impl="flash", encoder_q8_mode="w8a8")
    pq, dq = spec_params(cfg, dcfg, dev, quantized=True)
    K = 4
    chunks = {B: spec_chunk_tokens(windows[B][0].shape[0], K, lang_ids, st) for B in (1, 8)}
    one = DecodeEngine(pq, cfgq, st, language_token_ids=lang_ids)
    want_lg = {B: spec_chunk_logits(one, windows[B][0], lang, chunks[B]) for B in (1, 8)}
    del one
    sp, sd = shard_params(pq, mesh), shard_params(dq, mesh)
    del pq, dq
    free()
    counters = {k: c for k, c in launch_counters().items() if k in SPEC_PATH}
    eng = SpeculativeEngine(sp, cfgq, sd, dcfg, st, language_token_ids=lang_ids, spec_k=K)
    try:
        # w8 on each rank's shards at the path's rows: the target's prefill
        # (2 B) and verify chunk (B (K+1)), the draft's prefill and steps (B).
        w8 = w8_shard_check(eng._rp, (2, 16, 1 * (K + 1), 8 * (K + 1)), dev)
        w8.update(w8_shard_check(eng._drp, (1, 8, 2, 16), dev, tag="draft "))
        # The verify chunk's logits at tp=2 against tp=1's on the same
        # window, prefill and chunk tokens.
        d_chunk = {B: float((spec_chunk_logits(eng, windows[B][0], lang, chunks[B]) - want_lg[B]).abs().max())
                   for B in (1, 8)}
        z_chunk = {B: float(want_lg[B].abs().max()) for B in (1, 8)}
        if not max(d_chunk.values()) <= VERIFY_TOL:
            raise AssertionError(f"speculative tp=2 verify chunk against tp=1: max |d logits| {d_chunk} "
                                 f"(tolerance {VERIFY_TOL})")
        del want_lg
        # The warm-up of the measured windows: at B=1 and B=8 a window whose
        # rows are all finished before the first round (what
        # WhisperModel.warmup's silent window is under a no-speech gate
        # that closes on silence; these random weights would decode it in
        # full).  Neither window takes the t>0 fallback; part 3 runs
        # WhisperModel.warmup, warmup_fallback's ladder included, and a
        # live window forced into that fallback.
        sync()
        w0 = time.perf_counter()
        for B in (1, 8):
            eng.transcribe_window(windows[B][0], [lang] * B, 0, n_active=0)
        sync()
        warm_s = time.perf_counter() - w0
        caps0 = eng.graph_captures
        audio8, na8 = windows[8]
        r0 = eng.replicas[0].engine
        fallbacks = []  # a window that runs its fallback makes a second host read
        inner_fb = r0._fallback
        r0._fallback = lambda *a, **k: (fallbacks.append(1), inner_fb(*a, **k))[1]
        # ---- the speculative tp path: counts from zero ----
        sync()
        for c in counters.values():
            c.launches = 0
        h0 = r0.host_syncs
        w0 = time.perf_counter()
        out8, _ = eng.transcribe_window(audio8, [lang] * 8, 0, n_active=na8)
        sync()
        launches = {k: c.launches for k, c in counters.items()}
        # ---- end of the path ----
        ms8 = (time.perf_counter() - w0) * 1e3
        tel8 = (eng.last_spec_rounds, eng.last_tokens_per_round)
        reads = [(r0.host_syncs - h0, len(fallbacks))]
        sync()
        h0, f0 = r0.host_syncs, len(fallbacks)
        w0 = time.perf_counter()
        out1, _ = eng.transcribe_window(windows[1][0], [lang], 0)
        sync()
        ms1 = (time.perf_counter() - w0) * 1e3
        reads.append((r0.host_syncs - h0, len(fallbacks) - f0))
        tel1 = (eng.last_spec_rounds, eng.last_tokens_per_round)
        caps = eng.graph_captures - caps0
    finally:
        eng.close()
    del eng, sp, sd
    free()
    if cuda and any(v <= 0 for v in launches.values()):
        raise AssertionError(f"speculative tp=2: kernels not launched on the path: {launches}")
    if cuda and caps:
        raise AssertionError(f"speculative tp=2: {caps} CUDA graphs captured after the warm-up")
    if any(n != 1 + f for n, f in reads):
        raise AssertionError(f"speculative tp=2: host reads, fallbacks of the B=8 and B=1 windows {reads}; want 1, "
                             "2 with a fallback")
    for r in out8[:na8] + out1:
        if r is None or not r.tokens or not all(0 <= x < cfg.vocab_size for x in r.tokens):
            raise AssertionError("speculative tp=2: a bf16 row is empty or out of range")
    if any(r is not None for r in out8[na8:]):
        raise AssertionError("speculative tp=2: pad rows gave results")
    tokens = {8: [r.tokens for r in out8[:na8]], 1: [out1[0].tokens]}
    bref = ref.get("bf16")
    equal = ({B: [a == b for a, b in zip(tokens[B], bref[B])] for B in (1, 8)} if bref and 1 in bref
             else "phase 14 not run")
    walls14 = rec.get("speculative", {}).get("walls")
    w14 = (f"phase 14's tp=1 B=1 median {walls14['spec_median_ms']:.1f} ms ({[round(x, 1) for x in walls14['spec_ms']]}),"
           f" B=8 {walls14['b8']['spec_ms']:.1f} ms with its first captures, {walls14['b8']['rounds']} rounds, "
           f"{walls14['b8']['tokens_per_round']} tokens/round" if walls14 else "phase 14 not run")
    out["bf16"] = dict(warm_s=warm_s, ms_b8=ms8, ms_b1=ms1, rounds_b8=tel8[0], tokens_per_round_b8=tel8[1],
                       rounds_b1=tel1[0], tokens_per_round_b1=tel1[1], launches=launches, captures_after_warmup=caps,
                       reads=reads,
                       equal_tp1=equal, n=[len(t) for t in tokens[8]], w8_shards=w8, d_chunk_logits=d_chunk)
    log(f"  speculative tp=2, serving knobs (bf16, fused QKV, int8 decoder, int4 head, w8a8 + flash encoder; int8 "
        f"draft), {cfg.decoder_layers}/{dcfg.decoder_layers} decoder layers: w8_dense against w8_dense_torch on both "
        f"ranks' shards at the path's rows, worst of max|y| {w8}; verify chunk logits (B x {K + 1}) against tp=1's "
        f"on the same prefill, max |d| {d_chunk} (tolerance {VERIFY_TOL}); warm-up (a window of padding rows "
        f"at B=1 and B=8) {warm_s:.1f} s; B=8 ({na8} active) {ms8:.1f} ms, {tel8[0]} rounds, "
        f"{tel8[1]} tokens/round, launches {launches}; B=1 {ms1:.1f} ms, {tel1[0]} rounds, {tel1[1]} tokens/round; "
        f"graph captures after the warm-up {caps}; host reads, fallbacks (B=8, B=1) {reads}; rows equal to phase "
        f"14's tp=1 rows {equal} (printed, not gated); "
        f"{w14}; {smi_line() if cuda else 'cpu'}")

    # The verify chunk's tp=2 gap at cut depths beside the full depth's.
    gaps = chunk_gap_by_depth(dev, cfg, st, lang_ids, windows, mesh, lang, chunks, depths=(4, 8, 16))
    gaps[cfg.decoder_layers] = {B: (d_chunk[B], z_chunk[B]) for B in (1, 8)}
    out["gap_by_depth"] = gaps
    # The same gap at full depth with f32 weights and activations and no
    # quantization: the shards' partial sums add in another order, so a
    # gap at f32 rounding says the shards and their reductions are right.
    f32gap = chunk_gap_by_depth(dev, cfg, st, lang_ids, windows, mesh, lang, chunks, depths=(cfg.decoder_layers,),
                                dtype=torch.float32)[cfg.decoder_layers]
    out["gap_f32"] = f32gap
    log(f"  speculative tp=2 verify chunk, bf16 serving knobs, max |tp=2 - tp=1| logits (and tp=1's max |logit|) "
        f"by target decoder depth, B=1 / B=8: " + "; ".join(
            f"{L}: {v[1][0]:.4f} ({v[1][1]:.1f}) / {v[8][0]:.4f} ({v[8][1]:.1f})" for L, v in sorted(gaps.items()))
        + f"; f32 weights, unquantized, depth {cfg.decoder_layers}: {f32gap[1][0]:.3g} ({f32gap[1][1]:.1f}) / "
        f"{f32gap[8][0]:.3g} ({f32gap[8][1]:.1f}); {smi_line() if cuda else 'cpu'}")

    # ---- 3. WhisperModel.warmup, then a live forced fallback ----
    out["warmup"] = spec_warmup_check(dev, cfg, dcfg, st, lang_ids, windows, mesh)
    return out


def chunk_gap_by_depth(dev, cfg, st, lang_ids, windows, mesh, lang, chunks, depths, dtype=None):
    """The bf16 verify chunk's max |logits at tp=2 over ``mesh`` - tp=1's|
    with phase 20's serving knobs and target draws (seed 31) at each
    decoder depth of ``depths``, the B=1 and B=8 windows: {depth: {B:
    (gap, tp=1's max |logit|)}}.  ``dtype`` torch.float32: the same draws
    in f32, unquantized, on ``cfg``'s own knobs."""
    import gc

    import torch

    f32 = dtype == torch.float32

    from norma_tpu_torch.decode import DecodeEngine
    from norma_tpu_torch.model import fuse_qkv
    from norma_tpu_torch.model.quant import quantize_decoder, quantize_encoder
    from norma_tpu_torch.parallel import shard_params

    out = {}
    for L in depths:
        cl = cfg.with_(decoder_layers=L)
        if f32:
            cq, pq = cl, device_params(cl, 31, torch.float32, dev, logit_std=SPEC_LOGIT_STD)
        else:
            cq = cl.with_(encoder_attn_impl="flash", encoder_q8_mode="w8a8")
            pq = quantize_encoder(quantize_decoder(fuse_qkv(device_params(cl, 31, torch.bfloat16, dev,
                                                                          logit_std=SPEC_LOGIT_STD)), logits="int4"))
        one = DecodeEngine(pq, cq, st, language_token_ids=lang_ids)
        want = {B: spec_chunk_logits(one, windows[B][0], lang, chunks[B]) for B in (1, 8)}
        del one
        tp = DecodeEngine(shard_params(pq, mesh), cq, st, language_token_ids=lang_ids)
        try:
            out[L] = {B: (float((spec_chunk_logits(tp, windows[B][0], lang, chunks[B]) - want[B]).abs().max()),
                          float(want[B].abs().max())) for B in (1, 8)}
        finally:
            tp.close()
        del tp, pq, want
        gc.collect()
        if torch.device(dev).type == "cuda":
            torch.cuda.empty_cache()
    return out


def spec_chunk_tokens(B, K, lang_ids, st):
    """A verify chunk's tokens [B, K+1]: the pending task token, then K
    text tokens (a different run of ids on each row)."""
    import torch

    text = torch.arange(K)[None] * 97 + torch.arange(B)[:, None] * 13 + 400
    return torch.cat([torch.full((B, 1), st.task), text], dim=1).to(torch.int32)


def spec_chunk_logits(eng, audio, lang, chunk):
    """The target's verify-chunk logits on ``eng`` (one engine, or rank 0
    of a tp engine's, which every rank holds whole) for the window
    ``audio``: the target's prefill of [sot, lang], then ``chunk`` fed at
    positions 2 .. 2 + K, as a speculative round's first verify pass.
    f32 [B, K+1, V]."""
    import torch
    import torch.nn.functional as F

    from norma_tpu_torch.parallel.collectives import first, per_rank

    dev, cfg = eng.device, eng.cfg
    B, C = chunk.shape
    audio_t = torch.as_tensor(audio).to(dev)
    _, xk, xv, prefix, _, _ = eng._window_front(audio_t, torch.full((B,), lang, device=dev), detect=False)
    _, ck, cv = eng._fan("decoder_prefill", eng._rp, cfg, prefix[:, :2], xk, xv)
    ck, cv = per_rank(lambda *cs: tuple(F.pad(c, (0, 0, 0, C)) for c in cs), ck, cv)
    pos = torch.full((B,), 2, dtype=torch.int32, device=dev)
    logits, _, _ = eng._fan("decoder_chunk", eng._rp, cfg, chunk.to(dev), pos, ck, cv, xk, xv)
    return first(logits).float()


def w8_shard_check(shards, rows, dev, tag=""):
    """w8_dense against w8_dense_torch on each rank's int8 products: its
    first decoder layer's fused QKV, self and cross out, cross query, fc1
    and fc2 shards, and its int8 head's vocabulary shard where it has one,
    each at every count of ``rows`` with bf16 x (the serving path's),
    within 1e-5 of max |y| as phase 11, one launch a product on CUDA.
    Returns {"[tag]name KxN": worst error over max |y|}."""
    import torch

    from norma_tpu_torch.ops import quant_matmul as qm

    g = torch.Generator(device=dev).manual_seed(20)
    worst = {}
    for p in shards:
        dec = p["decoder"]
        layers = dec["layers"]
        prods = [(n, layers[n + "_q"][0], layers[n + "_s"][0])
                 for n in ("qkv_w", "o_w", "xq_w", "xo_w", "fc1_w", "fc2_w") if n + "_q" in layers]
        if "tok_emb_q8" in dec:
            prods.append(("head", dec["tok_emb_q8"]["q"], dec["tok_emb_q8"]["s"]))
        for name, q, s in prods:
            q, s = q.reshape(q.shape[0], -1), s.reshape(-1)
            Kd, N = q.shape
            key = f"{tag}{name} {Kd}x{N}"
            for m in rows:
                x = torch.randn((m, Kd), generator=g, device=dev).to(torch.bfloat16)
                before = qm.w8_matmul.launches
                ko = qm.w8_dense(x, q, s)
                launched = qm.w8_matmul.launches - before
                po = qm.w8_dense_torch(x, q, s)
                if torch.device(dev).type == "cuda" and launched != 1:
                    raise AssertionError(f"w8 {key} rows={m}: {launched} launches for one product")
                if ko.shape != (m, N) or not torch.isfinite(ko).all():
                    raise AssertionError(f"w8 {key} rows={m}: bad output")
                err, rel = _rel_err(ko, po)
                if not rel <= 1e-5:
                    raise AssertionError(f"w8 {key} rows={m}: err {err} ({rel:.3g} of max|y|)")
                worst[key] = max(worst.get(key, 0.0), rel)
    return worst


def spec_warmup_check(dev, cfg, dcfg, st, lang_ids, windows, mesh):
    """Phase 20's speculative part 3: ``WhisperModel.warmup(batch=8)`` on a
    speculative tp=2 engine (phase 14's target cut to 4 encoder and 4
    decoder layers with the serving knobs, its draft), then a live B=8
    window (5 active) and the same window with every active row failing the
    logprob gate (the t>0 fallback's whole ladder on live features): no
    CUDA graph captured after the warm-up."""
    import gc

    import torch

    import norma_tpu_torch.decode.speculative as spec_mod
    from norma_tpu_torch.decode import LanguageState, SpeculativeEngine
    from norma_tpu_torch.models.whisper import WhisperModel
    from norma_tpu_torch.parallel import shard_params

    cuda = torch.device(dev).type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    cut = cfg.with_(encoder_layers=min(4, cfg.encoder_layers), decoder_layers=min(4, cfg.decoder_layers))
    cfgq = cut.with_(encoder_attn_impl="flash", encoder_q8_mode="w8a8")
    lang = lang_ids[0]
    audio8, na8 = windows[8]
    pq, dq = spec_params(cut, dcfg, dev, quantized=True)
    eng = SpeculativeEngine(shard_params(pq, mesh), cfgq, shard_params(dq, mesh), dcfg, st,
                            language_token_ids=lang_ids, spec_k=4)
    del pq, dq
    inner = eng.replicas[0].engine if hasattr(eng, "replicas") else eng
    rungs, fb = [], inner._fallback

    def fallback(*a, **k):
        rows = fb(*a, **k)  # host rows: one program, one read
        rungs.append(rows[:, -1].astype(int).tolist())  # each row's settling rung, -1: none
        return rows

    inner._fallback = fallback
    try:
        model = WhisperModel(eng, _IdsTokenizer(), LanguageState(const=lang))
        sync()
        w0 = time.perf_counter()
        model.warmup(batch=8)
        sync()
        warm_s = time.perf_counter() - w0
        warm_fb, caps0 = len(rungs), eng.graph_captures
        h0 = inner.host_syncs
        eng.transcribe_window(audio8, [lang] * 8, 0, n_active=na8)
        n0 = len(rungs)
        reads = [(inner.host_syncs - h0, n0 - warm_fb)]
        threshold = spec_mod.LOGPROB_THRESHOLD
        spec_mod.LOGPROB_THRESHOLD = float("inf")  # every active row takes the fallback
        try:
            sync()
            h0, w0 = inner.host_syncs, time.perf_counter()
            forced, _ = eng.transcribe_window(audio8, [lang] * 8, 0, n_active=na8)
            sync()
            forced_ms = (time.perf_counter() - w0) * 1e3
            reads.append((inner.host_syncs - h0, len(rungs) - n0))
        finally:
            spec_mod.LOGPROB_THRESHOLD = threshold
        caps = eng.graph_captures - caps0
    finally:
        eng.close()
    del eng, inner, model
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    forced_rungs = rungs[n0:]
    if not warm_fb or len(forced_rungs) != 1:
        raise AssertionError(f"speculative tp=2 warm-up: fallback passes {warm_fb} in WhisperModel.warmup and "
                             f"{len(forced_rungs)} in the forced live window, expected 1 or more and 1")
    for r, rung in zip(forced[:na8], forced_rungs[0]):
        # A row no rung accepted (-1) has no result; the others have tokens.
        if (r is None) != (rung < 0) or (r is not None and not all(0 <= x < cfg.vocab_size for x in r.tokens)):
            raise AssertionError(f"speculative tp=2: forced-fallback row {r} against its rung {rung}")
    if cuda and caps:
        raise AssertionError(f"speculative tp=2: {caps} CUDA graphs captured after WhisperModel.warmup")
    if any(n != 1 + f for n, f in reads):
        raise AssertionError(f"speculative tp=2: host reads, fallbacks of the live and the forced window {reads}; "
                             "want 1, 2 with a fallback")
    log(f"  speculative tp=2 at {cut.encoder_layers}/{cut.decoder_layers} target layers (serving knobs): "
        f"WhisperModel.warmup(batch=8) {warm_s:.1f} s, {warm_fb} fallback pass(es), the last's rungs by row "
        f"{rungs[warm_fb - 1]}; then a live B=8 window ({na8} active) and the same window forced to the fallback "
        f"({forced_ms:.1f} ms, rungs by row {forced_rungs[0]}; -1: every rung ran, none accepted): graph captures "
        f"after the warm-up {caps}; host reads, fallbacks {reads}")
    return dict(warm_s=warm_s, warm_fallback_passes=warm_fb, captures_after_warmup=caps, forced_ms=forced_ms,
                forced_rungs=forced_rungs[0], reads=reads)


def worker_positions(*args, cls=None, **kwargs):
    """A dp engine of ``cls`` (default ``DecodeEngine``) whose every position
    runs in worker processes, one a device (``parallel/workers.py``),
    whatever its mesh: phase 21's dp in threads against dp in processes over
    the cards, and a CPU rehearsal of the cards' path (gloo).  An engine on
    sharded params lets the mesh's devices choose instead
    (``parallel/sharding.py::in_workers``)."""
    from norma_tpu_torch.decode import DecodeEngine
    from norma_tpu_torch.parallel.data_parallel import DataParallelEngine

    class WorkerPositions(DataParallelEngine):
        _in_workers = staticmethod(lambda mesh: True)

    return WorkerPositions(cls or DecodeEngine, *args, **kwargs)


def card_memory_gib() -> list:
    """Each card's memory in use (GiB, every process's), as ``nvidia-smi``
    reads it."""
    r = subprocess.run(["nvidia-smi", "--query-gpu=memory.used", "--format=csv,noheader,nounits"],
                       capture_output=True, text=True, check=True)
    return [float(x) / 1024 for x in r.stdout.split()]


def phase_tp_cards(rec, dev, seconds=(12.0, 24.0)):
    """Tensor parallelism over the cards (phase 21; the module docstring):
    with fewer than two cards it prints that it did not run."""
    import gc

    import torch

    from norma_tpu_torch.decode import DecodeEngine
    from norma_tpu_torch.parallel import make_mesh, shard_params

    n_cards = torch.cuda.device_count()
    if n_cards < 2:
        rec["tp_cards"] = None
        log(f"phase 21 tp_cards: not run ({n_cards} card; tp over the cards needs 2 or more)")
        return
    dev = torch.device(dev)
    cfg, st, lang_ids = _tp_serving(dev)
    params = _serving_params(cfg, dev)
    audio, rows, n_active, langs = _tp_rows(cfg, lang_ids)
    one = DecodeEngine(params, cfg, st, language_token_ids=lang_ids, quantize_cross_kv=True)
    # tp=2 in one process (phase 20's LocalGroup run): what the workers
    # must give bit for bit.
    tp2 = DecodeEngine(shard_params(params, make_mesh(tp=2, devices=[dev, dev])), cfg, st,
                       language_token_ids=lang_ids, quantize_cross_kv=True)
    try:
        local = tp_window_check(tp2, one, rows, langs, n_active, TP_TOL)
        rec["tp_cards"] = tp_over_cards(cfg, params, st, lang_ids, one, rows, langs, n_active, TP_TOL, local,
                                        seconds, audio, local_eng=tp2)
    finally:
        tp2.close()
    del tp2, one, params
    gc.collect()
    torch.cuda.empty_cache()
    rec["tp_cards"]["speculative"] = spec_over_cards(dev)
    log(f"phase 21 tp_cards: ok over {n_cards} cards through worker processes; {smi_line()}")


def rank_counters(engine):
    """A worker rank's engine counters (``WorkerEngine.on_ranks``)."""
    return dict(host_syncs=engine.host_syncs, graph_captures=engine.graph_captures, decode_steps=engine.decode_steps)


def rank_window(engine, audio, langs, seed, n_active):
    """On one tp rank in its worker (``WorkerEngine.on_ranks``), a window
    of a shape it captured before: on the card :func:`one_read_window`'s
    checks (no synchronizing call in the dispatch, the stream busy when it
    returns, one host read, no capture), on the CPU its host reads and
    captures; then the same window through ``transcribe_window_eager``
    (every rank runs it, so its collectives meet).  Returns (the graph
    window's results, the eager window's, the one-read figures)."""
    if engine.device.type == "cuda":
        drs, info = one_read_window(engine, audio, langs, seed, n_active)
    else:
        h0, c0 = engine.host_syncs, engine.graph_captures
        drs, _ = engine.transcribe_window_fetch(engine.transcribe_window_async(audio, langs, seed, n_active))
        info = dict(syncs=[engine.host_syncs - h0], captures=engine.graph_captures - c0)
        if info["syncs"] != [1] or info["captures"]:
            raise AssertionError(f"a warm window on a rank: {info}")
    eager, _ = engine.transcribe_window_eager(audio, langs, seed, n_active)
    return drs, eager, info


def worker_window_checks(w, local_eng, rows, langs, n_active, cuda):
    """Phase 21's warm window on the worker engine ``w`` (NCCL ranks, each
    one CUDA graph with WHILE-node loops; the shape captured before): on
    every rank :func:`rank_window`, every rank's results bit for bit equal
    to rank 0's, to its eager window's and to ``local_eng``'s (tp=2 in one
    process, a LocalGroup) on the same rows.  Returns (the ranks' one-read
    figures, each rank's window graphs' stats)."""
    reps = w.on_ranks(rank_window, rows, langs, 1, n_active)
    want, _ = local_eng.transcribe_window(rows, langs, seed=1, n_active=n_active)
    for k, (got, eager, _) in enumerate(reps):
        bad = [i for i, (g, e, l0, r0) in enumerate(zip(got, eager, want, reps[0][0]))
               if not (_same_result(g, e) and _same_result(g, l0) and _same_result(g, r0))]
        if bad or len(got) != len(want):
            raise AssertionError(f"rank {k}'s graph window on rows {bad} differs from its eager window, tp=2 in one "
                                 f"process or rank 0")
    return [r[2] for r in reps], (w.on_ranks(window_graph_stats) if cuda else [])


def new_shape_in_flight(w, local_eng, want8, rows, langs, n_active, cuda=True):
    """A window of a shape not captured yet (B=2) dispatched to the worker
    engine ``w`` while a warm padded B=8 window is in flight, then both
    fetched: the B=2 window's capture first runs it outside a graph, whose
    collectives must wait for the B=8 graph (``ProcessGroup.
    graph_launched``).  Both windows' rows must equal tp=2 in one process
    (``want8``, and ``local_eng``'s B=2 window) bit for bit, and each rank
    captures one graph (none on the CPU, where a window is no graph).
    Returns the dispatch ms and captures per rank."""
    na2 = min(n_active, 2)
    want2, _ = local_eng.transcribe_window(rows[:2], langs[:2], seed=1, n_active=na2)
    c0 = w.on_ranks(rank_counters)
    t0 = time.perf_counter()
    k8 = w.transcribe_window_async(rows, langs, 1, n_active)
    t1 = time.perf_counter()
    k2 = w.transcribe_window_async(rows[:2], langs[:2], 1, na2)
    t2 = time.perf_counter()
    got8, _ = w.transcribe_window_fetch(k8)
    got2, _ = w.transcribe_window_fetch(k2)
    caps = [b["graph_captures"] - a["graph_captures"] for a, b in zip(c0, w.on_ranks(rank_counters))]
    bad8 = [i for i, (a, b) in enumerate(zip(got8, want8)) if not _same_result(a, b)]
    bad2 = [i for i, (a, b) in enumerate(zip(got2, want2)) if not _same_result(a, b)]
    if bad8 or bad2 or len(got8) != len(want8) or len(got2) != 2 or caps != [int(cuda)] * len(caps):
        raise AssertionError(f"a new shape while a window was in flight: B=8 rows {bad8} and B=2 rows {bad2} differ "
                             f"from tp=2 in one process; captures per rank {caps} (want {int(cuda)} each)")
    return dict(dispatch_ms=[(t1 - t0) * 1e3, (t2 - t1) * 1e3], captures=caps)


def rank_stats_text(stats) -> str:
    return " | ".join(f"rank {k}: " + "; ".join(
        f"{program_text(key)} {g.get('nodes')} + {g.get('body_nodes', 0)} body nodes {g.get('body_types')}, record "
        f"{g.get('record_s', float('nan')):.2f} s" for key, g in e[0]["graphs"].items()) for k, e in enumerate(stats))


def tp_over_cards(cfg, params, st, lang_ids, one, rows, langs, n_active, tol, local, seconds, audio, devices=None,
                  local_eng=None):
    """Phase 21 (the module docstring); ``local`` is
    :func:`tp_window_check`'s result for tp=2 in one process, on
    ``local_eng``.  A CPU rehearsal passes ``devices=["cpu"] * 4``: its
    positions run in gloo worker processes (:func:`worker_positions`), with
    no device profile."""
    import numpy as np
    import torch

    from norma_tpu_torch.decode import DecodeEngine, LanguageState
    from norma_tpu_torch.models.whisper import WhisperModel
    from norma_tpu_torch.parallel import make_mesh as _make_mesh, shard_params

    cuda = devices is None
    devices = devices or [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    n = len(devices)
    engine = DecodeEngine if cuda else worker_positions  # the cards choose workers; the CPU asks for them
    make_mesh = lambda dp=1, tp=1: _make_mesh(dp=dp, tp=tp, devices=devices)  # noqa: E731
    out = {}

    def sync_all():
        for d in range(n if cuda else 0):
            torch.cuda.synchronize(d)

    def walls(calls, turns=("a", "b", "b", "a")):
        w = {}
        for who in turns:
            sync_all()
            w0 = time.perf_counter()
            calls[who]()
            sync_all()
            w.setdefault(who, []).append((time.perf_counter() - w0) * 1e3)
        return w

    # tp=2 on cuda:0,1 (NCCL): the padded window against one engine and,
    # bit for bit, against the one-process tp=2 run of the same window (a
    # sum of two f32 partials rounds once either way).
    mesh = make_mesh(tp=2)
    t0 = time.perf_counter()
    eng = engine(shard_params(params, mesh), cfg, st, language_token_ids=lang_ids, quantize_cross_kv=True)
    spawn_s = time.perf_counter() - t0
    try:
        w = eng.replicas[0].engine
        chk = tp_window_check(eng, one, rows, langs, n_active, tol)
        same_local = sum(1 for a, b in zip(chk["got"], local["got"]) if _same_result(a, b))
        logits_local = bool(np.array_equal(chk["logits"], local["logits"]))
        if not logits_local or same_local != len(rows):
            d = float(np.abs(chk["logits"] - local["logits"]).max())
            raise AssertionError(f"tp=2 over the cards against tp=2 in one process: prefill logits "
                                 f"{'equal' if logits_local else f'differ (max |d| {d:.4g})'}, "
                                 f"{same_local}/{len(rows)} rows equal bit for bit")
        w.launches(reset=True)
        eng.transcribe_window(rows, langs, seed=1, n_active=n_active)
        per_rank = w.launches()
        bad = [k for r in per_rank for k in ("sample_step", "self_decode", "cross_decode", "flash_encoder", "q8a8",
                                              "w8_matmul") if r[k] <= 0 and cuda]
        if bad:
            raise AssertionError(f"tp=2 over the cards: a rank did not launch {bad}: {per_rank}")
        b1 = rows[:1]
        eng.transcribe_window(b1, langs[:1], seed=1)
        one.transcribe_window(b1, langs[:1], seed=1)
        wl = walls({"a": lambda: one.transcribe_window(b1, langs[:1], seed=1),
                    "b": lambda: eng.transcribe_window(b1, langs[:1], seed=1)})
        idle = (w.profile("idle_share", os.path.join(TRACES, "tp2_cards"), "transcribe_window", b1, langs[:1], 1)
                if cuda else [])
        mem = card_memory_gib()[:n] if cuda else []
        shard_gib = [sum(t.numel() * t.element_size() for t in r.buffers()) / 2**30 for r in eng.params.ranks(0)]
        out["tp2"] = dict(spawn_s=spawn_s, d_logits=chk["d_logits"], d_no_speech=chk["d_no_speech"],
                          rows_equal_one=chk["rows_equal"], rows_equal_local=same_local, launches=per_rank,
                          b1_walls=wl, idle=idle, card_mem_gib=mem, shard_gib=shard_gib)
        log(f"  tp=2 over cuda:0,1 (2 worker processes, NCCL; spawned in {spawn_s:.1f} s): padded B=8 window, ranks "
            f"bit for bit; against one engine prefill max |d logits| {chk['d_logits']:.4g}, max |d no_speech| "
            f"{chk['d_no_speech']:.3g} (tolerance {tol}), {chk['rows_equal']}/8 rows equal; against tp=2 in one "
            f"process the prefill logits and {same_local}/8 rows equal bit for bit; launches per rank {per_rank}")
        log(f"  tp=2 over cuda:0,1 memory: shards {[round(x, 3) for x in shard_gib]} GiB, kept on the host in this "
            f"process; cards in use (every process; cuda:0 also holds the one-device engine and the params) "
            f"{[round(x, 2) for x in mem]} GiB")
        log(f"  tp=2 over cuda:0,1: B=1 window walls ms in turns, one engine {[round(x, 1) for x in wl['a']]}, tp=2 "
            f"{[round(x, 1) for x in wl['b']]}; per card under torch.profiler: " + "; ".join(
                f"rank {k}: wall {v[0]:.1f} ms, busy {v[1]:.1f} ms, idle {v[2]:.1%}" for k, v in enumerate(idle)))
        c0 = w.on_ranks(rank_counters)
        for name, B in (("B=1", 1), ("padded B=8", 8)):
            na = min(n_active, B)
            reads, stats = worker_window_checks(w, local_eng, rows[:B], langs[:B], na, cuda)
            out[f"tp2_{B}"] = dict(one_read=reads, stats=stats)
            log(f"  tp=2 over cuda:0,1, warm {name} window, each NCCL rank one CUDA graph with WHILE-node loops: "
                + "; ".join(f"rank {k}: " + (one_read_text(r) if cuda else str(r)) for k, r in enumerate(reads))
                + f"; every rank bit for bit equal to its eager window and to tp=2 in one process")
        c1 = w.on_ranks(rank_counters)
        caps = [b["graph_captures"] - a["graph_captures"] for a, b in zip(c0, c1)]
        if any(caps):
            raise AssertionError(f"tp=2 over the cards: warm windows captured {caps} graphs")
        out["tp2_graphs"] = stats
        if cuda:
            log(f"  tp=2 over cuda:0,1 window graphs per rank: {rank_stats_text(stats)}")
        out["tp2_new_shape"] = new_shape_in_flight(w, local_eng, local["got"], rows, langs, n_active, cuda)
        log(f"  tp=2 over cuda:0,1, a B=2 window (a new shape) dispatched while a warm padded B=8 window was in "
            f"flight: both windows' rows bit for bit equal to tp=2 in one process; captures per rank "
            f"{out['tp2_new_shape']['captures']}; B=8 dispatch {out['tp2_new_shape']['dispatch_ms'][0]:.2f} ms, "
            f"B=2 dispatch (its capture) {out['tp2_new_shape']['dispatch_ms'][1]:.1f} ms")
        model = WhisperModel(eng, _IdsTokenizer(), LanguageState(const=lang_ids[0]), language_tokens=lang_ids)
        rep = serve_streams(model, 8, seconds, mesh=mesh)
        check_served(rep, 8)
        if rep["captures"]:
            raise AssertionError(f"{rep['captures']} CUDA graphs captured during the served rounds, after warmup")
        b8 = [r["ms"] for r in rep["rounds"] if r["B"] == 8]
        out["tp2_served"] = dict(rounds=len(rep["rounds"]), launches=rep["launches"], wall_s=rep["wall_s"],
                                 round_b8_ms=b8)
        log(f"  tp=2 over cuda:0,1 served: 8 streams in {rep['wall_s']:.1f} s over {len(rep['rounds'])} rounds, B=8 "
            f"rounds ms {[round(x, 1) for x in b8]}; captures after warmup {rep['captures']}; launches {rep['launches']}")
        del model
    finally:
        eng.close()

    if n >= 4:
        # tp=4 over the cards, then dp2 x tp2 (with phase 21's graph window
        # checks on each replica's ranks).
        for name, mesh, B in (("tp=4", make_mesh(tp=4), 1), ("dp2 x tp2", make_mesh(dp=2, tp=2), 8)):
            t0 = time.perf_counter()
            eng = engine(shard_params(params, mesh), cfg, st, language_token_ids=lang_ids, quantize_cross_kv=True)
            spawn_s = time.perf_counter() - t0
            try:
                na = min(n_active, B)
                chk = tp_window_check(eng, one, rows[:B], langs[:B], na, tol)
                eng.transcribe_window(rows[:B], langs[:B], seed=1, n_active=na)
                wl = walls({"a": lambda: one.transcribe_window(rows[:B], langs[:B], seed=1, n_active=na),
                            "b": lambda: eng.transcribe_window(rows[:B], langs[:B], seed=1, n_active=na)})
                out[name] = dict(spawn_s=spawn_s, d_logits=chk["d_logits"], d_no_speech=chk["d_no_speech"],
                                 rows_equal=chk["rows_equal"], walls=wl)
                log(f"  {name} over {[str(d) for d in mesh.devices.flat]} (spawned in {spawn_s:.1f} s): B={B} window, "
                    f"ranks bit for bit; against one engine prefill max |d logits| {chk['d_logits']:.4g}, "
                    f"max |d no_speech| {chk['d_no_speech']:.3g}, "
                    f"{chk['rows_equal']}/{B} rows equal; walls ms in turns, one engine "
                    f"{[round(x, 1) for x in wl['a']]}, {name} {[round(x, 1) for x in wl['b']]}")
                if mesh.shape["dp"] == 2:
                    eng.transcribe_window(rows[:1], langs[:1], seed=1)  # B=1 runs whole on replica 0: its capture
                    b = B // 2
                    checks = [(0, rows[:1], langs[:1], 1)] + [
                        (i, rows[i * b:(i + 1) * b], langs[:b], min(max(na - i * b, 0), b)) for i in range(2)]
                    reads = []
                    for i, r, lg, nai in checks:
                        rd, _ = worker_window_checks(eng.replicas[i].engine, local_eng, r, lg, nai, cuda)
                        reads.append(rd)
                    out[name]["one_read"] = reads
                    log(f"  {name}: warm B=1 (replica 0) and padded B=8 (4 rows a replica) windows, each NCCL "
                        f"rank one CUDA graph: one host read and busy at return on every rank "
                        f"{[[r['syncs'] for r in rd] for rd in reads]}, rows bit for bit equal to each rank's "
                        f"eager window and to tp=2 in one process")
            finally:
                eng.close()
    else:
        log(f"  tp=4 and dp2 x tp2 over the cards: not run ({n} cards; they need 4)")
    out["dp_rows"] = dp_rows_over_cards(cfg, params, st, lang_ids, audio, devices)
    return out


def spec_over_cards(dev, devices=None, cfg=None, dcfg=None, st=None, lang_ids=None, seconds=30.0):
    """Phase 21's speculative part: tp=2 over two cards, a worker process
    each (NCCL; each worker gets its rank's target and draft shards), on
    phase 14's target cut to 4 encoder and 4 decoder layers with the
    serving knobs (bf16, fused QKV, int8 decoder, int4 head, w8a8 + flash
    encoder; int8 draft), against tp=2 in one process on ``dev`` named
    twice: a padded B=8 (5 active) and a B=1 window's rows, rounds and
    tokens per round bit for bit; B=1 walls of both, in turns.  A CPU
    rehearsal passes ``devices=["cpu"] * 2`` and tiny configs (gloo
    workers)."""
    import gc

    import torch

    from norma_tpu_torch.decode import SpeculativeEngine
    from norma_tpu_torch.model import PRESETS
    from norma_tpu_torch.parallel import make_mesh, shard_params

    cuda = devices is None
    devices = devices or [torch.device("cuda", i) for i in range(2)]
    sync = (lambda: [torch.cuda.synchronize(d) for d in devices]) if cuda else (lambda: None)
    cfg, dcfg, st, lang_ids = spec_configs(
        cfg or PRESETS["large-v3"].with_(encoder_layers=4, decoder_layers=4, max_target_positions=448,
                                         decode_buckets=(128, 256)), dcfg, st, lang_ids)
    lang = lang_ids[0]
    _, windows = spec_windows(cfg, seconds)
    cfgq = cfg.with_(encoder_attn_impl="flash", encoder_q8_mode="w8a8")
    pq, dq = spec_params(cfg, dcfg, dev, quantized=True)
    local_mesh, card_mesh = make_mesh(tp=2, devices=[dev, dev]), make_mesh(tp=2, devices=devices[:2])
    kw = dict(language_token_ids=lang_ids, spec_k=4)

    def run(eng):
        """(B=8 rows, B=1 rows, each one's telemetry, B=1 walls in ms, host
        reads per window and rank): the first B=1 window captures, the next
        two are timed."""
        rep = eng.replicas[0]
        syncs = ((lambda: [c["host_syncs"] for c in rep.engine.on_ranks(rank_counters)]) if rep.remote
                 else (lambda: [rep.engine.host_syncs]))
        reads = []

        def window(B):
            h0 = syncs()
            out, _ = eng.transcribe_window(windows[B][0], [lang] * B, 0, n_active=windows[B][1])
            reads.append([b - a for a, b in zip(h0, syncs())])
            return out

        out8 = window(8)
        tel8 = (eng.last_spec_rounds, eng.last_tokens_per_round)
        walls = []
        for _ in range(3):
            sync()
            w0 = time.perf_counter()
            out1 = window(1)
            sync()
            walls.append((time.perf_counter() - w0) * 1e3)
        return out8, out1, tel8, (eng.last_spec_rounds, eng.last_tokens_per_round), walls[1:], reads

    local = SpeculativeEngine(shard_params(pq, local_mesh), cfgq, shard_params(dq, local_mesh), dcfg, st, **kw)
    try:
        want = run(local)
    finally:
        local.close()
    del local
    gc.collect()
    t0 = time.perf_counter()
    sp, sd = shard_params(pq, card_mesh), shard_params(dq, card_mesh)
    make = SpeculativeEngine if cuda else (lambda *a, **k: worker_positions(*a, cls=SpeculativeEngine, **k))
    eng = make(sp, cfgq, sd, dcfg, st, **kw)
    spawn_s = time.perf_counter() - t0
    try:
        w = eng.replicas[0].engine
        if not eng.replicas[0].remote or w.supports_async_window is not False:
            raise AssertionError("speculative tp=2 over the cards: not a synchronous worker engine")
        got = run(eng)
    finally:
        eng.close()
    del eng, sp, sd, pq, dq
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    same = [_same_result(a, b) for a, b in zip(got[0] + got[1], want[0] + want[1])]
    if not all(same) or got[2] != want[2] or got[3] != want[3]:
        raise AssertionError(f"speculative tp=2 over the cards against tp=2 in one process: rows bit for bit {same}, "
                             f"telemetry B=8 {got[2]} vs {want[2]}, B=1 {got[3]} vs {want[3]}")
    if any(r is None for r in want[0][:windows[8][1]] + want[1]):
        raise AssertionError("speculative tp=2: an active bf16 row gave no result")
    # One host read a window and rank (two with the fallback, which the
    # same rows take in both engines).
    if any(n not in (1, 2) for (n,) in want[5]) or any(r != w * 2 for r, w in zip(got[5], want[5])):
        raise AssertionError(f"speculative tp=2 host reads per window: workers {got[5]} (a rank each), one process "
                             f"{want[5]}; want 1, or 2 with a fallback, alike")
    log(f"  speculative tp=2 over {[str(d) for d in card_mesh.devices.flat]} (2 worker processes, one communicator "
        f"for target and draft; spawned in {spawn_s:.1f} s), large-v3 target cut to {cfg.encoder_layers}/"
        f"{cfg.decoder_layers} layers with the serving knobs: B=8 ({windows[8][1]} active) and B=1 rows, rounds and "
        f"tokens per round bit for bit equal to tp=2 in one process (B=8 {got[2]}, B=1 {got[3]}); B=1 walls ms "
        f"workers {[round(x, 1) for x in got[4]]}, one process {[round(x, 1) for x in want[4]]}; host reads per "
        f"window, each rank {got[5]} (one process {want[5]})")
    return dict(spawn_s=spawn_s, telemetry_b8=got[2], telemetry_b1=got[3], b1_walls_workers=got[4],
                b1_walls_one_process=want[4], reads_workers=got[5], reads_one_process=want[5])


def dp_rows_over_cards(cfg, params, st, lang_ids, audio, devices):
    """Phase 19's one row a card, all at once, on a dp mesh over
    ``devices``: replicas in threads of this process (what the mesh
    chooses) against one worker process a card (:func:`worker_positions`),
    in turns threads, processes, processes, threads, twice; then each
    thread replica alone and each worker alone.  Results must be equal bit
    for bit, and the threads at once within 1.25x of their slowest replica
    alone (the replicas run at once)."""
    import numpy as np
    import torch

    from norma_tpu_torch.decode import DecodeEngine
    from norma_tpu_torch.frontend.mel import prepare_audio
    from norma_tpu_torch.parallel import make_mesh, shard_params

    n = len(devices)
    sr, n_win = 16000, 2 * cfg.max_source_positions

    def sync_all():
        for d in devices:
            if torch.device(d).type == "cuda":
                torch.cuda.synchronize(d)

    sp = shard_params(params, make_mesh(dp=n, devices=devices))
    r1 = np.stack([prepare_audio(np.roll(audio, sr * i), n_win) for i in range(n)])
    one_row = [lang_ids[0]] * n
    th = DecodeEngine(sp, cfg, st, language_token_ids=lang_ids, quantize_cross_kv=True)
    pr = worker_positions(sp, cfg, st, language_token_ids=lang_ids, quantize_cross_kv=True)
    try:
        a = th.transcribe_window(r1, one_row, seed=1)[0]
        b = pr.transcribe_window(r1, one_row, seed=1)[0]
        if not all(_same_result(x, y) for x, y in zip(a, b)):
            raise AssertionError("dp over the cards: worker processes and threads gave different results")
        w = {}
        for _ in range(2):
            for who, e in (("threads", th), ("processes", pr), ("processes", pr), ("threads", th)):
                sync_all()
                w0 = time.perf_counter()
                e.transcribe_window(r1, one_row, seed=1)
                sync_all()
                w.setdefault(who, []).append((time.perf_counter() - w0) * 1e3)
        alone, th_alone = [], []
        for rep in pr.replicas:
            w0 = time.perf_counter()
            rep.engine.transcribe_window(r1[:1], one_row[:1], seed=1)
            alone.append((time.perf_counter() - w0) * 1e3)
        for rep in th.replicas:
            sync_all()
            w0 = time.perf_counter()
            rep.submit(rep.engine.transcribe_window, r1[:1], one_row[:1], 1).result()
            sync_all()
            th_alone.append((time.perf_counter() - w0) * 1e3)
    finally:
        th.close()
        pr.close()
    ratio = float(np.median(w["threads"])) / max(th_alone)
    log(f"  dp={n} over {[str(d) for d in devices]}, one row a card, all at once, walls ms in turns: threads "
        f"(one process) {[round(x, 1) for x in w['threads']]}, worker processes {[round(x, 1) for x in w['processes']]}; "
        f"each thread replica alone {[round(x, 1) for x in th_alone]}, each worker alone {[round(x, 1) for x in alone]}; "
        f"threads at once {ratio:.2f}x their slowest alone; results equal bit for bit; "
        f"{smi_line() if torch.device(devices[0]).type == 'cuda' else 'cpu'}")
    if torch.device(devices[0]).type == "cuda" and ratio > 1.25:
        raise AssertionError(f"dp replicas in threads over the cards ran {ratio:.2f}x their slowest alone: "
                             "not at once")
    return dict(walls=w, alone=alone, threads_alone=th_alone, ratio=ratio)


def main(argv=None) -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description="Drive the norma_tpu_torch port on one CUDA card.")
    ap.add_argument("--phases", default="", help="comma-separated phase names to run (default: all); "
                    "a partial run checks those phases and prints no result line")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card only", file=sys.stderr)
        return 1
    # Phase 16's fit runs in torch's deterministic mode, which on the card
    # needs this set before cuBLAS first runs in the process.
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    sys.path.insert(0, ROOT)
    import norma_tpu_torch  # noqa: F401  (fails outside a checkout of the repo)

    # Exact f32 on the card: cuBLAS matmuls and cuDNN convolutions (the
    # encoder's conv stem) both default to TF32 otherwise.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    log(f"chip_smoke: torch {torch.__version__} cuda {torch.version.cuda} on {torch.cuda.get_device_name(0)}")

    rec: dict = {}
    failed = []
    phases = (
        ("build", lambda: phase_build(rec)),
        ("sample_step", lambda: phase_sample_step(rec, dev)),
        ("loop_cond", lambda: phase_loop_cond(rec, dev)),
        ("self_decode", lambda: phase_self_decode(rec, dev)),
        ("golden", lambda: phase_golden(rec, dev)),
        ("slice", lambda: phase_slice(rec, dev)),
        ("cross_decode", lambda: phase_cross_decode(rec, dev)),
        ("flash_encoder", lambda: phase_flash_encoder(rec, dev)),
        ("q8a8", lambda: phase_q8a8(rec, dev)),
        ("serving", lambda: phase_serving(rec, dev)),
        # Phase 18 profiles phase 9's engine and frees it before phase 10,
        # so the later phases' memory peaks do not hold it.
        ("device_report", lambda: phase_device_report(rec, dev)),
        ("w4_matmul", lambda: phase_w4(rec, dev)),
        ("w8_matmul", lambda: phase_w8(rec, dev)),
        ("log_mel", lambda: phase_log_mel(rec, dev)),
        ("definition", lambda: phase_definition(rec, dev)),
        ("speculative", lambda: phase_speculative(rec, dev)),
        ("microphone", lambda: phase_microphone(rec, dev)),
        ("accuracy", lambda: phase_accuracy(rec, dev)),
        ("soak", lambda: phase_soak(rec, dev)),
        ("mesh", lambda: phase_mesh(rec, dev)),
        ("tp", lambda: phase_tp(rec, dev)),
        ("tp_cards", lambda: phase_tp_cards(rec, dev)),
    )
    only = [x for x in args.phases.split(",") if x]
    unknown = set(only) - {name for name, _ in phases}
    if unknown:
        print(f"chip_smoke: unknown phases {sorted(unknown)}", file=sys.stderr)
        return 2
    t_all = time.perf_counter()
    for name, fn in phases:
        if only and name not in only and name != "build":
            continue
        if failed and failed[0] == "build":
            break
        t0 = time.perf_counter()
        try:
            fn()
        except Exception:
            failed.append(name)
            log(f"phase {name}: FAILED")
            traceback.print_exc()
        log(f"  ({name}: {time.perf_counter() - t0:.1f} s)")
    log(f"chip_smoke: {time.perf_counter() - t_all:.1f} s in all")
    if failed:
        print(f"chip_smoke: failed phases {failed}", file=sys.stderr)
        return 1
    if only:
        print(f"chip_smoke: phases {only} passed (partial run: no result line)", file=sys.stderr)
        return 0

    kernels = [
        dict(name="sample_step", route="cuda", source="norma_tpu_torch/csrc/sample_step.cu",
             replaces="norma_tpu/ops/sample_step.py:252", **rec["sample_step"]),
        dict(name="self_decode", route="cuda", source="norma_tpu_torch/csrc/self_decode.cu",
             replaces="norma_tpu/ops/self_decode.py:103", **rec["self_decode"]),
        dict(name="cross_decode", route="cuda", source="norma_tpu_torch/csrc/cross_decode.cu",
             replaces="norma_tpu/ops/paged_cross.py:198", **rec["cross_decode"]),
        dict(name="flash_encoder", route="cuda", source="norma_tpu_torch/csrc/flash_encoder.cu",
             replaces="norma_tpu/ops/flash_encoder.py:66", **rec["flash_encoder"]),
        dict(name="q8a8", route="cuda", source="norma_tpu_torch/csrc/q8a8.cu",
             replaces="norma_tpu/ops/quant_matmul.py:145", **rec["q8a8"]),
        dict(name="w4_matmul", route="cuda", source="norma_tpu_torch/csrc/w4_matmul.cu",
             replaces="norma_tpu/ops/quant_matmul.py:309", **rec["w4_matmul"]),
        dict(name="w8_matmul", route="cuda", source="norma_tpu_torch/csrc/w8_matmul.cu",
             replaces="norma_tpu/ops/quant_matmul.py:51", **rec["w8_matmul"]),
        dict(name="log_mel", route="cuda", source="norma_tpu_torch/csrc/log_mel.cu",
             replaces="norma_tpu/ops/mel_pallas.py:88", **rec["log_mel"]),
        dict(name="philox_uniform", route="cuda", source="norma_tpu_torch/csrc/sample_step.cu",
             replaces="tools/verify_sample_kernel_tpu.py:120", **rec["philox_uniform"]),
        dict(name="loop_cond", route="cuda", source="norma_tpu_torch/csrc/loop_cond.cu",
             replaces="norma_tpu/decode/engine.py:459", **rec["loop_cond"]),
    ]
    served = rec["serving"]["launches"]
    for k, fn in zip(kernels[2:], ("cross_attention_q8_kernel_stacked", "flash_self_attention", "q8a8_dense")):
        k["launches"] = served[fn]
    keys = ("launches", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    for k in kernels:  # the contract's key order
        k.update({key: k.pop(key) for key in keys})
    prof = rec.get("profile", {})
    log("device-only ms per launch (torch.profiler; phase 9's B=8 window, phases 10 and 12): " + "; ".join(
        f"{k['name']}: {'not measured' if prof.get(k['name']) is None else format(prof[k['name']]['ms_per_launch'], '.4f')}"
        f"{tries_text(prof.get(k['name']))}"
        for k in kernels))
    print(json.dumps({"kernels": kernels}))
    print(rec["smi"])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
