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
     step-0 and per-row-step rows; t>0 mask support and exact replay from
     the kernel's own Philox uniforms; uniformity of those uniforms,
     per-row independence); times at 6 and 8 rows host-launched and from
     CUDA graphs, by cluster size against the plan's, and the Philox probe
     (philox_uniform) with its bound;
  3. self_decode kernel vs its plain version at distil-large-v3 widths
     (f32 and bf16, bucket views, in-place row write; every position of a
     128-row crop at rows 1 and 6, host and device positions; the served
     bf16 8 rows at crops 128/256/448, pos 3/127/255/300/447); device ms
     from CUDA graphs over cold caches at those fills beside SDPA over the
     same rows, and by cluster size against the plan's (each size's output
     checked);
  4. the golden config (tests/golden/engine_small.json) on the card,
     through the graph loop and the per-step eager loop alike;
  5. the single-stream slice: distil-large-v3 at mtp=448, buckets
     (128, 256), self_kv_impl="kernel", f32, seeded random weights:
     WhisperModel over 30 s of audio in three chunks (constant language,
     then detect mode) and a padded B=8 window.  Both kernels' launch
     counters must move.  Then the token loop's CUDA graphs against the
     per-step eager loop (``DecodeEngine._token_loop_eager``) on a B=1 and
     the B=8 window (tokens equal; walls, medians, host syncs), warm B=1
     walls at chunk lengths 8/16/32, and the B=1 idle share under
     torch.profiler, graph and eager;
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
     and at B=8 (5 active), the B=8 window graph against eager (tokens
     equal) with its idle share, and one eager B=8 window profiled;
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
     package), then kernel vs log_mel_dft and vs frontend/mel.py at B 1/8,
     80 and 128 mels;
 13. the public entry point at full width: a distil-large-v3-shaped
     checkpoint (config.json, a WordLevel tokenizer.json, BF16
     model.safetensors of seeded random weights) written to a temporary
     directory, monolingual.Definition(quantize_decoder, int4 head,
     quantize_encoder, quantize_cross_kv, jax_flash / kernel / kernel) ->
     Transcriber.blocking_spawn streaming >= 35 s of real-time synthetic
     audio, stop(), close(), join(): no audio dropped, no error, and the
     seven on-path kernels' counters (sample_step, self_decode,
     cross_decode, flash_encoder, q8a8, w8, w4) all move; the first
     window again, graph against eager (tokens equal); then one window
     of multilingual.Definition in detect mode with quantize_self_kv and
     the int4 head (the self-decode kernel stays off on the int8 cache).

Then one JSON line with each kernel's launches, error and times, the
card's ``nvidia-smi`` name/power-limit line, and last
``{"ok": true, "device": {...}}``.  Each kernel's ``launches`` is the count
from the path that runs it, its counters set to 0 just before: phase 5
(sample_step, self_decode), phase 9 (cross_decode, flash_encoder, q8a8),
phase 13 (w4_matmul, w8_matmul) and, for the log-mel kernel that no
serving path runs, phase 12's own batch.
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
PEAK_OPS = {"bf16": 989e12, "int8": 1979e12, "f32": 67e12}


def bound(nbytes: float, ops: float = 0.0, kind: str = "bf16"):
    """(bound_ms, bound_by): the least time for ``nbytes`` of HBM traffic
    (each input read once, each output written once) and ``ops``
    operations of ``kind`` on the card, whichever is larger."""
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, ops / PEAK_OPS[kind] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


# Each kernel's CUDA function names (substrings of the profiler's names).
KERNEL_FUNCS = {
    "sample_step": ("sample_step_kernel",), "self_decode": ("self_decode_kernel",),
    "cross_decode": ("cross_decode_kernel",), "flash_encoder": ("flash_encoder",),
    "q8a8": ("q8a8_wgmma_kernel",), "w8_matmul": ("w8_mma_kernel",),
    "w4_matmul": ("w4_mma_kernel",), "log_mel": ("log_mel_kernel",),
}


def device_profile(fn, names):
    """Run ``fn`` once under torch.profiler; per kernel of ``names``:
    device-only ms per launch of its main function, launches, and device ms
    in all (its split-sum pass included).  None where the profiler shows no
    device time ("not measured")."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = {}
    events = [(e.key, e.count, getattr(e, "self_device_time_total", 0.0) or 0.0) for e in prof.key_averages()]
    for name in names:
        funcs = KERNEL_FUNCS[name]
        main = [(c, us) for k, c, us in events if funcs[0] in k and us > 0]
        rest = [us for k, c, us in events if any(f in k for f in funcs[1:]) and us > 0]
        if not main:
            out[name] = None
            continue
        n = sum(c for c, _ in main)
        total = sum(us for _, us in main)
        out[name] = dict(launches=n, ms_per_launch=total / n / 1e3, ms_total=(total + sum(rest)) / 1e3)
    return out


def profile_text(prof) -> str:
    return "; ".join(
        f"{k}: not measured" if v is None else
        f"{k}: {v['ms_per_launch']:.4f} ms x {v['launches']} ({v['ms_total']:.1f} ms)"
        for k, v in prof.items()
    )


def idle_share(fn):
    """Run ``fn`` once under torch.profiler: (wall ms, device-busy ms, idle
    share, kernels seen).  Busy is the sum of the CUDA kernels', copies'
    and fills' device time; the idle share is 1 - busy / wall."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy = sum(e.device_time_total for e in dev) / 1e3
    return wall, busy, 1.0 - busy / wall, len(dev)


def window_modes(engine, audio, langs, seed, n_active=None):
    """The same window through the graph loop and through the per-step
    eager loop (``_token_loop_eager``: a host read before every step, no
    graphs), in turns graph, eager, eager, graph.  Tokens must be equal;
    returns per mode the walls (ms, host clock after a sync), their median,
    host syncs and steps per window."""
    import numpy as np
    import torch

    res, tokens = {"graph": [], "eager": []}, []
    for mode in ("graph", "eager", "eager", "graph"):
        if mode == "eager":
            engine._token_loop = engine._token_loop_eager
        try:
            torch.cuda.synchronize()
            h0, s0, t0 = engine.host_syncs, engine.decode_steps, time.perf_counter()
            drs, _ = engine.transcribe_window(audio, langs, seed, n_active)
            torch.cuda.synchronize()
            res[mode].append(((time.perf_counter() - t0) * 1e3, engine.host_syncs - h0, engine.decode_steps - s0))
            tokens.append([d and d.tokens for d in drs])
        finally:
            engine.__dict__.pop("_token_loop", None)
    if any(tk != tokens[0] for tk in tokens):
        raise AssertionError("graph-loop tokens differ from the per-step loop's")
    return {k: dict(ms=[r[0] for r in v], median_ms=float(np.median([r[0] for r in v])), syncs=v[0][1],
                    steps=v[0][2]) for k, v in res.items()}


def modes_text(res) -> str:
    return "; ".join(f"{k} {[round(x, 1) for x in v['ms']]} ms (median {v['median_ms']:.1f}), {v['syncs']} syncs, "
                     f"{v['steps']} steps" for k, v in res.items())


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
    if replay_ok != replay_n:
        raise AssertionError(f"Philox replay agreed on {replay_ok}/{replay_n} draws")
    masks = _v3_masks(dev)
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
    pu_ms = cuda_ms(lambda: ss.philox_uniform(7, 3, 6, V3, dev))
    pu_bound, pu_by = bound(6 * V3 * 4)
    t6 = times[6]
    rec["sample_step"] = dict(max_abs_err=max_err, ms=t6["ms"], plain_ms=t6["plain_ms"], bound_ms=t6["bound_ms"],
                              bound_by=t6["bound_by"], library_ms=None)
    rec["sample_step_detail"] = dict(times=times, philox_uniform=dict(ms=pu_ms, bound_ms=pu_bound, bound_by=pu_by))
    tt = "; ".join(
        f"{B} rows: host-launched {v['ms']:.4f} ms vs plain {v['plain_ms']:.4f} ms, CUDA graph {v['graph_ms']:.4f} "
        f"ms (greedy {v['graph_greedy_ms']:.4f}), bound {v['bound_ms']:.4f} ms ({v['bound_by']}); by cluster "
        f"size (plan {v['cluster']}): " + ", ".join(f"{c}: {ms:.4f}" for c, ms in v["cluster_ms"].items())
        for B, v in times.items())
    log(f"phase 2 sample_step: ok greedy exact at rows {list(SS_ROWS)} x V={V3} and 8 x V={SS_ODD_V} (NaN, "
        f"all-masked, step 0, per-row steps), max_abs_err(prob)={max_err:.3g}; t>0 {draws} draws in support, "
        f"Philox replay {replay_ok}/{replay_n}; u min={umin:.5f} max={umax:.5f} mean={umean:.5f}; {tt}; "
        f"philox_uniform 6 x {V3}: {pu_ms:.4f} ms (bound {pu_bound:.4f} ms, {pu_by})")


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
    got = {}
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
        dr = engine.run_loop(engine.prefill(engine.encode(mel), 50259), 0.0, seed=0)[0]
        # The same window through the per-step eager loop (no graphs).
        engine._token_loop = engine._token_loop_eager
        try:
            dr_eager = engine.run_loop(engine.prefill(engine.encode(mel), 50259), 0.0, seed=0)[0]
        finally:
            engine.__dict__.pop("_token_loop", None)
        if dr_eager.tokens != dr.tokens:
            raise AssertionError(f"golden {kind}: graph-loop tokens differ from the per-step loop's")
        got[kind] = dr.tokens == golden["windows"][kind]["tokens"]
        if not got[kind]:
            want = golden["windows"][kind]["tokens"]
            first = next((i for i, (a, b) in enumerate(zip(dr.tokens, want)) if a != b), min(len(dr.tokens), len(want)))
            log(f"  golden {kind}: first difference at token {first} of {len(want)}")
    if not all(got.values()):
        raise AssertionError(f"golden windows differ: {got}")
    log("phase 4 golden: ok windows tone/noise/mix token-exact vs tests/golden/engine_small.json, through "
        "the graph loop and the per-step eager loop alike")


def phase_slice(rec, dev):
    import numpy as np
    import torch

    from norma_tpu_torch.decode import DecodeEngine, LanguageState, SpecialTokens
    from norma_tpu_torch.frontend.mel import log_mel_spectrogram, prepare_audio
    from norma_tpu_torch.model import PRESETS, init_params
    from norma_tpu_torch.model.whisper import cross_kv, decoder_prefill, decoder_step
    from norma_tpu_torch.models.whisper import WhisperModel
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
    launches = {"sample_step": ss.sample_step.launches, "self_decode": sd.self_attention_decode.launches}
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
    rec["sample_step"]["launches"] = launches["sample_step"]
    rec["self_decode"]["launches"] = launches["self_decode"]

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
    # The graph loop against the per-step eager loop on the same windows
    # (f32: tokens equal), then the chunk length: one warm B=1 window at
    # k = 8, 16, 32 (each k's graphs captured by a window before), and the
    # device's idle share under torch.profiler, graph and eager.
    one = torch.from_numpy(batch[:1])
    lang1 = [LANG_IDS_V3[0]]
    modes_b1 = window_modes(engine, one, lang1, 5)
    modes_b8 = window_modes(engine, torch.from_numpy(batch), lang1 * 8, 11, n_active=5)
    chunk_ms, k0 = {}, engine._loop_chunk
    for k in (8, 16, 32):
        engine._loop_chunk = k
        engine.transcribe_window(one, lang1, 5)
        walls = []
        for _ in range(2):
            torch.cuda.synchronize()
            w0 = time.perf_counter()
            engine.transcribe_window(one, lang1, 5)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - w0) * 1e3)
        chunk_ms[k] = walls
    engine._loop_chunk = k0
    idle = {"graph": idle_share(lambda: engine.transcribe_window(one, lang1, 5))}
    engine._token_loop = engine._token_loop_eager
    try:
        idle["eager"] = idle_share(lambda: engine.transcribe_window(one, lang1, 5))
    finally:
        engine.__dict__.pop("_token_loop", None)
    rec["slice"] = dict(windows_b1=b1, window_b8=b8, peak_bytes=peak, launches=launches, step_logit_err=step_err,
                        modes_b1=modes_b1, modes_b8=modes_b8, chunk_ms=chunk_ms, idle_b1=idle)
    ms_b1 = [round(w["ms"], 1) for w in b1]
    log(f"phase 5 slice: ok distil-large-v3 mtp=448 buckets=(128,256) kernel f32; "
        f"B=1 windows={len(b1)} wall_ms={ms_b1} steps={[w['steps'] for w in b1]} "
        f"host_syncs={[w['syncs'] for w in b1]}; B=8 (n_active=5, sequential ladder) wall_ms={b8[0]['ms']:.1f} "
        f"steps={b8[0]['steps']} host_syncs={b8[0]['syncs']}; peak_mem={peak / 2**30:.2f} GiB; "
        f"launches={launches}; kernel-vs-plain step logit err={step_err:.3g}; "
        f"texts const={[len(x) for x in texts['const']]} detect={[len(x) for x in texts['detect']]} chars")
    log(f"  slice B=1 window, graph vs per-step eager loop (tokens equal): {modes_text(modes_b1)}")
    log(f"  slice B=8 window (n_active=5), graph vs eager (tokens equal): {modes_text(modes_b8)}")
    log(f"  slice chunk length (warm B=1 window walls, ms): " + "; ".join(
        f"k={k}: {[round(x, 1) for x in v]}" for k, v in chunk_ms.items()))
    log(f"  slice B=1 idle share under torch.profiler: " + "; ".join(
        f"{m}: wall {v[0]:.1f} ms, device busy {v[1]:.1f} ms, idle {v[2]:.1%} ({v[3]} device events)"
        for m, v in idle.items()))


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


def serve_streams(model, n_streams, seconds, timeout=600.0):
    """Serve ``n_streams`` concurrent synthetic streams, fed in lockstep
    (LockstepFeed), through a BatchedTranscriber(max_streams=8) after
    warmup().  Returns a report:
    per-round records, rounds per stream, texts, metrics, drop accounting,
    launch counts."""
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
    bt = batching.BatchedTranscriber(model, max_streams=8)
    t0 = time.perf_counter()
    bt.warmup()
    warm_s = time.perf_counter() - t0

    rounds, pad_bad = [], []
    inner_async, inner_fetch = engine.transcribe_window_async, engine.transcribe_window_fetch

    def timed_async(audio, langs, seed, n_active=None):
        sync()
        s0, h0, w0 = engine.decode_steps, engine.host_syncs, time.perf_counter()
        out = inner_async(audio, langs, seed, n_active)
        sync()
        rounds.append(dict(B=int(audio.shape[0]), n_active=n_active, ms=(time.perf_counter() - w0) * 1e3,
                           steps=engine.decode_steps - s0, syncs=engine.host_syncs - h0))
        return out

    def checked_fetch(pending):
        drs, info = inner_fetch(pending)
        active = pending[1]
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

    def try_send(self, data, length, final=None):
        before = self.dropped
        ok = orig_send(self, data, length, final)
        if self.dropped != before:
            dropped[id(self)] = dropped.get(id(self), 0) + length
        return ok

    def apply_result(self, dr, final_chunk):
        applied[id(self)] = applied.get(id(self), 0) + 1
        return orig_apply(self, dr, final_chunk)

    counters = (sample_step.sample_step, self_decode.self_attention_decode,
                paged_cross.cross_attention_q8_kernel_stacked, flash_encoder.flash_self_attention,
                quant_matmul.q8a8_dense, quant_matmul.w8_matmul)
    engine.transcribe_window_async, engine.transcribe_window_fetch = timed_async, checked_fetch
    LongFormDecoder.feed, RecycledRing.try_send, LongFormDecoder.apply_result = feed, try_send, apply_result
    sr = 16000
    durations = [seconds[0] + (seconds[1] - seconds[0]) * i / max(n_streams - 1, 1) for i in range(n_streams)]
    src = LockstepFeed(durations, sr, bt._lock)
    try:
        # ---- the main path: counts from zero ----
        for c in counters:
            c.launches = 0
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
        peak = torch.cuda.max_memory_allocated(engine.device) if cuda else 0
        # ---- end of the main path ----
        metrics = bt.metrics()
    finally:
        engine.transcribe_window_async, engine.transcribe_window_fetch = inner_async, inner_fetch
        LongFormDecoder.feed, RecycledRing.try_send, LongFormDecoder.apply_result = orig_feed, orig_send, orig_apply
        bt.close()
        src.close()
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
                launches=launches, peak=peak, wall_s=wall_s, warm_s=warm_s, accounting=accounting,
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
    prof, modes, idle = {}, {}, {}
    if cuda:
        rows_t = torch.from_numpy(rows).to(dev)
        modes = window_modes(engine, rows_t, [lang_ids[0]] * 8, 1)
        idle["graph"] = idle_share(lambda: engine.transcribe_window(rows_t, [lang_ids[0]] * 8, seed=1))
        engine._token_loop = engine._token_loop_eager
        try:
            idle["eager"] = idle_share(lambda: engine.transcribe_window(rows_t, [lang_ids[0]] * 8, seed=1))
            prof = device_profile(
                lambda: engine.transcribe_window(rows_t, [lang_ids[0]] * 8, seed=1),
                ["sample_step", "self_decode", "cross_decode", "flash_encoder", "q8a8", "w8_matmul"],
            )
        finally:
            engine.__dict__.pop("_token_loop", None)
        rec.setdefault("profile", {}).update(prof)
    b8 = [r["ms"] for r in rep["rounds"] if r["B"] == 8]
    b8_ms = dict(n=len(b8), median=float(np.median(b8)), min=min(b8), max=max(b8)) if b8 else None
    rec["serving"].update(int4_ms=int4_ms, int4_steps=int4_steps, int4_launches=int4_launches,
                          step_b1=step_b1, step_b8=step_b8, encode_b8_ms=enc_ms, round_b8_ms=b8_ms,
                          direct_b8_ms=direct_ms, modes_b8=modes, idle_b8=idle)
    chars = [len("".join(rep["texts"][i])) for i in range(n_streams)]
    b8_txt = (f"B=8 rounds n={b8_ms['n']} median {b8_ms['median']:.1f} ms (min {b8_ms['min']:.1f}, "
              f"max {b8_ms['max']:.1f}); direct B=8 windows {[round(x, 1) for x in direct_ms]} ms"
              if b8_ms else "no B=8 round")
    log(f"phase 9 serving: ok d_model={cfg.d_model} enc={cfg.encoder_layers} dec={cfg.decoder_layers} bf16 "
        f"w8a8/int8 + int8 cross-K/V kernel layout, BatchedTranscriber(max_streams=8) warmup "
        f"{rep['warm_s']:.1f} s; {n_streams} streams {seconds[0]:g}-{seconds[1]:g} s fed at {FEED_SPEED:g}x real time "
        f"served in {rep['wall_s']:.1f} s over {len(rep['rounds'])} rounds ({b8_txt}); rounds per stream "
        f"{rep['stream_rounds']}; no audio or transcript drops; every receiver closed; "
        f"peak_mem={rep['peak'] / 2**30:.2f} GiB; launches={rep['launches']}; text chars={chars}; "
        f"int4 B=1 window(s) {int4_ms:.1f} ms, {int4_steps} steps, {int4_launches} cross launches, "
        f"{len(text4)} chars; B=8 encode {enc_ms:.1f} ms; profiled B=8 window: {profile_text(prof)}; "
        f"bf16 step kernel-vs-plain logit err "
        f"B=1 {step_b1[0]:.3g} (|z| <= {step_b1[1]:.3g}), B=8 n_active=5 {step_b8[0]:.3g} "
        f"(|z| <= {step_b8[1]:.3g})")
    if cuda:
        log(f"  serving B=8 window, graph vs per-step eager loop (tokens equal): {modes_text(modes)}")
        log(f"  serving B=8 idle share under torch.profiler: " + "; ".join(
            f"{m}: wall {v[0]:.1f} ms, device busy {v[1]:.1f} ms, idle {v[2]:.1%} ({v[3]} device events)"
            for m, v in idle.items()))


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
    prof = device_profile(lambda: [qm.w4_matmul(x6, q4, s4) for _ in range(20)], ["w4_matmul"])
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
    # f32 algorithms of this transform (tests/test_mel_pallas.py): exact f32
    # both, other summation orders, magnified by log10 in low-power bins.
    worst, n_cases = {"dft": 0.0, "rfft": 0.0}, 0
    for n_mels in (80, 128):
        for B in (1, 8):
            ko = mels[n_mels][:B] if B == 8 else mp.log_mel_pallas(batch[:1], n_mels=n_mels)
            po = mp.log_mel_dft(batch[:B], n_mels=n_mels)
            ro = log_mel_spectrogram(
                torch.from_numpy(np.stack([prepare_audio(a) for a in raw[:B]])).to(dev), n_mels=n_mels
            )
            torch.cuda.synchronize()
            if ko.shape != (B, n_mels, 3000) or not torch.isfinite(ko).all():
                raise AssertionError(f"log_mel B={B} mels={n_mels}: bad output")
            for name, ref in (("dft", po), ("rfft", ro)):
                err = float((ko - ref).abs().max())
                if not err <= 5e-4:
                    raise AssertionError(f"log_mel B={B} mels={n_mels} vs {name}: err {err}")
                worst[name] = max(worst[name], err)
            n_cases += 1
    k_ms, p_ms = turns(lambda: mp.log_mel_dft(batch, n_mels=128), lambda: mp.log_mel_pallas(batch, n_mels=128))
    b1 = batch[:1].contiguous()
    k1_ms, p1_ms = turns(lambda: mp.log_mel_dft(b1, n_mels=128), lambda: mp.log_mel_pallas(b1, n_mels=128))
    rfft_ms = cuda_ms(lambda: log_mel_spectrogram(batch[:, : (3000 - 1) * 160 + 400], n_mels=128))
    # Bound: the Hann-folded DFT (cos and sin, 400 x 201) and the mel
    # projection as exact f32 operations on the CUDA cores, against the PCM
    # in, the matrices and the [8, 128, 3000] output.
    B8, n_fft, n_freq, frames = batch.shape[0], 400, 201, 3000
    ops = B8 * frames * (2 * n_fft * n_freq * 2 + n_freq * 128 * 2)
    b_ms, b_by = bound(nbytes(batch) + 4 * (2 * n_fft * n_freq + n_freq * 128) + 4 * B8 * 128 * frames, ops, "f32")
    prof = device_profile(lambda: [mp.log_mel_pallas(batch, n_mels=128) for _ in range(5)], ["log_mel"])
    rec.setdefault("profile", {}).update(prof)
    rec["log_mel"] = dict(launches=launches, max_abs_err=worst["dft"], ms=k_ms, plain_ms=p_ms, bound_ms=b_ms,
                          bound_by=b_by, library_ms=None)
    rec["log_mel_detail"] = dict(err_vs_rfft=worst["rfft"], b1_ms=k1_ms, b1_plain_ms=p1_ms, rfft_b8_ms=rfft_ms)
    log(f"phase 12 log_mel: ok path B=8 x 30 s at 80 and 128 mels ({launches} launches); {n_cases} cases "
        f"(B 1/8, 80/128 mels): max err vs log_mel_dft {worst['dft']:.3g}, vs frontend/mel.py rFFT "
        f"{worst['rfft']:.3g}; B=8 128 mels: kernel {k_ms:.3f} ms vs plain {p_ms:.3f} ms (rFFT frontend "
        f"{rfft_ms:.3f} ms); B=1: kernel {k1_ms:.3f} ms vs plain {p1_ms:.3f} ms; B=8 bound {b_ms:.4f} ms ({b_by}); "
        f"profiler {profile_text(prof)}")


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
    from norma_tpu_torch.ops import flash_encoder, paged_cross, quant_matmul, sample_step, self_decode

    cuda = torch.device(dev).type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    device = SelectedDevice.cuda() if cuda else SelectedDevice.cpu()
    dtype = dtype or torch.bfloat16
    counters = {"sample_step": sample_step.sample_step, "self_decode": self_decode.self_attention_decode,
                "cross_decode": paged_cross.cross_attention_q8_kernel_stacked,
                "flash_encoder": flash_encoder.flash_self_attention, "q8a8": quant_matmul.q8a8_dense,
                "w8_matmul": quant_matmul.w8_matmul, "w4_matmul": quant_matmul.w4_matmul}
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
        ("self_decode", lambda: phase_self_decode(rec, dev)),
        ("golden", lambda: phase_golden(rec, dev)),
        ("slice", lambda: phase_slice(rec, dev)),
        ("cross_decode", lambda: phase_cross_decode(rec, dev)),
        ("flash_encoder", lambda: phase_flash_encoder(rec, dev)),
        ("q8a8", lambda: phase_q8a8(rec, dev)),
        ("serving", lambda: phase_serving(rec, dev)),
        ("w4_matmul", lambda: phase_w4(rec, dev)),
        ("w8_matmul", lambda: phase_w8(rec, dev)),
        ("log_mel", lambda: phase_log_mel(rec, dev)),
        ("definition", lambda: phase_definition(rec, dev)),
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
        for k in kernels))
    print(json.dumps({"kernels": kernels}))
    print(rec["smi"])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
