#!/usr/bin/env python3
"""Drive the norma_tpu_torch port once on one CUDA card, end to end.

    python3 chip_smoke.py

Needs one CUDA card, nvcc and this repository's sources; it exits non-zero
(and prints no result line) without them.  Phases, one line each:

  1. build: compile csrc/*.cu with nvcc, one process per source
     (ops/_build.py); print the nvcc version, build seconds, ptxas' resource
     lines and the card's name and power limit;
  2. sample_step kernel vs its plain PyTorch version at V=51866 (greedy
     exactness, t>0 mask support and exact replay from the kernel's own
     Philox uniforms, uniformity of those uniforms, per-row independence);
  3. self_decode kernel vs its plain version at distil-large-v3 widths
     (f32 and bf16, bucket views, in-place row write);
  4. the golden config (tests/golden/engine_small.json) on the card;
  5. the single-stream slice: distil-large-v3 at mtp=448, buckets
     (128, 256), self_kv_impl="kernel", f32, seeded random weights:
     WhisperModel over 30 s of audio in three chunks (constant language,
     then detect mode) and a padded B=8 window.  Both kernels' launch
     counters must move;
  6. cross_decode kernel vs its plain version (int8 and int4, G 1/6,
     B 1/8/48, stacked layers 0/1 and the per-layer form);
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
     active, and every one of the five kernels' launch counters must move
     during the served rounds.  Then one B=1 window with int4 cross-K/V,
     and a full-width decoder_step through the kernel routes against the
     plain routes on the prefill of the engine's padded window, at B=1 and
     at B=8 (5 active).

Then one JSON line with each kernel's launches, error and times, the
card's ``nvidia-smi`` name/power-limit line, and last
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
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


# --------------------------------------------------------------------------


def phase_build(rec):
    from norma_tpu_torch.ops import _build

    _build.lib()
    info = _build.build_info
    ptx = [ln.strip() for ln in info.get("ptxas", "").splitlines() if "registers" in ln or "spill" in ln]
    log(f"phase 1 build: ok nvcc='{info.get('nvcc')}' seconds={info.get('seconds', 0.0):.1f}")
    for ln in ptx:
        log(f"  ptxas {ln}")
    rec["nvcc"] = info.get("nvcc")
    rec["smi"] = smi_line()
    log(f"  card {rec['smi']}")


def _v3_masks(dev):
    import torch

    from norma_tpu_torch.decode.masks import SpecialTokens, build_masks
    from norma_tpu_torch.model.config import PRESETS

    m = build_masks(V3, PRESETS["distil-large-v3"].suppress_tokens, SpecialTokens(**ST_V3))
    return tuple(torch.from_numpy(a).to(dev) for a in (m.suppress, m.non_timestamps, m.timestamps, m.first_token))


def phase_sample_step(rec, dev):
    import numpy as np
    import torch

    from norma_tpu_torch.ops import sample_step as ss

    masks = _v3_masks(dev)
    eot, nts = ST_V3["eot"], ST_V3["no_timestamps"]
    g = torch.Generator(device=dev).manual_seed(0)
    i32 = lambda x, B: torch.full((B,), x, dtype=torch.int32, device=dev) if np.isscalar(x) else torch.as_tensor(x, dtype=torch.int32, device=dev)
    max_err = 0.0

    def case_inputs(B, p1, p2, lts):
        ll = torch.randn((B, V3), generator=g, device=dev) * 2.0
        return ll, i32(p1, B), i32(p2, B), i32(lts, B)

    cases = [  # (p1, p2, last_ts, step)
        (ST_V3["task"], ST_V3["sot"], 0, 0),
        (ST_V3["zero_sec"] + 1, 100, 0, 1),
        (ST_V3["zero_sec"] + 2, ST_V3["sot"], 0, 2),
        (100, 101, 0, 3),
        (100, ST_V3["zero_sec"] + 3, ST_V3["zero_sec"] + 3, 4),
        (V3 - 1, 100, V3 - 1, 5),  # grammar deadlock
    ]
    for B in (6, 48):
        for p1, p2, lts, step in cases:
            ll, tp1, tp2, tlts = case_inputs(B, p1, p2, lts)
            ll[0] = float("nan")  # a NaN row
            ll[1, 7] = float("nan")  # one NaN poisons the row
            temp = torch.zeros(B, device=dev)
            args = (ll, *masks, tp1, tp2, tlts, step, temp)
            kn, kp, kd = ss.sample_step(*args, eot=eot, no_timestamps=nts)
            pn, pp, pd = ss.sample_step_torch(*args, eot=eot, no_timestamps=nts, greedy_only=True)
            if not (torch.equal(kn, pn) and torch.equal(kd, pd)):
                raise AssertionError(f"greedy mismatch B={B} case={(p1, p2, lts, step)}")
            torch.testing.assert_close(kp, pp, rtol=1e-5, atol=0.0, equal_nan=True)
            fin = torch.isfinite(pp)
            if fin.any():
                max_err = max(max_err, float((kp[fin] - pp[fin]).abs().max()))
        # Per-row steps: row 0 at the first-token grammar.
        ll, tp1, tp2, tlts = case_inputs(B, 100, 101, 0)
        steps = torch.arange(B, dtype=torch.int32, device=dev) % 3
        args = (ll, *masks, tp1, tp2, tlts, steps, torch.zeros(B, device=dev))
        kn, kp, kd = ss.sample_step(*args, eot=eot, no_timestamps=nts)
        pn, pp, pd = ss.sample_step_torch(*args, eot=eot, no_timestamps=nts, greedy_only=True)
        if not (torch.equal(kn, pn) and torch.equal(kd, pd)):
            raise AssertionError(f"per-row-step greedy mismatch B={B}")
        torch.testing.assert_close(kp, pp, rtol=1e-5, atol=0.0)

    # t>0: >= 2000 draws never pick a masked token; replaying the kernel's
    # Philox uniforms through the plain version gives the same tokens.
    draws = replay_ok = replay_n = 0
    for step in range(1, 51):
        B = 48
        ll, tp1, tp2, tlts = case_inputs(B, 100, 101, 0)
        temp = torch.tensor([0.2, 0.6, 1.0] * 16, device=dev)
        seed = 1234 + (step << 32)
        kn, kp, kd = ss.sample_step(ll, *masks, tp1, tp2, tlts, step, temp, eot=eot, no_timestamps=nts, seed=seed)
        if not torch.isfinite(kp).all() or kd.any():
            raise AssertionError(f"t>0 draw chose a masked token at step {step}")
        draws += B
        u = ss.philox_uniform(seed, step, B, V3, dev)
        pn, _, _ = ss.sample_step_torch(ll, *masks, tp1, tp2, tlts, step, temp, eot=eot, no_timestamps=nts, u=u)
        replay_ok += int((pn == kn).sum())
        replay_n += B
    if replay_ok != replay_n:
        raise AssertionError(f"Philox replay agreed on {replay_ok}/{replay_n} draws")
    u = ss.philox_uniform(99, 7, 64, 512, dev)
    umin, umax, umean = float(u.min()), float(u.max()), float(u.mean())
    if not (0.0 <= umin < 0.02 and 0.98 < umax < 1.0 and abs(umean - 0.5) < 0.02):
        raise AssertionError(f"Philox uniforms off: min={umin} max={umax} mean={umean}")
    row = torch.randn((1, V3), generator=g, device=dev).repeat(8, 1)
    kn, _, _ = ss.sample_step(row, *masks, i32(100, 8), i32(101, 8), i32(0, 8), 3,
                              torch.ones(8, device=dev), eot=eot, no_timestamps=nts, seed=5)
    if len(set(kn.tolist())) < 2:
        raise AssertionError("rows with equal inputs drew the same token")

    # Time at the slice's shape: B=1 speculative ladder = 6 rows, t = 0..1.
    B = 6
    ll, tp1, tp2, tlts = case_inputs(B, 100, 101, 0)
    temp = torch.tensor([0.0, 0.2, 0.4, 0.6, 0.8, 1.0], device=dev)
    args = (ll, *masks, tp1, tp2, tlts, 3, temp)
    k_ms, p_ms = turns(
        lambda: ss.sample_step_torch(*args, eot=eot, no_timestamps=nts),
        lambda: ss.sample_step(*args, eot=eot, no_timestamps=nts, seed=1),
    )
    rec["sample_step"] = dict(max_abs_err=max_err, ms=k_ms, plain_ms=p_ms)
    log(f"phase 2 sample_step: ok greedy exact at rows 6,48 (NaN, all-masked, step 0, per-row steps), "
        f"max_abs_err(prob)={max_err:.3g}; t>0 {draws} draws in support, Philox replay {replay_ok}/{replay_n}; "
        f"u min={umin:.5f} max={umax:.5f} mean={umean:.5f}; kernel {k_ms:.4f} ms vs plain {p_ms:.4f} ms at 6 rows")


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

    # Time at the slice's shape: 6 rows, bucket 448 (mtp), mid-window fill.
    B, T, pos = 6, 448, 300
    ck = torch.randn((L, B, T, D), generator=g, device=dev)
    cv = torch.randn((L, B, T, D), generator=g, device=dev)
    qkv = torch.randn((B, 1, 3, D), generator=g, device=dev)
    q, kn, vn = qkv[..., 0, :], qkv[..., 1, :], qkv[..., 2, :]
    k_ms, p_ms = turns(
        lambda: sd.self_attention_decode_torch(q, kn, vn, ck, cv, 1, pos, H),
        lambda: sd.self_attention_decode(q, kn, vn, ck, cv, 1, pos, H),
    )
    rec["self_decode"] = dict(max_abs_err=worst[torch.float32], ms=k_ms, plain_ms=p_ms)
    log(f"phase 3 self_decode: ok {n_cases} cases (rows 6,48; T 128/256/448 and bucket views; pos 3/127/300); "
        f"max_abs_err f32={worst[torch.float32]:.3g} bf16={worst[torch.bfloat16]:.3g}; row write bit-equal, "
        f"other rows untouched; kernel {k_ms:.4f} ms vs plain {p_ms:.4f} ms at 6 rows pos {pos}")


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
        got[kind] = dr.tokens == golden["windows"][kind]["tokens"]
        if not got[kind]:
            want = golden["windows"][kind]["tokens"]
            first = next((i for i, (a, b) in enumerate(zip(dr.tokens, want)) if a != b), min(len(dr.tokens), len(want)))
            log(f"  golden {kind}: first difference at token {first} of {len(want)}")
    if not all(got.values()):
        raise AssertionError(f"golden windows differ: {got}")
    log("phase 4 golden: ok windows tone/noise/mix token-exact vs tests/golden/engine_small.json")


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
    rec["slice"] = dict(windows_b1=b1, window_b8=b8, peak_bytes=peak, launches=launches, step_logit_err=step_err)
    ms_b1 = [round(w["ms"], 1) for w in b1]
    log(f"phase 5 slice: ok distil-large-v3 mtp=448 buckets=(128,256) kernel f32; "
        f"B=1 windows={len(b1)} wall_ms={ms_b1} steps={[w['steps'] for w in b1]} "
        f"host_syncs={[w['syncs'] for w in b1]}; B=8 (n_active=5, sequential ladder) wall_ms={b8[0]['ms']:.1f} "
        f"steps={b8[0]['steps']} host_syncs={b8[0]['syncs']}; peak_mem={peak / 2**30:.2f} GiB; "
        f"launches={launches}; kernel-vs-plain step logit err={step_err:.3g}; "
        f"texts const={[len(x) for x in texts['const']]} detect={[len(x) for x in texts['detect']]} chars")


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
    k_ms, p_ms = timed[(False, 8, 1)]
    rec["cross_decode"] = dict(max_abs_err=worst[torch.bfloat16], ms=k_ms, plain_ms=p_ms)
    rec["cross_decode_times"] = {f"int{4 if k[0] else 8} B={k[1]} G={k[2]}": v for k, v in timed.items()}
    times = "; ".join(f"{k}: kernel {v[0]:.4f} ms vs plain {v[1]:.4f} ms" for k, v in rec["cross_decode_times"].items())
    log(f"phase 6 cross_decode: ok {n_cases} cases (int8/int4, B 1/8/48, G 1/6, stacked li 0/1 and per-layer, "
        f"bf16/f32); max_abs_err bf16={worst[torch.bfloat16]:.3g} f32={worst[torch.float32]:.3g}; {times} "
        f"(Ta=1500, D=1280, H=20, bf16 q)")


def phase_flash_encoder(rec, dev):
    import torch

    from norma_tpu_torch.ops import flash_encoder as fe

    H, D = SERVE_H, SERVE_D
    g = torch.Generator(device=dev).manual_seed(7)
    # Tolerances: bf16 outputs round once and the online softmax rounds p
    # at running (not final) maxima: ~2 bf16 ulps at |out| <= 1; f32 is
    # summation order only.
    tol = {torch.bfloat16: 1.6e-2, torch.float32: 1e-5}
    worst = {torch.bfloat16: 0.0, torch.float32: 0.0}
    n_cases = 0
    for dtype in (torch.bfloat16, torch.float32):
        for B in (1, 8):
            for T in (1500, 200, 37):
                qkv = torch.randn((B, T, 3, D), generator=g, device=dev).to(dtype)
                q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]  # fused-QKV slices
                ko = fe.flash_self_attention(q, k, v, H)
                po = fe.flash_attention_torch(q, k, v, H)
                torch.cuda.synchronize()
                if ko.dtype != dtype or ko.shape != (B, T, D) or not torch.isfinite(ko).all():
                    raise AssertionError(f"flash {dtype} B={B} T={T}: bad output")
                err = float((ko.float() - po.float()).abs().max())
                if not err <= tol[dtype]:
                    raise AssertionError(f"flash {dtype} B={B} T={T}: err {err}")
                worst[dtype] = max(worst[dtype], err)
                n_cases += 1
    qkv = torch.randn((8, 1500, 3, D), generator=g, device=dev).to(torch.bfloat16)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    k_ms, p_ms = turns(lambda: fe.flash_attention_torch(q, k, v, H), lambda: fe.flash_self_attention(q, k, v, H))
    rec["flash_encoder"] = dict(max_abs_err=worst[torch.bfloat16], ms=k_ms, plain_ms=p_ms)
    log(f"phase 7 flash_encoder: ok {n_cases} cases (T 1500/200/37, B 1/8, bf16/f32, fused-QKV strides); "
        f"max_abs_err bf16={worst[torch.bfloat16]:.3g} f32={worst[torch.float32]:.3g}; kernel {k_ms:.3f} ms vs "
        f"plain {p_ms:.3f} ms at B=8 T=1500 bf16")


def phase_q8a8(rec, dev):
    import torch

    from norma_tpu_torch.ops import quant_matmul as qm

    g = torch.Generator(device=dev).manual_seed(8)
    M = 12000  # B=8 windows x 1500 encoder positions
    times, cublas, worst = {}, {}, 0.0
    for K, N in ((1280, 3840), (1280, 1280), (1280, 5120), (5120, 1280)):
        xq = torch.randint(-127, 128, (M, K), device=dev, dtype=torch.int8, generator=g)
        wq = torch.randint(-127, 128, (K, N), device=dev, dtype=torch.int8, generator=g)
        xs = torch.rand((M, 1), device=dev, generator=g) * 0.02
        ws = torch.rand((N,), device=dev, generator=g) * 0.02
        b = torch.randn((N,), device=dev, generator=g)
        ones_m, ones_n = torch.ones((M, 1), device=dev), torch.ones((N,), device=dev)
        # Unit scales, no bias: the output is float(acc) -- bit-equal iff the
        # int32 accumulation is exact.
        if not torch.equal(qm.q8a8_dense(xq, ones_m, wq, ones_n), qm.q8a8_dense_torch(xq, ones_m, wq, ones_n)):
            raise AssertionError(f"q8a8 K={K} N={N}: int32 accumulation differs from the exact product")
        # The f32 epilogue acc*xs*ws+b runs in the same order of correctly
        # rounded f32 operations in both versions: stated tolerance 0.
        ko = qm.q8a8_dense(xq, xs, wq, ws, b)
        po = qm.q8a8_dense_torch(xq, xs, wq, ws, b)
        torch.cuda.synchronize()
        err = float((ko - po).abs().max())
        if err != 0.0:
            raise AssertionError(f"q8a8 K={K} N={N}: epilogue err {err}")
        worst = max(worst, err)
        times[(K, N)] = turns(lambda: qm.q8a8_dense_torch(xq, xs, wq, ws, b), lambda: qm.q8a8_dense(xq, xs, wq, ws, b))
        # For reference only (not the plain version): a bf16 cuBLAS product
        # of the same shape, the tensor-core bound a redesign aims at.
        xb, wb = xq.to(torch.bfloat16), wq.to(torch.bfloat16)
        cublas[(K, N)] = cuda_ms(lambda: torch.matmul(xb, wb))
    k_ms, p_ms = times[(1280, 3840)]
    rec["q8a8"] = dict(max_abs_err=worst, ms=k_ms, plain_ms=p_ms)
    rec["q8a8_times"] = {f"K={k[0]} N={k[1]}": v + (cublas[k],) for k, v in times.items()}
    t = "; ".join(f"{k}: kernel {v[0]:.3f} ms vs plain {v[1]:.3f} ms (bf16 cuBLAS {v[2]:.3f} ms)"
                  for k, v in rec["q8a8_times"].items())
    log(f"phase 8 q8a8: ok M={M}, int32 accumulation bit-exact and f32 epilogue bit-equal at all four shapes; {t}")


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
                quant_matmul.q8a8_dense)
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
    from norma_tpu_torch.model.whisper import decoder_step, quantize_cross_kv
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

    engine = DecodeEngine(params, cfg, st, language_token_ids=lang_ids, quantize_cross_kv=True)
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

    # One B=1 window with int4 cross-K/V through the same kernel.
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
    b8 = [r["ms"] for r in rep["rounds"] if r["B"] == 8]
    b8_ms = dict(n=len(b8), median=float(np.median(b8)), min=min(b8), max=max(b8)) if b8 else None
    rec["serving"].update(int4_ms=int4_ms, int4_steps=int4_steps, int4_launches=int4_launches,
                          step_b1=step_b1, step_b8=step_b8, encode_b8_ms=enc_ms, round_b8_ms=b8_ms,
                          direct_b8_ms=direct_ms)
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
        f"{len(text4)} chars; B=8 encode {enc_ms:.1f} ms; bf16 step kernel-vs-plain logit err "
        f"B=1 {step_b1[0]:.3g} (|z| <= {step_b1[1]:.3g}), B=8 n_active=5 {step_b8[0]:.3g} "
        f"(|z| <= {step_b8[1]:.3g})")


def main() -> int:
    import torch

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
    t_all = time.perf_counter()
    for name, fn in (
        ("build", lambda: phase_build(rec)),
        ("sample_step", lambda: phase_sample_step(rec, dev)),
        ("self_decode", lambda: phase_self_decode(rec, dev)),
        ("golden", lambda: phase_golden(rec, dev)),
        ("slice", lambda: phase_slice(rec, dev)),
        ("cross_decode", lambda: phase_cross_decode(rec, dev)),
        ("flash_encoder", lambda: phase_flash_encoder(rec, dev)),
        ("q8a8", lambda: phase_q8a8(rec, dev)),
        ("serving", lambda: phase_serving(rec, dev)),
    ):
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
    ]
    served = rec["serving"]["launches"]
    for k, fn in zip(kernels[2:], ("cross_attention_q8_kernel_stacked", "flash_self_attention", "q8a8_dense")):
        k["launches"] = served[fn]
    for k in kernels:  # the contract's key order
        k.update({key: k.pop(key) for key in ("launches", "max_abs_err", "ms", "plain_ms")})
    print(json.dumps({"kernels": kernels}))
    print(rec["smi"])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
