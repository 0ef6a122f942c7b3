#!/usr/bin/env python3
"""Drive the norma_tpu_torch port once on one CUDA card, end to end.

    python3 chip_smoke.py

Needs one CUDA card, nvcc and this repository's sources; it exits non-zero
(and prints no result line) without them.  Phases, one line each:

  1. build: compile csrc/*.cu with nvcc (ops/_build.py); print the nvcc
     version, build seconds, ptxas' resource lines and the card's name and
     power limit;
  2. sample_step kernel vs its plain PyTorch version at V=51866 (greedy
     exactness, t>0 mask support and exact replay from the kernel's own
     Philox uniforms, uniformity of those uniforms, per-row independence);
  3. self_decode kernel vs its plain version at distil-large-v3 widths
     (f32 and bf16, bucket views, in-place row write);
  4. the golden config (tests/golden/engine_small.json) on the card;
  5. the full-width slice: distil-large-v3 at mtp=448, buckets (128, 256),
     self_kv_impl="kernel", f32, seeded random weights: WhisperModel over
     30 s of audio in three chunks (constant language, then detect mode)
     and a padded B=8 window.  Both kernels' launch counters must move.

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
    ]
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
