"""Statistical accuracy proxy for the quantization tiers (the port of
``tools/accuracy_flip_rate.py``, with the same flags, config, audio,
targets, regimes, tiers and tables).

Real checkpoints are not in the repo, so the WER deltas the quant tiers
owe get an offline stand-in: greedy token FLIP RATES against the bf16
engine, across seeded models and audio kinds, with binomial CIs.

Method: for each seed x audio cell, decode one 6 s window greedily with the
bf16 engine, then with each quant tier built FROM THE SAME params.  A
"flip" is the first index where the token streams diverge and everything
after (once decoding diverges the tails are incomparable, so the
conservative count charges the whole tail).

Tiers: int8 decoder weights (``w8_decoder``), int8 logits head
(``w8_head``), int8 cross-K/V (``xkv_int8``), int8 self-K/V (``skv_int8``),
w8a8 encoder (``e8_w8a8``), their serving stack, and on the card the int4
cross-K/V through the cross-attention kernel (``xkv_int4``).  On the card
the tiers reach the hand-written kernels through the port's routes (w8 for
the int8 decoder and head, q8a8 for the w8a8 encoder, cross_decode for
int4 cross-K/V, sample_step in every decode).

Two regimes per run, both tables printed:

  - "knife-edge": plain seeded params.  Their top-2 logit gaps sit near
    zero, so any perturbation flips tokens (the worst-case ceiling);
  - "trained": the same dims FIT (``torch.optim.Adam(lr=1e-3)``, the
    defaults of ``optax.adam(1e-3)``; teacher-forced cross-entropy through
    ``encode -> cross_kv -> decoder_prefill`` on f32 params, the plain
    routes) on a synthetic audio -> token-sequence task until the margins
    are real: the typical-case bracket.  The median top-2 logit gap is
    reported per regime, over the whole vocabulary and over the ids the
    first-token mask allows.

The fit departs from the JAX tool in one place: it trains the sequence
greedy decoding must produce (:func:`decode_sequence`), with <|0.00|>
between the prompt and the text.  The first-token mask keeps only
<|0.00|>..<|1.00|>, so the JAX tool's targets leave the first decision
at the margins of untrained weights and shift every text token by one
position against the decode.

Run: python -m norma_tpu_torch.tools.accuracy_flip_rate [--dim 512] [--seeds 3] [--cpu]
Prints markdown tables + JSON, and writes the JSON to
``norma_torch_flip_rate.json`` in the temporary directory.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import tempfile
import time

import numpy as np

SOT, EOT, LANG, TASK = 50258, 50257, 50259, 50359
SPECIALS = dict(
    sot=SOT, eot=EOT, task=TASK, no_speech=50362,
    no_timestamps=50363, zero_sec=50364, one_sec=50414,
)
MSP = 300  # 6 s windows
N_FRAMES = 2 * MSP
AUDIOS = ("tone", "mix", "noise", "chirp")


def _log(msg: str) -> None:
    print(msg, flush=True)


def wilson_ci(k: int, n: int, z: float = 1.96):
    """95% Wilson interval for a binomial proportion."""
    if n == 0:
        return (0.0, 1.0)
    p = k / n
    denom = 1 + z * z / n
    center = (p + z * z / (2 * n)) / denom
    half = z * math.sqrt(p * (1 - p) / n + z * z / (4 * n * n)) / denom
    return (max(0.0, center - half), min(1.0, center + half))


def make_audio(kind: str, seconds: float, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    n = int(seconds * 16000)
    t = np.arange(n) / 16000.0
    if kind == "tone":
        return (0.3 * np.sin(2 * np.pi * 220 * t)).astype(np.float32)
    if kind == "mix":
        return (
            0.15 * np.sin(2 * np.pi * 440 * t)
            + 0.05 * rng.standard_normal(n)
        ).astype(np.float32)
    if kind == "noise":
        return (0.1 * rng.standard_normal(n)).astype(np.float32)
    if kind == "chirp":
        f = 110 + 660 * t / t[-1]
        return (0.25 * np.sin(2 * np.pi * f * t)).astype(np.float32)
    raise ValueError(kind)


def target_tokens(
    seed: int, kind_idx: int, sot: int = SOT, lang: int = LANG, task: int = TASK,
    eot: int = EOT, text_hi: int = 40_000,
) -> np.ndarray:
    """Deterministic per-(seed, audio-kind) token sequence to fit:
    [sot, lang, task, 20 text tokens, eot] — the shape real windows
    decode, with text ids in [100, ``text_hi``), below the special range."""
    rng = np.random.default_rng(7_000 + 17 * seed + kind_idx)
    body = rng.integers(100, text_hi, size=20, dtype=np.int64)
    return np.concatenate([[sot, lang, task], body, [eot]]).astype(np.int32)


def decode_sequence(target: np.ndarray, zero_sec: int = SPECIALS["zero_sec"]) -> np.ndarray:
    """The tokens greedy decoding of ``target``'s window must produce,
    prompt included: the first-token mask admits only <|0.00|>..<|1.00|>,
    and after a timestamp that follows the prompt the grammar admits only
    text, so <|0.00|> goes between the prompt and the text."""
    return np.insert(target, 3, zero_sec).astype(target.dtype)


def make_config(dim: int, layers: int, mtp: int):
    """The tool's model: 80 mels, V = 51865, 6 s windows, half as many
    decoder layers as encoder layers (at least 2)."""
    from ..model import WhisperConfig

    return WhisperConfig(
        num_mel_bins=80, vocab_size=51865, d_model=dim,
        encoder_layers=layers, encoder_attention_heads=dim // 64,
        decoder_layers=max(2, layers // 2),
        decoder_attention_heads=dim // 64,
        max_source_positions=MSP, max_target_positions=mtp,
        suppress_tokens=(),
    )


def window_mels(audios, cfg, device):
    """PCM windows -> [B, n_mels, 2 * max_source_positions] log-mel."""
    import torch

    from ..frontend.mel import log_mel_spectrogram, prepare_audio

    n_frames = 2 * cfg.max_source_positions
    batch = np.stack([prepare_audio(a, n_frames=n_frames) for a in audios])
    return log_mel_spectrogram(
        torch.from_numpy(batch).to(device), n_mels=cfg.num_mel_bins, n_frames=n_frames,
    )


def fit_loss(params, cfg, mels, toks):
    """Teacher-forced cross-entropy through the production graph
    (encode -> cross_kv -> decoder_prefill); ``toks`` [K, T] int."""
    import torch

    from ..model.whisper import cross_kv, decoder_prefill, encode

    feats = encode(params, cfg, mels)
    xk, xv = cross_kv(params, cfg, feats)
    logits, _, _ = decoder_prefill(params, cfg, toks[:, :-1], xk, xv)
    lp = torch.log_softmax(logits.float(), dim=-1)
    return -torch.gather(lp, -1, toks[:, 1:, None].long()).mean()


def fit(params, cfg, mels, targets, steps: int, log=_log, tag=""):
    """Adam fit of f32 ``params`` IN PLACE to ``targets`` on ``mels``, so
    the trained weights are confident on exactly the windows the flip
    measurement decodes.  Returns the per-step losses.

    The fit runs in exact f32 (no TF32) with deterministic algorithms: on
    the card the default, nondeterministic kernels made the trained
    weights, hence the tables, depend on what the process ran before
    (PERF.md, "Findings").  On the card, torch's deterministic mode then
    requires ``CUBLAS_WORKSPACE_CONFIG`` in the environment before cuBLAS
    first runs in the process (:func:`main` sets it)."""
    import torch

    toks = torch.from_numpy(np.stack(targets)).to(mels.device)
    leaves = [b for b in params.buffers() if b.is_floating_point()]
    for b in leaves:
        b.requires_grad_(True)
    opt = torch.optim.Adam(leaves, lr=1e-3)  # b1 0.9, b2 0.999, eps 1e-8 outside the root
    losses = []
    flags = (torch.are_deterministic_algorithms_enabled(), torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.use_deterministic_algorithms(True)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.enable_grad():
            for i in range(steps):
                opt.zero_grad(set_to_none=True)
                loss = fit_loss(params, cfg, mels, toks)
                loss.backward()
                opt.step()
                losses.append(float(loss.detach()))
                if i % 100 == 0 or i == steps - 1:
                    log(f"# train{tag} step {i}: loss {losses[-1]:.4f}")
    finally:
        torch.use_deterministic_algorithms(flags[0])
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags[1:]
        for b in leaves:
            b.requires_grad_(False)
            b.grad = None
    return losses


def decode_tokens(engine, audio, lang: int = LANG):
    """Greedy tokens of one window: encode, prefill, one t=0 loop."""
    cfg = engine.cfg
    feats = engine.encode(window_mels([audio], cfg, engine.device))
    state = engine.prefill(feats, lang)
    return list(engine.run_loop(state, 0.0, seed=0)[0].tokens)


def top2_gap(engine, audio, lang: int = LANG, allowed=None) -> float:
    """Top-2 logit gap at the first decode position: over the whole
    vocabulary (the JAX tool's measure), or over the ``allowed`` token ids
    only (the first token's mask keeps <|0.00|>..<|1.00|>: the margin of
    the decision greedy decoding makes there)."""
    feats = engine.encode(window_mels([audio], engine.cfg, engine.device))
    state = engine.prefill(feats, lang)
    nl = state["next_logits"][0].float().cpu().numpy()
    if allowed is not None:
        nl = nl[allowed]
    top2 = np.partition(nl, -2)[-2:]
    return float(top2[1] - top2[0])


def first_token_ids(cfg, st) -> np.ndarray:
    """The token ids the first-token mask lets greedy decoding pick."""
    from ..decode.masks import build_masks

    return np.flatnonzero(np.isfinite(build_masks(cfg.vocab_size, cfg.suppress_tokens, st).first_token))


def first_divergence(ref, got) -> int:
    """First index where ``got`` leaves ``ref`` (max length when equal)."""
    n = max(len(ref), len(got))
    return next(
        (i for i in range(n) if i >= len(ref) or i >= len(got) or ref[i] != got[i]), n
    )


def tiers(params, cfg, st, device):
    """Tier name -> engine builder over ``params``; ``xkv_int4`` (the
    cross-attention kernel's int4 layout) on the card only."""
    from ..decode.engine import DecodeEngine
    from ..model.quant import quantize_decoder, quantize_encoder, quantize_logits_head

    t = {}
    if device.type == "cuda":
        t["xkv_int4"] = lambda: DecodeEngine(
            params, cfg.with_(cross_kv_impl="kernel"), st, quantize_cross_kv="int4"
        )
    t |= {
        "w8_decoder": lambda: DecodeEngine(quantize_decoder(params), cfg, st),
        "w8_head": lambda: DecodeEngine(quantize_logits_head(params), cfg, st),
        "xkv_int8": lambda: DecodeEngine(params, cfg, st, quantize_cross_kv=True),
        "skv_int8": lambda: DecodeEngine(params, cfg, st, quantize_self_kv=True),
        "e8_w8a8": lambda: DecodeEngine(quantize_encoder(params), cfg, st),
        "serving_stack": lambda: DecodeEngine(
            quantize_encoder(quantize_decoder(params)), cfg, st, quantize_cross_kv=True
        ),
    }
    return t


def fit_seed(cfg, seed: int, device, steps: int, log=_log):
    """f32 params from ``init_params(cfg, seed)`` fit to the decode
    sequences of the seed's four windows; returns (params, losses)."""
    import torch

    from ..model import init_params

    mels = window_mels([make_audio(kind, 6.0, seed=100 + seed) for kind in AUDIOS], cfg, device)
    targets = [decode_sequence(target_tokens(seed, i)) for i in range(len(AUDIOS))]
    p = init_params(cfg, seed=seed, dtype=torch.float32, device=device)
    return p, fit(p, cfg, mels, targets, steps, log=log, tag=f" seed {seed}")


def trained_params(cfg, seed: int, device, steps: int, log=_log):
    """:func:`fit_seed`'s params as bf16 with fused QKV (the tier's
    serving form)."""
    import torch

    from ..model import fuse_qkv

    return fuse_qkv(fit_seed(cfg, seed, device, steps, log)[0].to(torch.bfloat16))


def run(args, log=_log) -> dict:
    import torch

    from ..decode.engine import DecodeEngine
    from ..decode.masks import SpecialTokens
    from ..model import fuse_qkv, init_params

    if args.cpu:
        device = torch.device("cpu")
    elif torch.cuda.is_available():
        device = torch.device("cuda", 0)
    else:
        raise RuntimeError("no CUDA device: pass --cpu to run on the CPU")
    cfg = make_config(args.dim, args.layers, args.mtp)
    st = SpecialTokens(**SPECIALS)

    regimes = [("knife-edge", False)]
    if args.train_steps > 0:
        regimes.append(("trained", True))

    # (regime, tier) -> flips/positions + window-exact counts
    stats = {}
    gaps = {name: [] for name, _ in regimes}
    first_gaps = {name: [] for name, _ in regimes}
    first_ids = first_token_ids(cfg, st)
    misses = []
    t0 = time.time()
    for regime, do_train in regimes:
        for seed in range(args.seeds):
            if do_train:
                params = trained_params(cfg, seed, device, args.train_steps, log=log)
            else:
                params = fuse_qkv(init_params(cfg, seed=seed, dtype=torch.bfloat16, device=device))
            base = DecodeEngine(params, cfg, st)
            tier_engines = {k: b() for k, b in tiers(params, cfg, st, device).items()}
            for kind in AUDIOS:
                audio = make_audio(kind, 6.0, seed=100 + seed)
                ref = decode_tokens(base, audio)
                gaps[regime].append(top2_gap(base, audio))
                first_gap = top2_gap(base, audio, allowed=first_ids)
                first_gaps[regime].append(first_gap)
                for name, eng in tier_engines.items():
                    got = decode_tokens(eng, audio)
                    n = max(len(ref), len(got))
                    first_div = first_divergence(ref, got)
                    flips = n - first_div
                    s = stats.setdefault(
                        (regime, name), {"flips": 0, "positions": 0, "windows": 0, "exact": 0}
                    )
                    s["flips"] += flips
                    s["positions"] += n
                    s["windows"] += 1
                    s["exact"] += int(flips == 0)
                    if flips:
                        misses.append({
                            "regime": regime, "tier": name, "seed": seed, "audio": kind,
                            "first_diff": first_div, "ref_len": len(ref), "got_len": len(got),
                            "first_token_gap": round(first_gap, 4),
                        })
                log(f"# {regime} seed {seed} {kind}: ref {len(ref)} toks (+{time.time()-t0:.0f}s)")

    rows = []
    for (regime, name), s in sorted(stats.items()):
        lo, hi = wilson_ci(s["flips"], s["positions"])
        rows.append({
            "regime": regime,
            "tier": name,
            "windows": s["windows"],
            "exact_windows": s["exact"],
            "positions": s["positions"],
            "flipped": s["flips"],
            "flip_rate": round(s["flips"] / max(1, s["positions"]), 4),
            "ci95": [round(lo, 4), round(hi, 4)],
        })

    gap_stats = {regime: round(float(np.median(g)), 2) for regime, g in gaps.items()}
    first_gap_stats = {regime: round(float(np.median(g)), 4) for regime, g in first_gaps.items()}
    for regime, _ in regimes:
        log(f"\n### {regime} (median top-2 logit gap {gap_stats[regime]}; among the first token's "
            f"allowed ids {first_gap_stats[regime]})")
        log("| tier | exact windows | flip rate (95% CI) |")
        log("|---|---|---|")
        for r in rows:
            if r["regime"] != regime:
                continue
            log(
                f"| {r['tier']} | {r['exact_windows']}/{r['windows']} | "
                f"{r['flip_rate']:.3f} ({r['ci95'][0]:.3f}-{r['ci95'][1]:.3f}) |"
            )
    return {
        "config": f"d{args.dim} L{args.layers} vocab 51865 bf16, "
                  f"{args.seeds} seeds x {len(AUDIOS)} audios, "
                  f"greedy mtp={args.mtp}, train_steps={args.train_steps}",
        "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        "median_top2_gap": gap_stats,
        "median_first_token_gap": first_gap_stats,
        "note": (
            "flip = all positions from the first divergence (conservative "
            "tail charge); knife-edge = plain seeded weights (worst-case "
            "ceiling), trained = same dims Adam-fit on a synthetic "
            "audio->tokens task (genuine margins: the typical-side bracket) "
            "with <|0.00|> as its first decoded token; the first token is "
            "chosen among <|0.00|>..<|1.00|> (the first-token mask): its "
            "margin there is median_first_token_gap"
        ),
        "rows": rows,
        "misses": misses,
        "measured_at_utc": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
    }


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dim", type=int, default=512)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--seeds", type=int, default=3)
    ap.add_argument("--mtp", type=int, default=48)
    ap.add_argument("--train-steps", type=int, default=350,
                    help="Adam steps for the 'trained' regime (0 = knife-edge only)")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the card)")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    # The fit's deterministic mode on the card needs this set before cuBLAS
    # first runs in the process.
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    out = run(parse_args(argv))
    print(json.dumps(out))
    with open(os.path.join(tempfile.gettempdir(), "norma_torch_flip_rate.json"), "w") as f:
        json.dump(out, f, indent=1)
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
