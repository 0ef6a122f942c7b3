"""Golden tokens from a real Whisper checkpoint (the port of
``tools/make_golden.py``; the same flags and the same JSON).

Given a checkpoint -- an HF repo id (the loader's hub download at a pinned
revision) or a local directory -- transcribe fixed audio and write each
case's text and its first window's greedy tokens, for committing as
``tests/golden/<name>.json`` and cross-checking against HF's
``WhisperForConditionalGeneration`` or the reference binary.  Runs on the
card; ``--cpu`` asks for the CPU.

  python -m norma_tpu_torch.tools.make_golden --local-dir CKPT --lang en out.json
  python -m norma_tpu_torch.tools.make_golden --repo distil-whisper/distil-large-v3 out.json
  python -m norma_tpu_torch.tools.make_golden --local-dir CKPT --wav a.wav --wav b.wav out.json

Without --wav, three deterministic synthetic signals are used.  WAVs must be
16 kHz mono 16-bit PCM, read with the stdlib ``wave`` module.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from .eval_wer import read_wav


def synthetic_cases():
    t = np.arange(6 * 16000) / 16000.0
    rng = np.random.default_rng(1)
    return {
        "tone220": (0.3 * np.sin(2 * np.pi * 220 * t)).astype(np.float32),
        "noise": (0.1 * rng.standard_normal(t.size)).astype(np.float32),
        "mix440": (0.15 * np.sin(2 * np.pi * 440 * t) + 0.05 * rng.standard_normal(t.size)).astype(np.float32),
    }


@torch.no_grad()
def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("out")
    ap.add_argument("--repo", help="HF repo id (needs network)")
    ap.add_argument("--revision", default="main")
    ap.add_argument("--local-dir", help="local checkpoint dir (offline)")
    ap.add_argument("--lang", help="constant language code, e.g. en (else detect)")
    ap.add_argument("--wav", action="append", default=[], help="16kHz mono wav")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU (default: the card)")
    args = ap.parse_args(argv)
    if not args.repo and not args.local_dir:
        sys.exit("need --repo or --local-dir")

    from ..decode.longform import LongFormDecoder
    from ..frontend.mel import log_mel_spectrogram, prepare_audio
    from ..models import SelectedDevice
    from ..models.whisper.loader import build_model

    model = build_model(
        repo_id=args.repo or "",
        revision=args.revision,
        quantized_ext=None,
        device=SelectedDevice.cpu() if args.cpu else SelectedDevice.cuda(),
        const_language_token_str=(f"<|{args.lang}|>" if args.lang else None),
        local_dir=args.local_dir,
    )
    engine, tokenizer = model.engine, model.tokenizer

    cases = {p: read_wav(p) for p in args.wav} if args.wav else synthetic_cases()
    out = {"source": args.repo or args.local_dir, "revision": args.revision, "cases": {}}
    for name, audio in cases.items():
        lf = LongFormDecoder(
            engine, tokenizer, model.longform.lang,
            language_tokens=model.longform.language_tokens, seed=0,
        )
        text = lf.transcribe(audio, final_chunk=True)
        # Raw greedy window tokens for bit-level cross-checks.
        n_frames = 2 * engine.cfg.max_source_positions
        mel = log_mel_spectrogram(
            torch.from_numpy(prepare_audio(audio, n_frames=n_frames))[None].to(engine.device),
            n_mels=engine.cfg.num_mel_bins,
            n_frames=n_frames,
        )
        feats = engine.encode(mel)
        lang_tok = model.longform.lang.token
        if lang_tok is None:
            probs = engine.detect_language(feats)
            lang_tok = model.longform.language_tokens[int(np.argmax(probs[0]))]
        dr = engine.run_loop(engine.prefill(feats, lang_tok), 0.0, seed=0)[0]
        out["cases"][name] = {
            "text": text,
            "greedy_tokens": dr.tokens,
            "avg_logprob": dr.avg_logprob,
            "no_speech_prob": dr.no_speech_prob,
        }

    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
