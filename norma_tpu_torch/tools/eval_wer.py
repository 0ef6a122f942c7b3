"""WER evaluation over an audio manifest (the port of ``tools/eval_wer.py``).

Feeds each utterance through the long-form decoder and scores corpus-level
WER against the references (``norma_tpu_torch.eval.wer`` — standard
Levenshtein with English text normalization), as the reference's WER table
was produced on LibriSpeech test-clean (``src/models/whisper/mod.rs:20-28``).

Manifest formats:
  --manifest FILE   JSONL, one {"wav": path, "text": reference} per line
                    (16 kHz mono 16-bit PCM WAV)
  --librispeech DIR LibriSpeech layout: walks ``*.trans.txt`` and expects
                    a sibling ``<utt>.wav`` per utterance id (convert the
                    shipped .flac first, e.g.
                    ``ffmpeg -i x.flac -ar 16000 -ac 1 x.wav``)

Model: --repo/--revision (the loader's hub download) or --local-dir (an HF
checkpoint directory, a params file or a GGUF file; the loader detects the
format).  Runs on the card; ``--cpu`` asks for the CPU.

Run: python -m norma_tpu_torch.tools.eval_wer --local-dir CKPT --librispeech DIR out.json
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
import wave

import numpy as np


def read_wav(path: str) -> np.ndarray:
    with wave.open(path, "rb") as w:
        assert w.getframerate() == 16_000, f"{path}: need 16 kHz"
        assert w.getnchannels() == 1, f"{path}: need mono"
        assert w.getsampwidth() == 2, f"{path}: need 16-bit PCM"
        raw = w.readframes(w.getnframes())
    return (np.frombuffer(raw, np.int16).astype(np.float32)) / 32768.0


def load_manifest(path: str):
    items = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                d = json.loads(line)
                items.append((d["wav"], d["text"]))
    return items


def load_librispeech(root: str):
    """Walk LibriSpeech's ``<spk>-<chap>.trans.txt`` transcript files."""
    items = []
    for dirpath, _, files in os.walk(root):
        for fn in sorted(files):
            if not fn.endswith(".trans.txt"):
                continue
            with open(os.path.join(dirpath, fn)) as f:
                for line in f:
                    utt, _, text = line.strip().partition(" ")
                    if not utt:
                        continue
                    wav = os.path.join(dirpath, utt + ".wav")
                    if os.path.exists(wav):
                        items.append((wav, text))
    return items


def evaluate(transcribe, items, limit: int = 0, log=print):
    """Run ``transcribe(audio)->text`` over (wav, ref) items; return dict.

    Factored so tests can drive it with a fake transcribe function."""
    from ..eval.wer import word_error_rate

    if limit:
        items = items[:limit]
    pairs = []
    t0 = time.time()
    audio_s = 0.0
    for i, (wav, ref) in enumerate(items):
        audio = read_wav(wav)
        audio_s += audio.size / 16_000.0
        hyp = transcribe(audio)
        pairs.append((ref, hyp))
        if (i + 1) % 25 == 0:
            r = word_error_rate(pairs)
            log(f"# {i+1}/{len(items)} wer so far {r.wer:.4f} "
                f"(+{time.time()-t0:.0f}s)")
    r = word_error_rate(pairs)
    wall = time.time() - t0
    return {
        "wer": round(r.wer, 4),
        "substitutions": r.substitutions,
        "deletions": r.deletions,
        "insertions": r.insertions,
        "ref_words": r.ref_words,
        "n_utterances": r.n_utterances,
        "audio_seconds": round(audio_s, 1),
        "wall_seconds": round(wall, 1),
        "rtf": round(wall / audio_s, 4) if audio_s else None,
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("out")
    ap.add_argument("--manifest", help="JSONL manifest of {wav, text}")
    ap.add_argument("--librispeech", help="LibriSpeech-layout directory")
    ap.add_argument("--repo", help="HF repo id (needs network)")
    ap.add_argument("--revision", default="main")
    ap.add_argument("--local-dir", help="local checkpoint dir (offline)")
    ap.add_argument("--lang", default="en",
                    help="constant language code ('' = detect)")
    ap.add_argument("--limit", type=int, default=0)
    ap.add_argument("--cpu", action="store_true", help="run on the CPU (default: the card)")
    args = ap.parse_args(argv)
    if not args.manifest and not args.librispeech:
        sys.exit("need --manifest or --librispeech")
    if not args.repo and not args.local_dir:
        sys.exit("need --repo or --local-dir")

    items = (
        load_manifest(args.manifest)
        if args.manifest
        else load_librispeech(args.librispeech)
    )
    if not items:
        sys.exit("manifest resolved to zero utterances")
    print(f"# {len(items)} utterances")

    from ..decode.longform import LongFormDecoder
    from ..models import SelectedDevice
    from ..models.whisper.loader import build_model

    model = build_model(
        repo_id=args.repo or "",
        revision=args.revision,
        quantized_ext=None,
        device=SelectedDevice.cpu() if args.cpu else SelectedDevice.cuda(),
        const_language_token_str=(
            f"<|{args.lang}|>" if args.lang else None
        ),
        local_dir=args.local_dir,
    )

    def transcribe(audio: np.ndarray) -> str:
        lf = LongFormDecoder(
            model.engine, model.tokenizer, model.longform.lang,
            language_tokens=model.longform.language_tokens, seed=0,
        )
        return lf.transcribe(audio, final_chunk=True)

    result = evaluate(transcribe, items, limit=args.limit)
    result["source"] = args.repo or args.local_dir
    result["revision"] = args.revision
    print(json.dumps(result, indent=1))
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
