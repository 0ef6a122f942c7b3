"""Evaluate WER of a checkpoint over a manifest of WAV files.

Usage:
  python -m norma_tpu_torch.examples.eval_wer manifest.tsv [checkpoint_dir]

``manifest.tsv``: one utterance per line, ``<wav_path>\\t<reference text>``
(e.g. LibriSpeech test-clean converted to 16 kHz WAV).  Prints corpus WER.
"""

import sys
import wave

import numpy as np

from norma_tpu_torch.decode import LanguageState, LongFormDecoder
from norma_tpu_torch.eval import word_error_rate
from norma_tpu_torch.models import SelectedDevice
from norma_tpu_torch.models.whisper import monolingual


def read_wav(path: str) -> np.ndarray:
    """Whole-file 16 kHz mono PCM -> float32 in [-1, 1).

    Handles the widths audio.sources.FileSource does (8/16/24/32-bit int
    PCM): parsing 24-bit data as int16 would feed garbage to the model and
    report ~100% WER instead of failing loudly.
    """
    with wave.open(path, "rb") as w:
        if w.getframerate() != 16_000 or w.getnchannels() != 1:
            raise ValueError(
                f"{path}: need 16 kHz mono, got "
                f"{w.getframerate()} Hz x{w.getnchannels()}"
            )
        width = w.getsampwidth()
        raw = w.readframes(w.getnframes())
    if width == 1:  # unsigned 8-bit
        return (np.frombuffer(raw, np.uint8).astype(np.float32) - 128.0) / 128.0
    if width == 2:
        return np.frombuffer(raw, np.int16).astype(np.float32) / 32768.0
    if width == 3:  # 24-bit LE: widen into an int32's top bytes
        u = np.frombuffer(raw, np.uint8).astype(np.uint32).reshape(-1, 3)
        x = ((u[:, 0] << 8) | (u[:, 1] << 16) | (u[:, 2] << 24)).view(np.int32)
        return x.astype(np.float32) / 2147483648.0
    if width == 4:
        return np.frombuffer(raw, np.int32).astype(np.float32) / 2147483648.0
    raise ValueError(f"{path}: unsupported WAV sample width {width} bytes")


def main() -> None:
    manifest = sys.argv[1]
    local_dir = sys.argv[2] if len(sys.argv) > 2 else None

    model = monolingual.Definition(
        monolingual.ModelType.DISTIL_LARGE_EN_V3,
        SelectedDevice.auto(),
        local_dir=local_dir,
    ).blocking_try_to_model()

    pairs = []
    with open(manifest) as f:
        for lineno, line in enumerate(f, start=1):
            line = line.rstrip("\n")
            if not line.strip():
                continue  # blank lines are not utterances
            if "\t" not in line:
                # Fail with context up front, not hours into the run.
                raise ValueError(
                    f"{manifest}:{lineno}: expected '<wav>\\t<text>', "
                    f"got {line[:60]!r}"
                )
            path, ref = line.split("\t", 1)
            audio = read_wav(path)
            # Fresh long-form state per utterance.
            lf = LongFormDecoder(
                model.engine,
                model.tokenizer,
                LanguageState(const=model.longform.lang.const),
                language_tokens=model.longform.language_tokens,
            )
            hyp = lf.transcribe(audio, final_chunk=True)
            pairs.append((ref, hyp))
            print(f"{len(pairs):5d}  {hyp[:70]!r}", flush=True)

    res = word_error_rate(pairs)
    print(
        f"WER {res.wer:.4f}  (S={res.substitutions} D={res.deletions} "
        f"I={res.insertions} / {res.ref_words} words, {res.n_utterances} utts)"
    )


if __name__ == "__main__":
    main()
