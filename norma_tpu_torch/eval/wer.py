"""Word-error-rate evaluation (a copy of ``norma_tpu/eval/wer.py``).

Tooling for the BASELINE.md quality target (WER parity on LibriSpeech
test-clean).  The metric is standard Levenshtein over words; the text
normalizer covers the common English conventions (lowercase, punctuation
strip, whitespace collapse) applied before scoring.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Iterable, List, Tuple

_PUNCT = re.compile(r"[^\w\s']")
_WS = re.compile(r"\s+")


def normalize_text(text: str) -> str:
    text = text.lower()
    text = _PUNCT.sub(" ", text)
    text = text.replace("'", "")
    return _WS.sub(" ", text).strip()


def edit_distance(ref: List[str], hyp: List[str]) -> Tuple[int, int, int, int]:
    """Return (substitutions, deletions, insertions, total_edits)."""
    n, m = len(ref), len(hyp)
    # dp[j] over hyp; track ops via full table (datasets are small enough).
    dp = [[0] * (m + 1) for _ in range(n + 1)]
    for i in range(n + 1):
        dp[i][0] = i
    for j in range(m + 1):
        dp[0][j] = j
    for i in range(1, n + 1):
        for j in range(1, m + 1):
            if ref[i - 1] == hyp[j - 1]:
                dp[i][j] = dp[i - 1][j - 1]
            else:
                dp[i][j] = 1 + min(dp[i - 1][j - 1], dp[i - 1][j], dp[i][j - 1])
    # Backtrack for op counts.
    i, j = n, m
    subs = dels = ins = 0
    while i > 0 or j > 0:
        if i > 0 and j > 0 and ref[i - 1] == hyp[j - 1]:
            i, j = i - 1, j - 1
        elif i > 0 and j > 0 and dp[i][j] == dp[i - 1][j - 1] + 1:
            subs += 1
            i, j = i - 1, j - 1
        elif i > 0 and dp[i][j] == dp[i - 1][j] + 1:
            dels += 1
            i -= 1
        else:
            ins += 1
            j -= 1
    return subs, dels, ins, dp[n][m]


@dataclass
class WerResult:
    wer: float
    substitutions: int
    deletions: int
    insertions: int
    ref_words: int
    n_utterances: int


def word_error_rate(
    pairs: Iterable[Tuple[str, str]], normalize: bool = True
) -> WerResult:
    """pairs of (reference, hypothesis) -> corpus-level WER."""
    subs = dels = ins = total = n = 0
    for ref, hyp in pairs:
        if normalize:
            ref, hyp = normalize_text(ref), normalize_text(hyp)
        r, h = ref.split(), hyp.split()
        s, d, i, _ = edit_distance(r, h)
        subs += s
        dels += d
        ins += i
        total += len(r)
        n += 1
    wer = (subs + dels + ins) / max(total, 1)
    return WerResult(wer, subs, dels, ins, total, n)
