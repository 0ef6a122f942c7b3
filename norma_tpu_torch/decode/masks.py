"""Suppression-mask precompute and special-token bundle (copy of
``norma_tpu/decode/masks.py``).

The four additive -inf mask tensors the reference builds at load time
(``monolingual.rs:252-296``) and applies per decode step
(``model.rs:212-277,333-338``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np


@dataclass(frozen=True)
class SpecialTokens:
    """Resolved special-token ids (reference: model.rs:37-41)."""

    sot: int
    eot: int
    task: int
    no_speech: int
    no_timestamps: int
    zero_sec: int  # <|0.00|>
    one_sec: int  # <|1.00|>


@dataclass(frozen=True)
class Masks:
    """Additive f32 [vocab] masks (0 or -inf)."""

    suppress: np.ndarray  # config suppress list + <|notimestamps|>
    non_timestamps: np.ndarray  # kills everything <= no_timestamps
    timestamps: np.ndarray  # kills everything > no_timestamps
    first_token: np.ndarray  # keeps only [<|0.00|> ..= <|1.00|>]


def build_masks(
    vocab_size: int,
    suppress_tokens: Sequence[int],
    st: SpecialTokens,
) -> Masks:
    neg_inf = np.float32(-np.inf)
    ids = np.arange(vocab_size)

    suppress = np.zeros(vocab_size, np.float32)
    idx = [t for t in suppress_tokens if 0 <= t < vocab_size]
    suppress[idx] = neg_inf
    suppress[st.no_timestamps] = neg_inf

    non_timestamps = np.where(ids > st.no_timestamps, 0.0, neg_inf).astype(np.float32)
    timestamps = np.where(ids > st.no_timestamps, neg_inf, 0.0).astype(np.float32)
    first_token = np.where(
        (ids < st.zero_sec) | (ids > st.one_sec), neg_inf, 0.0
    ).astype(np.float32)

    return Masks(suppress, non_timestamps, timestamps, first_token)
