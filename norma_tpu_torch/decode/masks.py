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

    @classmethod
    def from_tokenizer(cls, tokenizer, task_token_str: str) -> "SpecialTokens":
        """Resolve the ids through a tokenizer (reference:
        monolingual.rs:242-250); the no-speech token is the first of its
        two historical names the vocabulary has."""
        from ..constants import (
            EOT_TOKEN,
            NO_SPEECH_TOKENS,
            NO_TIMESTAMPS_TOKEN,
            ONE_SEC_TOKEN,
            SOT_TOKEN,
            ZERO_SEC_TOKEN,
        )
        from ..errors import TokenIdError

        def tid(s: str) -> int:
            i = tokenizer.token_to_id(s)
            if i is None:
                raise TokenIdError(s)
            return i

        no_speech = next(
            (i for i in map(tokenizer.token_to_id, NO_SPEECH_TOKENS) if i is not None), None
        )
        if no_speech is None:
            raise TokenIdError(" nor ".join(NO_SPEECH_TOKENS))
        return cls(
            sot=tid(SOT_TOKEN),
            eot=tid(EOT_TOKEN),
            task=tid(task_token_str),
            no_speech=no_speech,
            no_timestamps=tid(NO_TIMESTAMPS_TOKEN),
            zero_sec=tid(ZERO_SEC_TOKEN),
            one_sec=tid(ONE_SEC_TOKEN),
        )


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
