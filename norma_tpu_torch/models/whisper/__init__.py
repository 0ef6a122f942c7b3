"""Whisper model family (``norma_tpu/models/whisper``; reference
``src/models/whisper/``): the runnable :class:`WhisperModel`, the
checkpoint Definitions (:mod:`.monolingual`, :mod:`.multilingual`), their
loader and the tokenizer."""

from __future__ import annotations

import enum

from ...errors import (
    LoadTokenizerError,
    MelBinsError,
    ResponsivenessError,
    TokenIdError,
    WhisperError,
)
from .languages import ALL_LANGUAGES, Language


class VocabVersion(enum.Enum):
    """Reference: whisper/mod.rs:54-62."""

    V1 = "v1"
    V2 = "v2"
    EN_V1 = "en_v1"
    EN_V2 = "en_v2"


def token_id(tokenizer, token: str) -> int:
    """Resolve a special-token id or raise (reference: mod.rs:86-90)."""
    tid = tokenizer.token_to_id(token)
    if tid is None:
        raise TokenIdError(token)
    return tid


from .model import WhisperModel  # noqa: E402
from . import monolingual  # noqa: E402
from . import multilingual  # noqa: E402

__all__ = [
    "ALL_LANGUAGES",
    "Language",
    "VocabVersion",
    "WhisperModel",
    "WhisperError",
    "TokenIdError",
    "LoadTokenizerError",
    "MelBinsError",
    "ResponsivenessError",
    "token_id",
    "monolingual",
    "multilingual",
]
