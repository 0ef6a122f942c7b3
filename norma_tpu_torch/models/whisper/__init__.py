"""Whisper model family (``norma_tpu/models/whisper``): the runnable
:class:`WhisperModel`.  Checkpoint Definitions, the loader and the
tokenizer are not ported yet."""

from .model import WhisperModel

__all__ = ["WhisperModel"]
