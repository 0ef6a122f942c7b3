"""The runnable Whisper streaming model (``norma_tpu/models/whisper/model.py``;
reference ``whisper::Model``, ``model.rs:16-159``): owns the decode engine,
tokenizer and long-form state, and consumes PCM chunks."""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ...decode.engine import DecodeEngine
from ...decode.longform import LanguageState, LongFormDecoder
from ...frontend.mel import prepare_audio
from ...tracing import instrument
from .. import Model


class WhisperModel(Model):
    SAMPLE_RATE = 16_000
    dtype = np.float32

    def __init__(
        self,
        engine: DecodeEngine,
        tokenizer,
        lang: LanguageState,
        language_tokens: Optional[Sequence[int]] = None,
        seed: int = 0,
        timestamps: bool = False,
    ) -> None:
        self.engine = engine
        self.tokenizer = tokenizer
        self.longform = LongFormDecoder(
            engine,
            tokenizer,
            lang,
            language_tokens=language_tokens,
            seed=seed,
            timestamps=timestamps,
        )

    @instrument(
        fields={
            "input_data_len": lambda a: len(a["data"]),
            "buf_len": lambda a: a["self"].longform.buf.size,
            "final_chunk": lambda a: a["final_chunk"],
        }
    )  # reference #[instrument(fields(...))], model.rs:54
    def transcribe(self, data: np.ndarray, final_chunk: bool) -> str:
        return self.longform.transcribe(np.asarray(data, np.float32), final_chunk)

    @instrument
    def warmup(self, batch: int = 1) -> None:
        """Run one silent window through the serving path at ``batch``
        streams, so the first real chunk pays no first-use costs: the
        kernel build (``ops/_build.py``), CUDA context and library
        initialization, allocator growth at this batch width.  Detect-mode
        models also run the known-language variant they switch to after
        the first window.  The batching scheduler calls
        ``warmup(batch=b)`` per bucket."""
        lf = self.longform
        audio = torch.from_numpy(
            np.tile(prepare_audio(np.zeros(lf.window_samples, np.float32), lf.n_frames), (batch, 1))
        )
        lang = lf.lang.token
        self.engine.transcribe_window(
            audio, [int(lang) if lang is not None else -1] * batch, seed=0
        )
        if lang is None and lf.language_tokens:
            self.engine.transcribe_window(audio, [int(lf.language_tokens[0])] * batch, seed=0)
