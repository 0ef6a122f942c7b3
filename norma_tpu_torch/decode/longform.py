"""Long-form streaming decode: buffer management, windowing, drain
accounting (``norma_tpu/decode/longform.py``).

Host-side re-creation of the reference's ``Model::transcribe``
(``model.rs:55-159``): audio accumulates in a buffer; each pass transcribes
a <=30s window; the timestamp grammar decides how much audio is consumed.
A fully-transcribed window drains entirely; a partially-transcribed one
drains up to the last complete segment's start timestamp (s_timestamp *
320 samples) so the tail is re-transcribed with more context;
unterminated segments wait for more audio.

Documented deviations (forward-progress fixes; the reference loops forever
in these cases because nothing is drained and no segment is consumable):
  1. no-speech early exit (probe > threshold) returns prefix-only tokens
     (model.rs:308-315) -> we drain the window.
  2. a decode whose tokens contain fewer than two segment boundaries after
     trailing-timestamp cleanup yields zero segments -> we drain the window.
  3. a decode where a pass over the segments neither drained audio nor
     decided to wait -> we drain the window.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..constants import (
    HOP_LENGTH,
    LOGPROB_THRESHOLD,
    NO_SPEECH_THRESHOLD,
    SAMPLE_RATE,
    SAMPLES_PER_TIMESTAMP_TICK,
    TEMPERATURES,
)
from ..frontend.mel import prepare_audio
from ..tracing import instrument
from ..utils import inclusive_segments
from .engine import DecodeEngine, DecodingResult

logger = logging.getLogger(__name__)


@dataclass
class LanguageState:
    """Reference: LanguageState (model.rs:392-440).

    ``const`` set => monolingual (ConstLang); otherwise Detect mode where
    ``detected`` holds the language token once inferred and is cleared after
    every final chunk.
    """

    const: Optional[int] = None
    detected: Optional[int] = None

    @property
    def token(self) -> Optional[int]:
        return self.const if self.const is not None else self.detected

    @property
    def needs_detection(self) -> bool:
        return self.const is None and self.detected is None

    def set_detected(self, tok: int) -> None:
        if self.const is None:
            self.detected = tok

    def clear(self) -> None:
        self.detected = None


class LongFormDecoder:
    """Streaming long-form decoder for a single audio stream."""

    def __init__(
        self,
        engine: DecodeEngine,
        tokenizer,
        lang: LanguageState,
        language_tokens: Optional[Sequence[int]] = None,
        seed: int = 0,
        timestamps: bool = False,
    ):
        self.engine = engine
        self.tokenizer = tokenizer
        self.lang = lang
        # Token id per Language-enum index, for mapping argmax -> token id.
        self.language_tokens = list(language_tokens) if language_tokens else None
        self.buf = np.zeros(0, np.float32)
        self.pending_text: List[str] = []
        self._seed = seed
        # Opt-in timestamped emission: "[<start>s -> <end>s] text" with
        # ABSOLUTE stream offsets.
        self.timestamps = timestamps
        self.time_offset_s = 0.0  # audio consumed so far, in seconds
        # A full window is 2 * max_source_positions mel frames (3000 =>
        # 480_000 samples, the reference's N_SAMPLES).
        cfg = engine.cfg
        self.n_frames = 2 * cfg.max_source_positions
        self.window_samples = self.n_frames * HOP_LENGTH

    # -- internals ---------------------------------------------------------

    def _next_seed(self) -> int:
        self._seed += len(TEMPERATURES)
        return self._seed

    @instrument(
        name="Transcribe slice",
        fields={"slice_len": lambda a: len(a["window"])},
    )  # reference debug_span!("Transcribe slice", slice_len), model.rs:72
    def _decode_window(self, window: np.ndarray) -> Optional[DecodingResult]:
        """One engine window: mel, encoder, language detection (when
        pending: lang slot = -1), prefill, the no-speech gate and the whole
        temperature-fallback ladder."""
        audio = torch.from_numpy(prepare_audio(window, n_frames=self.n_frames))[None]
        tok = self.lang.token
        drs, info = self.engine.transcribe_window(
            audio, [tok if tok is not None else -1], self._next_seed()
        )
        if self.lang.needs_detection:
            probs = info["lang_probs"][0]
            idx = int(np.argmax(probs))
            logger.debug("Detected language idx=%d prob=%.3f", idx, probs[idx])
            self.lang.set_detected(int(info["langs"][0]))
        return drs[0]

    # -- public ------------------------------------------------------------

    def feed(self, data: np.ndarray) -> None:
        # Copy: ``data`` may be a view of a buffer the producer reuses.
        if self.buf.size == 0:
            self.buf = np.array(data, np.float32, copy=True)
        else:
            self.buf = np.concatenate([self.buf, np.asarray(data, np.float32)])

    def next_window(self) -> Optional[np.ndarray]:
        """The window the engine should decode next, or None if drained."""
        if self.buf.size == 0:
            return None
        return self.buf[: min(self.buf.size, self.window_samples)]

    def _drain(self, n: int) -> None:
        n = max(0, min(int(n), self.buf.size))
        self.buf = self.buf[n:]
        self.time_offset_s += n / float(SAMPLE_RATE)

    def apply_result(self, dr: Optional[DecodingResult], final_chunk: bool) -> bool:
        """Consume one window's DecodingResult: drain audio, collect text.

        Returns True if another window should be decoded now, False when
        decoding must pause for more audio or the buffer is drained.
        Emitted text accumulates in ``self.pending_text``.
        """
        st = self.engine.st
        slice_len = min(self.buf.size, self.window_samples)
        window_offset = self.time_offset_s

        if dr is None:
            # All temperatures failed quality gates (model.rs:90-93).
            self._drain(slice_len)
            return self.buf.size > 0

        if dr.no_speech_prob > NO_SPEECH_THRESHOLD and dr.avg_logprob < LOGPROB_THRESHOLD:
            self._drain(slice_len)
            return self.buf.size > 0

        if dr.tokens and dr.tokens[-1] != st.eot:
            # Deviation 1: silence probe fired; drain.
            self._drain(slice_len)
            return self.buf.size > 0

        segs = list(
            inclusive_segments(dr.tokens, lambda t: t > st.no_timestamps or t == st.eot)
        )
        if not segs:
            # Deviation 2: no consumable segment; drain.
            self._drain(slice_len)
            return self.buf.size > 0

        size_before = self.buf.size
        stop_all = False  # break 'new_chunk in the reference
        for tokens in segs:
            s_timestamp = tokens[0] - st.no_timestamps - 1
            e_token = tokens[-1]

            if e_token == st.eot:
                if s_timestamp == 0 or final_chunk:
                    if slice_len == self.window_samples or final_chunk:
                        self._drain(slice_len)
                        logger.debug("Transcribed all remaining data")
                    else:
                        logger.debug("Transcribed, waiting for more data")
                        stop_all = True
                        break
                else:
                    pre_drain_len = self.buf.size
                    # A segment opening below <|0.00|> makes s_timestamp
                    # negative; the reference's u32 math wraps and drains
                    # the whole slice (model.rs:103,127) — match it.
                    drain = (
                        slice_len
                        if s_timestamp < 0
                        else min(s_timestamp * SAMPLES_PER_TIMESTAMP_TICK, slice_len)
                    )
                    self._drain(drain)
                    if pre_drain_len > slice_len:
                        logger.debug("Transcribed, getting a new slice")
                        break  # next window immediately
                    logger.debug("Transcribed, waiting for more data")
                    stop_all = True
                    break

            text = self.tokenizer.decode(tokens[1:-1], skip_special_tokens=True)
            if text and self.timestamps:
                tick_s = SAMPLES_PER_TIMESTAMP_TICK / float(SAMPLE_RATE)
                start = window_offset + s_timestamp * tick_s
                if e_token == st.eot:
                    end = window_offset + slice_len / float(SAMPLE_RATE)
                else:
                    end = window_offset + (e_token - st.no_timestamps - 1) * tick_s
                # Never emit a negative-duration interval.
                end = max(start, end)
                text = f"[{start:.2f}s -> {end:.2f}s]{text}"
            if text:
                self.pending_text.append(text)

        if stop_all:
            return False
        if self.buf.size == size_before:
            # Deviation 3: no segment drained or paused; force progress.
            self._drain(slice_len)
        return self.buf.size > 0

    def finish_call(self, final_chunk: bool) -> str:
        """End-of-transcribe bookkeeping; returns and clears pending text."""
        if final_chunk:
            self.lang.clear()
        out = "".join(self.pending_text)
        self.pending_text = []
        return out

    def transcribe(self, data: np.ndarray, final_chunk: bool) -> str:
        """Feed one chunk; return any newly-final transcript text."""
        self.feed(data)
        while (window := self.next_window()) is not None:
            dr = self._decode_window(window)
            if not self.apply_result(dr, final_chunk):
                break
        return self.finish_call(final_chunk)
