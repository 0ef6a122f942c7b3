"""Monolingual Whisper definitions (``norma_tpu/models/whisper/monolingual.py``;
reference ``src/models/whisper/monolingual.rs``): the 8 English checkpoints
and the MultiAsMono escape hatch, pinned HF repo ids/revisions, and the
validated Definition builder (responsiveness/buffer setters with the same
clamps).  ``dtype`` takes a torch dtype.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass
from datetime import timedelta
from typing import Optional, Union

import torch

from ...constants import SAMPLE_RATE, TRANSCRIBE_TOKEN
from ...errors import ResponsivenessError
from .. import CommonModelParams, ModelDefinition, SelectedDevice
from . import VocabVersion
from .languages import Language
from .loader import apply_definition_ext, build_model, definition_ext_to_dict
from .model import WhisperModel


class ModelType(enum.Enum):
    """Reference: monolingual.rs:32-46."""

    QUANTIZED_TINY_EN = "quantized_tiny_en"
    TINY_EN = "tiny_en"
    BASE_EN = "base_en"
    SMALL_EN = "small_en"
    MEDIUM_EN = "medium_en"
    DISTIL_MEDIUM_EN = "distil_medium_en"
    DISTIL_LARGE_EN_V2 = "distil_large_en_v2"
    DISTIL_LARGE_EN_V3 = "distil_large_en_v3"  # the default

    def id(self) -> str:
        """HF repo id (monolingual.rs:49-61)."""
        return {
            ModelType.QUANTIZED_TINY_EN: "lmz/candle-whisper",
            ModelType.TINY_EN: "openai/whisper-tiny.en",
            ModelType.BASE_EN: "openai/whisper-base.en",
            ModelType.SMALL_EN: "openai/whisper-small.en",
            ModelType.MEDIUM_EN: "openai/whisper-medium.en",
            ModelType.DISTIL_MEDIUM_EN: "distil-whisper/distil-medium.en",
            ModelType.DISTIL_LARGE_EN_V2: "distil-whisper/distil-large-v2",
            ModelType.DISTIL_LARGE_EN_V3: "distil-whisper/distil-large-v3",
        }[self]

    def rev(self) -> str:
        """Pinned revision (monolingual.rs:63-75; some are PR refs)."""
        return {
            ModelType.TINY_EN: "refs/pr/15",
            ModelType.BASE_EN: "refs/pr/13",
            ModelType.SMALL_EN: "refs/pr/10",
        }.get(self, "main")

    def quantized_ext(self) -> Optional[str]:
        return "tiny-en" if self is ModelType.QUANTIZED_TINY_EN else None

    def language(self) -> Language:
        return Language.ENGLISH

    def vocab_version(self) -> VocabVersion:
        """monolingual.rs:99-110."""
        if self in (
            ModelType.QUANTIZED_TINY_EN,
            ModelType.TINY_EN,
            ModelType.BASE_EN,
            ModelType.SMALL_EN,
            ModelType.MEDIUM_EN,
        ):
            return VocabVersion.EN_V1
        if self in (ModelType.DISTIL_MEDIUM_EN, ModelType.DISTIL_LARGE_EN_V2):
            return VocabVersion.V1
        return VocabVersion.V2


@dataclass(frozen=True)
class MultiAsMono:
    """Treat a multilingual checkpoint as monolingual with a fixed language
    (reference: ModelType::MultiAsMono, monolingual.rs:42-45)."""

    model: "object"  # multilingual.ModelType (late import to avoid cycle)
    lang: Language

    def id(self) -> str:
        return self.model.id()

    def rev(self) -> str:
        return self.model.rev()

    def quantized_ext(self) -> Optional[str]:
        return self.model.quantized_ext()

    def language(self) -> Language:
        return self.lang

    def vocab_version(self) -> VocabVersion:
        return self.model.vocab_version()


class Definition(ModelDefinition):
    """Monolingual model definition (reference: monolingual.rs:113-174)."""

    def __init__(
        self,
        model: Union[ModelType, MultiAsMono] = ModelType.DISTIL_LARGE_EN_V3,
        device: SelectedDevice = SelectedDevice.auto(),
        *,
        local_dir: Optional[str] = None,
        dtype: torch.dtype = torch.float32,
        quantize_logits: "bool | str" = False,
        quantize_decoder: bool = False,
        quantize_encoder: bool = False,
        quantize_cross_kv: "bool | str" = False,
        quantize_self_kv: bool = False,
        mel_center: bool = False,
        timestamps: bool = False,
        draft: Optional[str] = None,
        draft_local_dir: Optional[str] = None,
        spec_k: "int | str" = 4,
        config_overrides: Optional[dict] = None,
    ) -> None:
        self.model = model
        self.device = device
        self.local_dir = local_dir
        # WhisperConfig knobs a checkpoint's config.json cannot carry —
        # the serving/perf levers (e.g. {"encoder_attn_impl": "jax_flash",
        # "cross_kv_impl": "chunked", "max_target_positions": 448}).
        # Validated against the config's fields at build time.
        self.config_overrides = dict(config_overrides) if config_overrides else None
        # Speculative decoding: ``draft`` is an HF repo id of a shallow
        # same-vocab checkpoint, or "auto" to pair the official distil
        # draft (medium.en only).  The model then decodes with the
        # speculative engine (decode/speculative.py).
        if draft == "auto":
            draft = {
                ModelType.MEDIUM_EN: "distil-whisper/distil-medium.en",
            }.get(model)
            if draft is None:
                raise ValueError(
                    f"no official distil draft for {model}; pass an "
                    "explicit draft repo id"
                )
        self.draft = draft
        self.draft_local_dir = draft_local_dir
        self.spec_k = spec_k
        self.dtype = dtype
        self.quantize_logits = quantize_logits
        # Full int8 decoder weights (implies quantize_logits).
        self.quantize_decoder = quantize_decoder
        # w8a8 encoder: the int8 GEMM for the window-dominant encoder
        # (changes numerics slightly; see model/quant.py quantize_encoder).
        self.quantize_encoder = quantize_encoder
        # int8 cross-attention K/V per window (decode-loop HBM lever at
        # batch; see model/whisper.py quantize_cross_kv).
        self.quantize_cross_kv = quantize_cross_kv
        # int8 SELF-attention KV cache (per-step HBM lever at long
        # max_target_positions; not combinable with draft= speculation).
        self.quantize_self_kv = quantize_self_kv
        # OpenAI/HF centered STFT framing instead of the reference's
        # whisper.cpp convention (see frontend/mel.py).
        self.mel_center = mel_center
        # Emit "[start -> end]" stream-absolute timestamps per segment.
        self.timestamps = timestamps
        # Defaults: 25s chunks, data/string buffers of 3 (monolingual.rs:128).
        self._common = CommonModelParams(SAMPLE_RATE * 25, 3, 3)

    def common_params(self) -> CommonModelParams:
        return self._common

    def set_responsiveness(self, period: Union[float, timedelta]) -> None:
        """How often the model attempts to decode, 1..=30 seconds
        (reference: monolingual.rs:146-156)."""
        if isinstance(period, timedelta):
            millis = period.total_seconds() * 1000.0
        else:
            millis = float(period) * 1000.0
        if not (1_000 <= millis <= 30_000):
            raise ResponsivenessError()
        self._common.set_max_chunk_len(int(SAMPLE_RATE * millis) // 1000)

    def set_data_buffer_size(self, size: int) -> None:
        self._common.set_data_buffer_size(size)

    def set_string_buffer_size(self, size: int) -> None:
        self._common.set_string_buffer_size(size)

    def _build_kwargs(self) -> dict:
        return dict(
            repo_id=self.model.id(),
            revision=self.model.rev(),
            quantized_ext=self.model.quantized_ext(),
            device=self.device,
            task_token_str=TRANSCRIBE_TOKEN,
            const_language_token_str=self.model.language().token(),
            local_dir=self.local_dir,
            dtype=self.dtype,
            quantize_logits=self.quantize_logits,
            quantize_decoder=self.quantize_decoder,
            quantize_encoder=self.quantize_encoder,
            quantize_cross_kv=self.quantize_cross_kv,
            quantize_self_kv=self.quantize_self_kv,
            mel_center=self.mel_center,
            timestamps=self.timestamps,
            draft_repo_id=self.draft,
            draft_local_dir=self.draft_local_dir,
            spec_k=self.spec_k,
            config_overrides=self.config_overrides,
        )

    def blocking_try_to_model(self) -> WhisperModel:
        return build_model(**self._build_kwargs())

    async def try_to_model(self) -> WhisperModel:
        """The build with the checkpoint files (and a draft's) resolved
        concurrently, then constructed off the event loop."""
        from .loader import build_model_async

        return await build_model_async(**self._build_kwargs())

    # Optional (de)serialization (reference serde feature, monolingual.rs:29).
    def to_dict(self) -> dict:
        model = (
            {"multi_as_mono": self.model.model.value, "lang": self.model.lang.value}
            if isinstance(self.model, MultiAsMono)
            else self.model.value
        )
        return {
            "model": model,
            "device": {"kind": self.device.kind, "ordinal": self.device.ordinal},
            "common_params": self._common.to_dict(),
            **definition_ext_to_dict(self),
        }

    @classmethod
    def from_dict(cls, d: dict) -> "Definition":
        from . import multilingual

        m = d["model"]
        if isinstance(m, dict):
            model = MultiAsMono(
                model=multilingual.ModelType(m["multi_as_mono"]),
                lang=Language(m["lang"]),
            )
        else:
            model = ModelType(m)
        dev = SelectedDevice(d["device"]["kind"], d["device"]["ordinal"])
        out = cls(model, dev)
        out._common = CommonModelParams.from_dict(d["common_params"])
        apply_definition_ext(out, d)
        return out
