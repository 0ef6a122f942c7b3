"""Multilingual Whisper definitions (``norma_tpu/models/whisper/multilingual.py``;
reference ``src/models/whisper/multilingual.rs``): the multilingual
checkpoints, the Transcribe/Translate task selection, and automatic
per-utterance language detection (reset on every final chunk).  ``dtype``
takes a torch dtype.
"""

from __future__ import annotations

import enum
from datetime import timedelta
from typing import Optional, Union

import torch

from ...constants import SAMPLE_RATE, TRANSCRIBE_TOKEN, TRANSLATE_TOKEN
from ...errors import ResponsivenessError
from .. import CommonModelParams, ModelDefinition, SelectedDevice
from . import VocabVersion
from .loader import apply_definition_ext, build_model, definition_ext_to_dict
from .model import WhisperModel


class Task(enum.Enum):
    """Reference: multilingual.rs:19-25."""

    TRANSCRIBE = "transcribe"
    TRANSLATE = "translate"

    def token(self) -> str:
        return TRANSCRIBE_TOKEN if self is Task.TRANSCRIBE else TRANSLATE_TOKEN


class ModelType(enum.Enum):
    """Reference: multilingual.rs:48-58."""

    QUANTIZED_TINY = "quantized_tiny"
    TINY = "tiny"
    BASE = "base"
    SMALL = "small"
    MEDIUM = "medium"  # the default
    LARGE = "large"
    LARGE_V2 = "large_v2"
    LARGE_V3 = "large_v3"
    # Extension beyond the reference's v0.0.3 list: the pruned-decoder
    # serving checkpoint (32-layer encoder, 4-layer decoder, V2 vocab) —
    # ~6x large-v3's decode speed at near-identical WER.
    LARGE_V3_TURBO = "large_v3_turbo"

    def id(self) -> str:
        return {
            ModelType.QUANTIZED_TINY: "lmz/candle-whisper",
            ModelType.TINY: "openai/whisper-tiny",
            ModelType.BASE: "openai/whisper-base",
            ModelType.SMALL: "openai/whisper-small",
            ModelType.MEDIUM: "openai/whisper-medium",
            ModelType.LARGE: "openai/whisper-large",
            ModelType.LARGE_V2: "openai/whisper-large-v2",
            ModelType.LARGE_V3: "openai/whisper-large-v3",
            ModelType.LARGE_V3_TURBO: "openai/whisper-large-v3-turbo",
        }[self]

    def rev(self) -> str:
        """Pinned revisions (multilingual.rs:75-88)."""
        return {
            ModelType.BASE: "refs/pr/22",
            ModelType.LARGE: "refs/pr/36",
            ModelType.LARGE_V2: "refs/pr/57",
        }.get(self, "main")

    def quantized_ext(self) -> Optional[str]:
        return "tiny" if self is ModelType.QUANTIZED_TINY else None

    def vocab_version(self) -> VocabVersion:
        return (
            VocabVersion.V2
            if self in (ModelType.LARGE_V3, ModelType.LARGE_V3_TURBO)
            else VocabVersion.V1
        )


class Definition(ModelDefinition):
    """Multilingual model definition (reference: multilingual.rs:108-191)."""

    def __init__(
        self,
        model: ModelType = ModelType.MEDIUM,
        device: SelectedDevice = SelectedDevice.auto(),
        task: Task = Task.TRANSCRIBE,
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
        self.task = task
        self.local_dir = local_dir
        # WhisperConfig knobs a checkpoint's config.json cannot carry —
        # the serving/perf levers (e.g. {"encoder_attn_impl": "jax_flash",
        # "cross_kv_impl": "chunked", "max_target_positions": 448}).
        # Validated against the config's fields at build time.
        self.config_overrides = dict(config_overrides) if config_overrides else None
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
        # Speculative decoding: ``draft`` is an HF repo id of a shallow
        # same-vocab checkpoint, or "auto" to pair the official distil
        # draft (large-v2/v3 only).  The model then decodes with the
        # speculative engine (decode/speculative.py).
        if draft == "auto":
            draft = {
                ModelType.LARGE_V2: "distil-whisper/distil-large-v2",
                ModelType.LARGE_V3: "distil-whisper/distil-large-v3",
            }.get(model)
            if draft is None:
                raise ValueError(
                    f"no official distil draft for {model}; pass an "
                    "explicit draft repo id"
                )
        self.draft = draft
        self.draft_local_dir = draft_local_dir
        self.spec_k = spec_k
        # OpenAI/HF centered STFT framing instead of the reference's
        # whisper.cpp convention (see frontend/mel.py).
        self.mel_center = mel_center
        # Emit "[start -> end]" stream-absolute timestamps per segment.
        self.timestamps = timestamps
        self._common = CommonModelParams(SAMPLE_RATE * 25, 3, 3)

    def common_params(self) -> CommonModelParams:
        return self._common

    def set_responsiveness(self, period: Union[float, timedelta]) -> None:
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
            task_token_str=self.task.token(),
            const_language_token_str=None,  # Detect mode
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

    # Optional (de)serialization (reference serde feature).
    def to_dict(self) -> dict:
        return {
            "model": self.model.value,
            "device": {"kind": self.device.kind, "ordinal": self.device.ordinal},
            "task": self.task.value,
            "common_params": self._common.to_dict(),
            **definition_ext_to_dict(self),
        }

    @classmethod
    def from_dict(cls, d: dict) -> "Definition":
        out = cls(
            ModelType(d["model"]),
            SelectedDevice(d["device"]["kind"], d["device"]["ordinal"]),
            Task(d["task"]),
        )
        out._common = CommonModelParams.from_dict(d["common_params"])
        apply_definition_ext(out, d)
        return out
