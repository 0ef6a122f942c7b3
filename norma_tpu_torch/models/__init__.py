"""Model abstractions: the traits, device selection and common parameters
(``norma_tpu/models/__init__.py``; reference ``models/mod.rs``):

  - ``ModelDefinition`` / ``Model`` traits (mod.rs:13-34)
  - ``SelectedDevice``     (mod.rs:38-56), with a CUDA variant
  - ``CommonModelParams``  (mod.rs:58-117) with the same clamping rules
"""

from __future__ import annotations

import abc
import logging
from dataclasses import dataclass

import numpy as np
import torch

logger = logging.getLogger(__name__)

# It would be insanely wasteful to have a chunk below this (mod.rs:59).
MIN_CHUNK_LEN = 100
# The recycled ring reserves 2 slots (mod.rs:61).
MIN_DATA_BUF_SIZE = 2
MIN_STRING_BUF_SIZE = 1


@dataclass(frozen=True)
class SelectedDevice:
    """Accelerator selection (reference: SelectedDevice, mod.rs:38-56).

    ``kind``: "auto" | "cpu" | "cuda".  ``ordinal`` picks the card on a
    multi-GPU host (the reference's Cuda(usize)).
    """

    kind: str = "auto"
    ordinal: int = 0

    @classmethod
    def cpu(cls) -> "SelectedDevice":
        return cls("cpu", 0)

    @classmethod
    def cuda(cls, ordinal: int = 0) -> "SelectedDevice":
        return cls("cuda", ordinal)

    @classmethod
    def auto(cls) -> "SelectedDevice":
        return cls("auto", 0)

    def to_torch_device(self) -> torch.device:
        if self.kind == "cpu":
            return torch.device("cpu")
        if self.kind == "cuda":
            # An explicit CUDA choice never lands on the CPU (the reference's
            # Cuda variant errors when CUDA is unavailable, mod.rs:47-55).
            if not torch.cuda.is_available():
                raise RuntimeError("SelectedDevice.cuda(): CUDA is not available")
            n = torch.cuda.device_count()
            if self.ordinal >= n:
                raise ValueError(
                    f"SelectedDevice.cuda({self.ordinal}): only {n} CUDA device(s) present"
                )
            return torch.device("cuda", self.ordinal)
        if self.kind != "auto":
            raise ValueError(
                f"unknown device kind {self.kind!r} (expected 'auto', 'cpu' or 'cuda')"
            )
        if torch.cuda.is_available():
            return torch.device("cuda", min(self.ordinal, torch.cuda.device_count() - 1))
        return torch.device("cpu")


@dataclass
class CommonModelParams:
    """Per-model runtime knobs (reference: CommonModelParams, mod.rs:58-117).

    The constructor clamps exactly like the reference: max_chunk_len is
    floored at MIN_CHUNK_LEN, data_buffer_size gets +2 ring slack, and
    string_buffer_size is floored at 1.
    """

    # The hand-written __init__ below (which @dataclass keeps) is the only
    # constructor, so the fields carry no defaults.
    max_chunk_len: int
    data_buffer_size: int
    string_buffer_size: int

    def __init__(
        self,
        max_chunk_len: int = MIN_CHUNK_LEN,
        data_buffer_size: int = 1,
        string_buffer_size: int = MIN_STRING_BUF_SIZE,
    ) -> None:
        self.max_chunk_len = max(max_chunk_len, MIN_CHUNK_LEN)
        self.data_buffer_size = data_buffer_size + 2
        self.string_buffer_size = max(string_buffer_size, MIN_STRING_BUF_SIZE)

    def get_max_chunk_len(self) -> int:
        if self.max_chunk_len < MIN_CHUNK_LEN:
            logger.warning(
                "max_chunk_len=%d below minimum; using %d", self.max_chunk_len, MIN_CHUNK_LEN
            )
            return MIN_CHUNK_LEN
        return self.max_chunk_len

    def set_max_chunk_len(self, v: int) -> None:
        self.max_chunk_len = max(v, MIN_CHUNK_LEN)

    def set_data_buffer_size(self, v: int) -> None:
        self.data_buffer_size = v + 2

    def set_string_buffer_size(self, v: int) -> None:
        self.string_buffer_size = max(v, MIN_STRING_BUF_SIZE)

    # Optional (de)serialization, mirroring the reference's serde feature.
    def to_dict(self) -> dict:
        return {
            "max_chunk_len": self.max_chunk_len,
            "data_buffer_size": self.data_buffer_size,
            "string_buffer_size": self.string_buffer_size,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "CommonModelParams":
        p = cls(d["max_chunk_len"], 0, d["string_buffer_size"])
        p.data_buffer_size = d["data_buffer_size"]
        return p


class Model(abc.ABC):
    """A runnable transcription model (reference: Model trait, mod.rs:24-34).

    ``dtype`` is the PCM sample dtype the model consumes; the capture
    pipeline converts whatever the source produces into it.
    """

    SAMPLE_RATE: int = 16_000
    dtype = np.float32

    @abc.abstractmethod
    def transcribe(self, data: np.ndarray, final_chunk: bool) -> str:
        """Consume one chunk of PCM; return newly-final transcript text."""


class ModelDefinition(abc.ABC):
    """Builder for a Model (reference: ModelDefinition trait, mod.rs:13-22)."""

    @abc.abstractmethod
    def common_params(self) -> CommonModelParams: ...

    @abc.abstractmethod
    def blocking_try_to_model(self) -> Model: ...

    async def try_to_model(self) -> Model:
        """Async variant; by default runs the blocking builder in a thread."""
        import asyncio

        return await asyncio.to_thread(self.blocking_try_to_model)


from . import mock  # noqa: E402,F401
from . import whisper  # noqa: E402,F401

__all__ = [
    "CommonModelParams",
    "Model",
    "ModelDefinition",
    "SelectedDevice",
    "MIN_CHUNK_LEN",
    "mock",
    "whisper",
]
