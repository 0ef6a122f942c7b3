"""Model abstractions: the ``Model`` trait and device selection
(``norma_tpu/models/__init__.py``; reference ``models/mod.rs:24-56``)."""

from __future__ import annotations

import abc
from dataclasses import dataclass

import numpy as np
import torch


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


class Model(abc.ABC):
    """A runnable transcription model (reference: Model trait, mod.rs:24-34).

    ``dtype`` is the PCM sample dtype the model consumes.
    """

    SAMPLE_RATE: int = 16_000
    dtype = np.float32

    @abc.abstractmethod
    def transcribe(self, data: np.ndarray, final_chunk: bool) -> str:
        """Consume one chunk of PCM; return newly-final transcript text."""


__all__ = ["Model", "SelectedDevice"]
