"""User-facing audio-input settings.

Mirrors the reference's ``norma::input`` module
(``src/input.rs:1-14``): a device selector plus the policy
applied when the selected device cannot be found.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Optional


class OnError(enum.Enum):
    """What to do when ``selected_device`` is not found."""

    ERROR = "error"
    TRY_DEFAULT = "try_default"


@dataclass
class Settings:
    """Input-stream settings (reference: ``input::Settings``).

    ``selected_device`` of ``None`` means "use the default input device".
    """

    selected_device: Optional[str] = None
    on_error: OnError = OnError.TRY_DEFAULT
    # Extension over the reference: allow injecting a non-microphone audio
    # source (file / synthetic) so end-to-end tests run hermetically.  When
    # set, device selection is bypassed entirely.
    source: object = field(default=None, compare=False)

    def to_dict(self) -> dict:
        return {
            "selected_device": self.selected_device,
            "on_error": self.on_error.value,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "Settings":
        return cls(
            selected_device=d.get("selected_device"),
            on_error=OnError(d.get("on_error", "try_default")),
        )
