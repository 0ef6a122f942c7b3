"""Error taxonomy.

Typed exceptions mirroring the reference's error enums:
``StartError`` / ``StopError`` (``src/lib.rs:264-290``) and
the whisper loader/model errors (``src/models/whisper/mod.rs:64-84``).
"""

from __future__ import annotations


class NormaError(Exception):
    """Base class for all norma-tpu errors."""


# --- Transcriber runtime errors (reference: lib.rs:264-290) ---------------
class StopError(NormaError):
    pass


class NoStreamRunning(StopError):
    def __init__(self) -> None:
        super().__init__("No stream is currently running")


class StartError(NormaError):
    pass


class TranscriberDown(StartError):
    def __init__(self) -> None:
        super().__init__(
            "The transcriber is down, it may have crashed; call join() to see why"
        )


class TranscriberRunning(StartError):
    def __init__(self) -> None:
        super().__init__(
            "The transcriber is already running; stop it before starting again"
        )


class DeviceError(StartError):
    def __init__(self) -> None:
        super().__init__("Failed to find an available input device")


class SelectedDeviceNotFound(StartError):
    def __init__(self) -> None:
        super().__init__(
            "Failed to find the selected device among the available devices"
        )


class NoConfigFound(StartError):
    def __init__(self) -> None:
        super().__init__("No (supported) config was found for the selected device")


class BuildStreamError(StartError):
    pass


# --- Whisper model errors (reference: whisper/mod.rs:64-84) ---------------
class WhisperError(NormaError):
    pass


class TokenIdError(WhisperError):
    def __init__(self, token: str) -> None:
        super().__init__(f"Failed to get token ID for: {token}")
        self.token = token


class LoadTokenizerError(WhisperError):
    pass


class MelBinsError(WhisperError):
    def __init__(self, n: int) -> None:
        super().__init__(f"Unexpected number of mel bins (num_mel_bins), got: {n}")
        self.num_mel_bins = n


class ResponsivenessError(WhisperError):
    def __init__(self) -> None:
        super().__init__("The responsiveness must be at least 1 second and at most 30")


class TranscriberError(NormaError):
    """Unrecoverable error raised from Model.transcribe (reference: model.rs:44-46)."""
