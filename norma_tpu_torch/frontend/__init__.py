from .filters import mel_filterbank
from .mel import (
    hann_window,
    log_mel_reference,
    log_mel_spectrogram,
    pad_or_trim,
    pcm_to_mel,
    prepare_audio,
)

__all__ = [
    "mel_filterbank",
    "hann_window",
    "log_mel_reference",
    "log_mel_spectrogram",
    "pad_or_trim",
    "pcm_to_mel",
    "prepare_audio",
]
