from .filters import mel_filterbank
from .mel import hann_window, log_mel_spectrogram, pad_or_trim, prepare_audio

__all__ = [
    "mel_filterbank",
    "hann_window",
    "log_mel_spectrogram",
    "pad_or_trim",
    "prepare_audio",
]
