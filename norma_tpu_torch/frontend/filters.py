"""Mel filterbank generation (copy of ``norma_tpu/frontend/filters.py``).

The standard Slaney-style mel filters (librosa ``filters.mel(sr=16000,
n_fft=400, n_mels=N)`` with slaney scale + slaney area normalization),
which is what OpenAI ships in whisper's ``mel_filters.npz``.
"""

from __future__ import annotations

import functools

import numpy as np

from ..constants import N_FFT, SAMPLE_RATE


def _hz_to_mel_slaney(freq: np.ndarray) -> np.ndarray:
    """Slaney mel scale: linear below 1 kHz, logarithmic above."""
    freq = np.asarray(freq, dtype=np.float64)
    f_sp = 200.0 / 3
    mels = freq / f_sp
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    log_region = freq >= min_log_hz
    mels = np.where(
        log_region,
        min_log_mel + np.log(np.maximum(freq, min_log_hz) / min_log_hz) / logstep,
        mels,
    )
    return mels


def _mel_to_hz_slaney(mels: np.ndarray) -> np.ndarray:
    mels = np.asarray(mels, dtype=np.float64)
    f_sp = 200.0 / 3
    freqs = mels * f_sp
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    log_region = mels >= min_log_mel
    freqs = np.where(
        log_region, min_log_hz * np.exp(logstep * (mels - min_log_mel)), freqs
    )
    return freqs


@functools.lru_cache(maxsize=4)
def mel_filterbank(
    n_mels: int, sample_rate: int = SAMPLE_RATE, n_fft: int = N_FFT
) -> np.ndarray:
    """Return the [n_mels, n_fft // 2 + 1] Slaney mel filter matrix (f32)."""
    n_freqs = n_fft // 2 + 1
    fft_freqs = np.linspace(0, sample_rate / 2, n_freqs, dtype=np.float64)

    mel_min = _hz_to_mel_slaney(0.0)
    mel_max = _hz_to_mel_slaney(sample_rate / 2.0)
    mel_pts = np.linspace(mel_min, mel_max, n_mels + 2)
    hz_pts = _mel_to_hz_slaney(mel_pts)

    fdiff = np.diff(hz_pts)
    ramps = hz_pts[:, None] - fft_freqs[None, :]

    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))

    # Slaney area normalization: each filter integrates to ~the same energy.
    enorm = 2.0 / (hz_pts[2 : n_mels + 2] - hz_pts[:n_mels])
    weights *= enorm[:, None]

    return weights.astype(np.float32)
