"""Log-mel spectrogram frontend (``norma_tpu/frontend/mel.py``).

Framing follows the reference's whisper.cpp/candle lineage by default:
frame ``i`` covers samples ``[i*hop, i*hop + n_fft)`` with no center
padding (``center=False``); ``center=True`` follows OpenAI/HF
``torch.stft`` (reflect-padded, frames centered at ``i*hop``).

Pipeline per window:
  1. periodic hann window (length 400) applied per frame
  2. rFFT(400) -> power spectrum over 201 bins
  3. mel filter matmul ([n_mels, 201] @ [201, frames])
  4. log10(max(power_mel, 1e-10))
  5. clamp below at (row's global max - 8)
  6. (x + 4) / 4
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from ..constants import HOP_LENGTH, N_FFT, N_FRAMES, N_SAMPLES
from ..utils import default_device
from .filters import mel_filterbank


def hann_window(n: int = N_FFT) -> np.ndarray:
    """Periodic hann window, matching torch.hann_window(n, periodic=True)."""
    i = np.arange(n, dtype=np.float64)
    return (0.5 * (1.0 - np.cos(2.0 * np.pi * i / n))).astype(np.float32)


@functools.lru_cache(maxsize=16)
def _constants_on(n_mels: int, dev: torch.device):
    """(hann window, mel filterbank) on ``dev``, copied once per device: a
    window captured as a CUDA graph copies nothing from the host."""
    return torch.from_numpy(hann_window()).to(dev), torch.from_numpy(mel_filterbank(n_mels)).to(dev)


def pad_or_trim(audio: np.ndarray, length: int = N_SAMPLES) -> np.ndarray:
    """Zero-pad or truncate a 1-D PCM array to ``length`` samples."""
    audio = np.asarray(audio, dtype=np.float32)
    if audio.shape[-1] >= length:
        return audio[..., :length]
    pad = length - audio.shape[-1]
    return np.pad(audio, [(0, 0)] * (audio.ndim - 1) + [(0, pad)])


def prepare_audio(audio: np.ndarray, n_frames: int = N_FRAMES) -> np.ndarray:
    """Zero-pad raw PCM so that ``n_frames`` full frames can be extracted.

    The last frame starts at ``(n_frames-1)*hop`` and reads ``n_fft`` samples,
    so the padded length is ``(n_frames-1)*hop + n_fft`` (480_240 for 30s).
    """
    need = (n_frames - 1) * HOP_LENGTH + N_FFT
    return pad_or_trim(np.asarray(audio, dtype=np.float32), need)


@torch.no_grad()
def log_mel_spectrogram(
    audio: torch.Tensor,
    n_mels: int = 80,
    n_frames: int = N_FRAMES,
    center: bool = False,
) -> torch.Tensor:
    """Whisper log-mel features.

    audio: [B, n_samples] (or [n_samples]) f32 PCM at 16 kHz, holding at
    least ``(n_frames - 1) * hop + n_fft`` samples (see
    :func:`prepare_audio`).  Returns [B, n_mels, n_frames] f32 on
    ``audio``'s device.
    """
    if audio.dim() == 1:
        audio = audio[None]
    audio = audio.to(torch.float32)
    dev = audio.device
    if center:
        audio = F.pad(
            audio[:, None, : n_frames * HOP_LENGTH],
            (N_FFT // 2, N_FFT // 2),
            mode="reflect",
        )[:, 0]
    need = (n_frames - 1) * HOP_LENGTH + N_FFT
    if audio.shape[1] < need:
        raise ValueError(
            f"audio too short: {audio.shape[1]} < {need}; use prepare_audio"
        )
    frames = audio.unfold(1, N_FFT, HOP_LENGTH)[:, :n_frames]  # [B, T, n_fft]
    window, filters = _constants_on(n_mels, dev)
    frames = frames * window
    spec = torch.fft.rfft(frames, n=N_FFT, dim=-1)  # [B, T, 201]
    power = spec.real.square() + spec.imag.square()
    mel = torch.matmul(filters, power.transpose(1, 2))  # [B, n_mels, T]
    log_spec = torch.log10(torch.clamp(mel, min=1e-10))
    log_max = log_spec.amax(dim=(1, 2), keepdim=True)
    log_spec = torch.maximum(log_spec, log_max - 8.0)
    return (log_spec + 4.0) / 4.0


def pcm_to_mel(audio: np.ndarray, n_mels: int = 80, device=None) -> torch.Tensor:
    """Host-convenience wrapper: raw PCM window -> [1, n_mels, N_FRAMES] on
    ``device`` (None: the card where there is one, else the CPU)."""
    pcm = torch.from_numpy(prepare_audio(audio)).to(default_device(device))
    return log_mel_spectrogram(pcm, n_mels=n_mels)


def log_mel_reference(audio: np.ndarray, n_mels: int = 80) -> np.ndarray:
    """Slow float64 numpy reference of the frontend, frame by frame (the
    check on :func:`log_mel_spectrogram` and the log-mel kernel)."""
    audio = prepare_audio(audio)
    window = hann_window().astype(np.float64)
    filters = mel_filterbank(n_mels).astype(np.float64)
    frames = np.stack(
        [
            audio[i * HOP_LENGTH : i * HOP_LENGTH + N_FFT].astype(np.float64) * window
            for i in range(N_FRAMES)
        ]
    )
    spec = np.fft.rfft(frames, axis=-1)
    power = spec.real**2 + spec.imag**2
    mel = filters @ power.T  # [n_mels, n_frames]
    log_spec = np.log10(np.maximum(mel, 1e-10))
    log_spec = np.maximum(log_spec, log_spec.max() - 8.0)
    return ((log_spec + 4.0) / 4.0).astype(np.float32)
