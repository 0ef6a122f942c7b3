"""Fused log-mel frontend as one kernel (``norma_tpu/ops/mel_pallas.py``).

The whole frontend (framing, hann-folded DFT, power spectrum, mel
filterbank, log10, the dynamic-range clamp) as one pass, with the DFT
written as two products against precomputed cos/sin matrices
(:func:`_dft_mats`):

  - :func:`log_mel_dft` — the plain PyTorch version (the CPU path and the
    kernel's oracle): the frame matrix, three exact f32 matmuls, log10 and
    :func:`_epilogue`'s clamp;
  - :func:`log_mel_pallas` — the wrapper: the CUDA kernel
    (``csrc/log_mel.cu``: frames read by stride from the padded PCM, the
    DFT on TF32 tensor cores in three error-compensated passes, the mel
    projection over each filter's bin range, then a second launch for the
    clamp) for CUDA tensors, the plain version for CPU tensors; any other
    device raises.  ``log_mel_pallas.launches`` counts kernel launches.

The kernel's tables come from the same matrices: :func:`_dft_frags` (the
cos/sin in the kernel's mma fragment order) and :func:`_mel_ranges`
(each filter's first bin, bin count and weights).  The serving path keeps
``frontend/mel.py``'s ``torch.fft`` (the JAX package's frontend is its
rFFT too); this kernel is the port of the TPU one, held against both by the
tests and the chip smoke run.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..constants import HOP_LENGTH, N_FFT, N_FRAMES, N_FREQS
from ..frontend.filters import mel_filterbank
from ..frontend.mel import hann_window
from . import _build, inference_only

# The matrices' padded bin count (201 -> 256, the JAX package's lane pad).
_KP = 256


@functools.lru_cache(maxsize=4)
def _dft_mats(n_mels: int):
    """Hann-folded DFT cos/sin matrices [400, 256] and the padded mel matrix
    [256, n_mels], f32 (float64 arithmetic, one rounding; zero beyond bin
    201) — the JAX package's ``_dft_mats``."""
    j = np.arange(N_FFT, dtype=np.float64)[:, None]
    k = np.arange(N_FREQS, dtype=np.float64)[None, :]
    ang = 2.0 * np.pi * j * k / N_FFT
    w = hann_window().astype(np.float64)[:, None]
    cos_m = np.zeros((N_FFT, _KP), np.float32)
    sin_m = np.zeros((N_FFT, _KP), np.float32)
    cos_m[:, :N_FREQS] = (w * np.cos(ang)).astype(np.float32)
    sin_m[:, :N_FREQS] = (w * np.sin(ang)).astype(np.float32)
    mel_p = np.zeros((_KP, n_mels), np.float32)
    mel_p[:N_FREQS, :] = mel_filterbank(n_mels).T
    return cos_m, sin_m, mel_p


@functools.lru_cache(maxsize=8)
def _mats_on(n_mels: int, dev: torch.device):
    """:func:`_dft_mats` on ``dev`` (copied once per device)."""
    return tuple(torch.from_numpy(m).to(dev) for m in _dft_mats(n_mels))


# csrc/log_mel.cu's launch shape: a block of 13 warps per 64 frames of one
# row, warp w owning bins 16w .. 16w + 15 (208 bins), 50 k8 steps of the
# 400 samples; shared memory holds the block's samples split hi/lo, in hop
# chunks at a pitch of 164 floats, and a ring of 4 k steps of each
# thread's 32 bytes of the fragment table.
LM_FRAMES, LM_WARPS, LM_KSTEPS, LM_PITCH, LM_STAGES = 64, 13, N_FFT // 8, 164, 4


@functools.lru_cache(maxsize=1)
def _dft_frags() -> np.ndarray:
    """The hann-folded cos/sin of :func:`_dft_mats` in the kernel's mma
    fragment order, [warp 13][k step 50][half 2][lane 32][4] f32.  Lane
    (g, t) = (lane // 4, lane % 4) of warp w at k step s holds, for the
    tiles cos bins 16w + 0..7, cos 16w + 8..15 (half 0), sin 16w + 0..7,
    sin 16w + 8..15 (half 1), the B fragment of ``mma.m16n8k8``: b0 =
    sample 8s + t and b1 = sample 8s + t + 4 of bin (tile start + g).  A
    half is 512 contiguous bytes, one 16-byte copy a lane."""
    cos_m, sin_m, _ = _dft_mats(80)
    w = np.arange(LM_WARPS)[:, None, None, None]
    ks = np.arange(LM_KSTEPS)[None, :, None, None]
    lane = np.arange(32)[None, None, :, None]
    i = np.arange(8)[None, None, None, :]
    k = 8 * ks + lane % 4 + 4 * (i % 2)
    n = 16 * w + 8 * ((i // 2) % 2) + lane // 4
    v = np.where(i < 4, cos_m[k, n], sin_m[k, n]).astype(np.float32)  # [w, ks, lane, 8]
    return np.ascontiguousarray(v.reshape(LM_WARPS, LM_KSTEPS, 32, 2, 4).transpose(0, 1, 3, 2, 4))


@functools.lru_cache(maxsize=4)
def _mel_ranges(n_mels: int):
    """Each mel filter's bins as (start [n_mels] int32, count [n_mels]
    int32, weights [n_mels, max count] f32): filter m is ``mel_p``'s column
    m over bins start .. start + count - 1 (its first to its last nonzero,
    zero-padded past count; an empty filter has count 0)."""
    mel_p = _dft_mats(n_mels)[2][:N_FREQS]
    start = np.zeros(n_mels, np.int32)
    count = np.zeros(n_mels, np.int32)
    for m in range(n_mels):
        nz = np.flatnonzero(mel_p[:, m])
        if nz.size:
            start[m], count[m] = nz[0], nz[-1] - nz[0] + 1
    weights = np.zeros((n_mels, max(int(count.max()), 1)), np.float32)
    for m in range(n_mels):
        weights[m, : count[m]] = mel_p[start[m] : start[m] + count[m], m]
    return start, count, weights


@functools.lru_cache(maxsize=8)
def _kernel_tables_on(n_mels: int, dev: torch.device):
    """(fragment-order cos/sin, mel start, count, weights) on ``dev``."""
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in (_dft_frags(), *_mel_ranges(n_mels)))


def _as_batch(audio: torch.Tensor, n_frames: int) -> torch.Tensor:
    if audio.dim() == 1:
        audio = audio[None]
    need = (n_frames + 3) * HOP_LENGTH
    if audio.dim() != 2 or audio.shape[1] < need:
        raise ValueError(f"audio must be [B, >= {need}] (pad_for_pallas), got {tuple(audio.shape)}")
    if audio.dtype != torch.float32:
        raise TypeError(f"audio must be f32, got {audio.dtype}")
    return audio[:, :need]


def _epilogue(log_spec_tm: torch.Tensor) -> torch.Tensor:
    """Global-max clamp and whisper scaling; [B, T, M] -> [B, M, T]."""
    log_spec = log_spec_tm.transpose(1, 2)
    mx = log_spec.amax(dim=(1, 2), keepdim=True)
    return (torch.maximum(log_spec, mx - 8.0) + 4.0) / 4.0


@torch.no_grad()
def log_mel_dft(audio: torch.Tensor, n_mels: int = 80, n_frames: int = N_FRAMES) -> torch.Tensor:
    """Plain version: [B, samples] f32 (>= (n_frames + 3) * hop of them)
    -> [B, n_mels, n_frames] whisper-scale log-mel."""
    audio = _as_batch(audio, n_frames)
    cos_m, sin_m, mel_p = _mats_on(n_mels, audio.device)
    frames = audio.unfold(1, N_FFT, HOP_LENGTH)[:, :n_frames]  # [B, T, 400]
    re = torch.matmul(frames, cos_m)
    im = torch.matmul(frames, sin_m)
    mel = torch.matmul(re * re + im * im, mel_p)
    return _epilogue(torch.log(torch.clamp(mel, min=1e-10)) / np.float32(np.log(10.0)))


@inference_only
def log_mel_pallas(audio: torch.Tensor, n_mels: int = 80, n_frames: int = N_FRAMES) -> torch.Tensor:
    """Same contract as :func:`log_mel_dft`.  CUDA tensors launch the
    kernel, CPU tensors run the plain version."""
    audio = _as_batch(audio, n_frames)
    dev = audio.device
    if dev.type == "cpu":
        return log_mel_dft(audio, n_mels, n_frames)
    if dev.type != "cuda":
        raise ValueError(f"log_mel_pallas: unsupported device {dev}")
    if audio.stride(1) != 1:
        audio = audio.contiguous()
    B = audio.shape[0]
    frags, start, count, weights = _kernel_tables_on(n_mels, dev)
    out = torch.empty((B, n_mels, n_frames), dtype=torch.float32, device=dev)
    row_max = torch.empty(B, dtype=torch.int32, device=dev)  # zeroed by the launcher
    _build.launch(
        "norma_log_mel", log_mel_pallas, dev,
        audio.data_ptr(), audio.stride(0), audio.shape[1], frags.data_ptr(), start.data_ptr(),
        count.data_ptr(), weights.data_ptr(), weights.shape[1], row_max.data_ptr(), out.data_ptr(),
        B, n_frames, n_mels,
    )
    return out


log_mel_pallas.launches = 0


def pad_for_pallas(audio: np.ndarray, n_frames: int = N_FRAMES) -> np.ndarray:
    """Zero-pad (or trim) PCM to the (n_frames + 3) * hop samples
    :func:`log_mel_pallas` / :func:`log_mel_dft` read."""
    need = (n_frames + 3) * HOP_LENGTH
    audio = np.asarray(audio, np.float32)[..., :need]
    pad = need - audio.shape[-1]
    if pad:
        audio = np.pad(audio, [(0, 0)] * (audio.ndim - 1) + [(0, pad)])
    return audio
