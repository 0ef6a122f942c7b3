"""Port log-mel frontend vs the JAX function and the numpy reference."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import n, t

from norma_tpu.frontend.mel import log_mel_reference
from norma_tpu.frontend.mel import log_mel_spectrogram as jax_log_mel
from norma_tpu.frontend.mel import prepare_audio
from norma_tpu_torch.frontend import mel as port_mel

ATOL = 2e-4  # f32 rFFT in two libraries; log10 of the mel power


def _audio(seed, seconds=2.0):
    rng = np.random.default_rng(seed)
    k = int(seconds * 16000)
    tt = np.arange(k) / 16000.0
    return (0.2 * np.sin(2 * np.pi * 330 * tt) + 0.05 * rng.standard_normal(k)).astype(np.float32)


@pytest.mark.parametrize("n_mels", [80, 128])
@pytest.mark.parametrize("center", [False, True])
def test_matches_jax(n_mels, center):
    frames = 300
    a = np.stack([prepare_audio(_audio(s), n_frames=frames) for s in (0, 1)])
    want = jax_log_mel(jnp.asarray(a), n_mels=n_mels, n_frames=frames, center=center)
    got = port_mel.log_mel_spectrogram(t(a), n_mels=n_mels, n_frames=frames, center=center)
    assert tuple(got.shape) == (2, n_mels, frames)
    np.testing.assert_allclose(n(got), n(want), atol=ATOL, rtol=0)


@pytest.mark.parametrize("n_mels", [80, 128])
def test_matches_numpy_reference_full_window(n_mels):
    a = _audio(2, seconds=7.0)
    want = log_mel_reference(a, n_mels=n_mels)
    got = port_mel.log_mel_spectrogram(t(port_mel.prepare_audio(a))[None], n_mels=n_mels)
    np.testing.assert_allclose(n(got)[0], want, atol=ATOL, rtol=0)


def test_per_row_clamp_and_short_audio():
    # The dynamic-range clamp is per row: a loud row must not floor a quiet one.
    a = np.stack([prepare_audio(_audio(3) * s, n_frames=100) for s in (1.0, 1e-3)])
    both = port_mel.log_mel_spectrogram(t(a), n_frames=100)
    solo = port_mel.log_mel_spectrogram(t(a[1:]), n_frames=100)
    np.testing.assert_allclose(n(both)[1], n(solo)[0], atol=1e-6)
    with pytest.raises(ValueError, match="too short"):
        port_mel.log_mel_spectrogram(torch.zeros(1, 1000), n_frames=100)
