"""The port's fused log-mel frontend (ops/mel_pallas.py) vs the JAX
package, on the CPU (where log_mel_pallas runs its plain version).

  - the DFT matrices are the JAX package's, bit for bit;
  - log_mel_dft matches JAX's log_mel_dft and log_mel_pallas in interpret
    mode, at 80 and 128 mels, B = 1 and 2.  Tolerance 1e-4 in whisper
    units: the f32 matmuls of the same matrices sum in other orders (MKL
    vs XLA's CPU dot), and log10 magnifies the relative error of the
    lowest-power bins (measured: a few elements in 10^5 at ~3e-5, the rest
    below 1e-5);
  - it matches the port's own rFFT frontend (frontend/mel.py) at
    tests/test_mel_pallas.py's bound between the two algorithms (5e-4).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import n, t

from norma_tpu.constants import N_FRAMES
from norma_tpu.ops import mel_pallas as jm
from norma_tpu_torch.frontend.mel import log_mel_spectrogram, prepare_audio
from norma_tpu_torch.ops import mel_pallas as pm


def _audio(seconds=1.0, seed=0):
    rng = np.random.default_rng(seed)
    sr = 16_000
    tt = np.arange(int(seconds * sr)) / sr
    return (0.4 * np.sin(2 * np.pi * 440 * tt) + 0.02 * rng.standard_normal(len(tt))).astype(np.float32)


@pytest.mark.parametrize("n_mels", [80, 128])
def test_dft_mats_bit_equal(n_mels):
    for a, b in zip(pm._dft_mats(n_mels), jm._dft_mats(n_mels)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("B", [1, 2])
@pytest.mark.parametrize("n_mels", [80, 128])
def test_log_mel_matches_jax(n_mels, B):
    audio = np.stack([pm.pad_for_pallas(_audio(seed=s)) for s in range(B)])
    np.testing.assert_array_equal(audio, np.stack([jm.pad_for_pallas(_audio(seed=s)) for s in range(B)]))
    want = np.asarray(jm.log_mel_dft(jnp.asarray(audio), n_mels=n_mels))
    got = pm.log_mel_pallas(t(audio), n_mels=n_mels)
    assert got.dtype == torch.float32 and tuple(got.shape) == (B, n_mels, N_FRAMES)
    np.testing.assert_array_equal(n(got), n(pm.log_mel_dft(t(audio), n_mels=n_mels)))
    np.testing.assert_allclose(n(got), want, atol=1e-4)
    assert np.mean(np.abs(n(got) - want) <= 1e-5) > 0.999
    kernel = np.asarray(jm.log_mel_pallas(jnp.asarray(audio), n_mels=n_mels, interpret=True))
    np.testing.assert_allclose(n(got), kernel, atol=1e-4)


@pytest.mark.parametrize("n_mels", [80, 128])
def test_log_mel_matches_rfft_frontend(n_mels):
    raw = _audio(seed=3)
    got = pm.log_mel_pallas(t(pm.pad_for_pallas(raw)), n_mels=n_mels)
    ref = log_mel_spectrogram(t(prepare_audio(raw)), n_mels=n_mels)
    np.testing.assert_allclose(n(got), n(ref), atol=5e-4)


def test_one_dim_audio_and_launch_count():
    a = pm.pad_for_pallas(_audio(0.5, seed=4))
    before = pm.log_mel_pallas.launches
    one = pm.log_mel_pallas(t(a))
    assert tuple(one.shape) == (1, 80, N_FRAMES) and pm.log_mel_pallas.launches == before
    np.testing.assert_array_equal(n(one), n(pm.log_mel_pallas(t(a[None]))))


def test_rejects_short_or_wrong_audio():
    with pytest.raises(ValueError, match="pad_for_pallas"):
        pm.log_mel_pallas(torch.zeros(1, 16_000))
    with pytest.raises(TypeError):
        pm.log_mel_pallas(torch.zeros(1, (N_FRAMES + 3) * 160, dtype=torch.float64))
    with pytest.raises(ValueError, match="device"):
        pm.log_mel_pallas(torch.zeros(1, (N_FRAMES + 3) * 160, device="meta"))
