"""The port's centered mel against transformers' WhisperFeatureExtractor
(tests/test_mel_hf_parity.py's case), with no download: the extractor is
built from its constructor arguments.

``log_mel_spectrogram(center=True)`` reproduces the canonical OpenAI/HF
frontend to f32 rounding (atol 5e-4 on the log-mel values, the JAX
package's tolerance), pinning the framing, window, filterbank and
dynamic-range conventions against an outside oracle.
"""

import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")

from norma_tpu_torch.constants import N_SAMPLES  # noqa: E402
from norma_tpu_torch.frontend.mel import log_mel_spectrogram, pad_or_trim  # noqa: E402


@pytest.mark.parametrize("n_mels", [80, 128])
def test_centered_mel_matches_whisper_feature_extractor(n_mels):
    from transformers import WhisperFeatureExtractor

    fe = WhisperFeatureExtractor(feature_size=n_mels)
    rng = np.random.default_rng(0)
    t = np.arange(24_000) / 16_000
    audio = (0.4 * np.sin(2 * np.pi * 333 * t) + 0.05 * rng.standard_normal(len(t))).astype(np.float32)
    want = fe(audio, sampling_rate=16_000, return_tensors="np", padding="max_length").input_features[0]
    padded = torch.from_numpy(pad_or_trim(audio, N_SAMPLES))
    got = log_mel_spectrogram(padded, n_mels=n_mels, center=True)[0].numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=5e-4)
