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
    tests/test_mel_pallas.py's bound between the two algorithms (5e-4);
  - the CUDA kernel's arithmetic, emulated here through its own tables and
    index formulas (the samples' hop chunks in shared memory, the mma
    fragments of the cos/sin, the per-mel bin ranges): three TF32 passes
    stay within that 5e-4 of JAX's log_mel_dft on a sine with noise, a
    1e-4 sine and 1e-5 noise before a loud tone; one pass does not.
"""

import re
from pathlib import Path

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


# -- The CUDA kernel's arithmetic (csrc/log_mel.cu), emulated on the CPU --------


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """cvt.rna.tf32.f32: f32 rounded to 10 mantissa bits, ties away from 0."""
    bits = x.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    bits = (bits + 0x1000) & 0xFFFFE000
    return torch.where(bits >= 2**31, bits - 2**32, bits).to(torch.int32).view(torch.float32)


def _kernel_samples(audio: np.ndarray, n_frames: int):
    """A [F, 400] frame matrix gathered as the kernel reads it: each block's
    samples in hop chunks at pitch LM_PITCH, frame f's logical column kk of
    k step s at chunk (f % 64) + 8s // 160, offset 8s % 160 + kk (a0..a3 =
    frame g / g + 8, column t / t + 4)."""
    hop = 160
    nb, chunks = -(-n_frames // pm.LM_FRAMES), pm.LM_FRAMES + -(-400 // hop) - 1
    sig = np.zeros((nb, chunks * pm.LM_PITCH), np.float32)
    i = np.arange(chunks * hop)
    for b in range(nb):
        s = b * pm.LM_FRAMES * hop + i
        sig[b, (i // hop) * pm.LM_PITCH + i % hop] = np.where(s < audio.size, audio[np.minimum(s, audio.size - 1)], 0)
    f = np.arange(n_frames)[:, None, None]
    ks = np.arange(pm.LM_KSTEPS)[None, :, None]
    kk = np.arange(8)[None, None, :]
    addr = (f % pm.LM_FRAMES + 8 * ks // hop) * pm.LM_PITCH + 8 * ks % hop + kk
    return torch.from_numpy(sig[f // pm.LM_FRAMES, addr].reshape(n_frames, -1))


def _kernel_matrix():
    """[400 logical k, 416] from the fragment table by the mma B fragment's
    rule (b0 = row t, b1 = row t + 4, column g of its n tile), columns
    ordered (warp, tile: cos 0, cos 1, sin 0, sin 1, g)."""
    fr = pm._dft_frags()  # [warp, k step, half, lane, 4]
    W, KS = fr.shape[:2]
    fr = fr.transpose(0, 1, 3, 2, 4).reshape(W, KS, 32, 8)  # [warp, k step, lane, 8]
    out = np.zeros((KS, 8, W, 4, 8), np.float32)  # [k step, logical k, warp, tile, g]
    for lane in range(32):
        g, t4 = lane // 4, lane % 4
        for tile in range(4):
            out[:, t4, :, tile, g] = fr[:, :, lane, 2 * tile].T
            out[:, t4 + 4, :, tile, g] = fr[:, :, lane, 2 * tile + 1].T
    return torch.from_numpy(out.reshape(KS * 8, W * 32))


def _reference_matrix():
    """[cos | sin] of _dft_mats in the kernel's column order, f32."""
    cos_m, sin_m, _ = pm._dft_mats(80)
    cs = np.stack([cos_m[:, :208], sin_m[:, :208]], 1).reshape(400, 2, pm.LM_WARPS, 2, 8)
    return torch.from_numpy(np.ascontiguousarray(cs.transpose(0, 2, 1, 3, 4)).reshape(400, -1))


def _kernel_emulation(audio: np.ndarray, n_mels: int, passes: int) -> np.ndarray:
    """log_mel.cu's result for one padded row: the DFT of tf32 hi/lo parts
    (passes 3: lo.hi + hi.lo + hi.hi; 1: hi.hi) summed in f32, the power, the mel projection over
    each filter's bin range in ascending bins, log10, and the clamp."""
    a, m = _kernel_samples(audio, N_FRAMES), _kernel_matrix()
    a_hi, m_hi = _tf32(a), _tf32(m)
    a_lo, m_lo = _tf32(a - a_hi), _tf32(m - m_hi)
    d = a_hi @ m_hi
    if passes == 3:
        d = a_lo @ m_hi + a_hi @ m_lo + d
    d = d.reshape(N_FRAMES, pm.LM_WARPS, 4, 8)
    re = d[:, :, :2].reshape(N_FRAMES, -1)  # bin 16 warp + 8 tile + g
    im = d[:, :, 2:].reshape(N_FRAMES, -1)
    power = re * re + im * im
    start, count, weights = pm._mel_ranges(n_mels)
    mel = torch.zeros(N_FRAMES, n_mels)
    for j in range(weights.shape[1]):
        live = torch.from_numpy(j < count)
        bins = torch.from_numpy(np.minimum(start + j, power.shape[1] - 1).astype(np.int64))
        mel = torch.where(live, mel + power[:, bins] * torch.from_numpy(weights[:, j]), mel)
    log_spec = torch.log10(torch.clamp(mel, min=1e-10)).T
    return n((torch.maximum(log_spec, log_spec.max() - 8.0) + 4.0) / 4.0)


def _signals():
    sr, rng = 16_000, np.random.default_rng(12)
    tt = np.arange(30 * sr) / sr
    loud = np.where(tt < 15, 1e-5 * rng.standard_normal(tt.size), 0.5 * np.sin(2 * np.pi * 1000 * tt))
    return {
        "sine_noise": 0.3 * np.sin(2 * np.pi * 220 * tt) + 0.02 * rng.standard_normal(tt.size),
        "quiet_sine": 1e-4 * np.sin(2 * np.pi * 440 * tt),
        "noise_then_tone": loud,
    }


def test_kernel_index_formulas_rebuild_the_dft():
    """The kernel's sample addressing and fragment table, through the mma
    fragment rules, give frames @ [cos | sin] of _dft_mats exactly (f64)."""
    ref = _reference_matrix()
    np.testing.assert_array_equal(n(_kernel_matrix()), n(ref))
    raw = pm.pad_for_pallas(_audio(2.0, seed=6))
    a = _kernel_samples(raw, 200).double()
    cos_m, sin_m, _ = pm._dft_mats(80)
    frames = torch.from_numpy(raw).unfold(0, 400, 160)[:200].double()
    d = (a @ ref.double()).reshape(200, pm.LM_WARPS, 4, 8)
    want_re = frames @ torch.from_numpy(cos_m[:, :208]).double()
    want_im = frames @ torch.from_numpy(sin_m[:, :208]).double()
    torch.testing.assert_close(d[:, :, :2].reshape(200, -1), want_re, rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(d[:, :, 2:].reshape(200, -1), want_im, rtol=1e-12, atol=1e-12)


def test_tf32_rounding_is_nearest_ties_away():
    """The kernel's split ((bits + 0x1000) & ~0x1fff, as _tf32 emulates it)
    is cvt.rna's rounding: to 10 mantissa bits, ties away from zero."""
    rng = np.random.default_rng(1)
    x = (rng.standard_normal(20000) * 10.0 ** rng.uniform(-8, 3, 20000)).astype(np.float32)
    ties = (1024.5 + np.arange(200)) * 2.0 ** np.arange(-30, 10, 0.2).astype(np.int64)  # 1 + (j + 0.5) / 1024 ulps
    x = np.concatenate([x, ties, -ties, [0.0, -0.0, 1.0, -1.0]]).astype(np.float32)
    got = n(_tf32(torch.from_numpy(x))).astype(np.float64)
    xd = x.astype(np.float64)
    ulp = np.exp2(np.floor(np.log2(np.where(xd == 0, 1.0, np.abs(xd)))) - 10)
    want = np.sign(xd) * np.floor(np.abs(xd) / ulp + 0.5) * ulp
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n_mels", [80, 128])
def test_three_tf32_passes_hold_the_frontend_bound(n_mels):
    worst_one = 0.0
    for name, sig in _signals().items():
        raw = pm.pad_for_pallas(sig.astype(np.float32))
        want = np.asarray(jm.log_mel_dft(jnp.asarray(raw[None]), n_mels=n_mels))[0]
        err3 = np.abs(_kernel_emulation(raw, n_mels, 3) - want).max()
        assert err3 <= 5e-4, (name, err3)
        worst_one = max(worst_one, np.abs(_kernel_emulation(raw, n_mels, 1) - want).max())
    assert worst_one > 5e-4  # why the kernel does not take one TF32 pass


@pytest.mark.parametrize("n_mels", [80, 128])
def test_mel_ranges_reproduce_the_filterbank(n_mels):
    start, count, weights = pm._mel_ranges(n_mels)
    mel_p = pm._dft_mats(n_mels)[2]
    dense = np.zeros_like(mel_p)
    for m in range(n_mels):
        dense[start[m] : start[m] + count[m], m] = weights[m, : count[m]]
    np.testing.assert_array_equal(dense, mel_p)
    assert (np.count_nonzero(mel_p, axis=0) <= count).all() and count.max() <= 16
    power = np.random.default_rng(n_mels).exponential(1.0, (64, 256)).astype(np.float32)
    ranged = np.zeros((64, n_mels), np.float32)
    for j in range(weights.shape[1]):
        live = j < count
        ranged += np.where(live, power[:, np.minimum(start + j, 255)] * weights[:, j], 0).astype(np.float32)
    np.testing.assert_allclose(ranged, power @ mel_p, rtol=1e-6)


def test_kernel_constants_match_cuda_source():
    """The LM_* constants the fragment table and this file's emulation are
    built from are the ones csrc/log_mel.cu launches with."""
    src = (Path(pm.__file__).parent.parent / "csrc" / "log_mel.cu").read_text()
    const = {k: int(v) for k, v in re.findall(r"constexpr int (\w+) = (\d+);", src)}
    assert (const["TF"], const["WARPS"], const["CP"], const["STAGES"]) == (
        pm.LM_FRAMES, pm.LM_WARPS, pm.LM_PITCH, pm.LM_STAGES)
    assert "KSTEPS = NFFT / 8;" in src and pm.LM_KSTEPS == 400 // 8
    assert 16 * pm.LM_WARPS >= 201 and pm._dft_frags().shape == (pm.LM_WARPS, pm.LM_KSTEPS, 2, 32, 4)
