"""The port's microphone config ranking and device selection
(``norma_tpu_torch/audio/device.py``, a copy of ``norma_tpu/audio/device.py``).

The six ranking and selection cases of ``tests/test_audio.py`` on the port,
each also held against the JAX package on the same inputs, and
``rank_configs`` against JAX's on seeded random config sets (exact: the
same order, element by element).
"""

import numpy as np
import pytest

import norma_tpu.audio as jax_audio
import norma_tpu.input as jax_input
from norma_tpu_torch.audio import SupportedConfig, rank_configs, select_device
from norma_tpu_torch.errors import DeviceError, SelectedDeviceNotFound
from norma_tpu_torch.input import OnError, Settings

FORMATS = ("i8", "i16", "i32", "i64", "u8", "u16", "u32", "u64", "f32", "f64")


def _cfg(minr, maxr, fmt, ch):
    return SupportedConfig(minr, maxr, fmt, ch)


def _jax_ranked(configs, rate, dtype):
    """JAX's ranking of the same configs, as the port's tuples."""
    js = [jax_audio.SupportedConfig(c.min_sample_rate, c.max_sample_rate, c.sample_format, c.channels)
          for c in configs]
    return [(c.min_sample_rate, c.max_sample_rate, c.sample_format, c.channels)
            for c in jax_audio.rank_configs(js, rate, dtype)]


def _ranked(configs, rate, dtype):
    out = rank_configs(configs, rate, dtype)
    assert [(c.min_sample_rate, c.max_sample_rate, c.sample_format, c.channels) for c in out] == _jax_ranked(
        configs, rate, dtype)
    return out


def test_rank_prefers_model_rate_support():
    a = _cfg(8_000, 48_000, "i16", 2)  # supports 16k
    b = _cfg(44_100, 48_000, "f32", 1)  # does not
    assert _ranked([b, a], 16_000, np.float32)[-1] == a  # best last (popped from tail)


def test_rank_prefers_matching_format_when_rate_supported():
    a = _cfg(8_000, 48_000, "i16", 1)
    b = _cfg(8_000, 48_000, "f32", 1)
    assert _ranked([a, b], 16_000, np.float32)[-1] == b


def test_rank_fallback_prefers_f64_then_float_then_mono():
    a = _cfg(44_100, 48_000, "i16", 1)
    b = _cfg(44_100, 48_000, "f32", 2)
    c = _cfg(44_100, 48_000, "f64", 2)
    ranked = _ranked([a, b, c], 16_000, np.float32)
    assert ranked[-1] == c
    assert ranked[-2] == b


def test_rank_mono_tiebreak():
    a = _cfg(8_000, 48_000, "f32", 2)
    b = _cfg(8_000, 48_000, "f32", 1)
    assert _ranked([a, b], 16_000, np.float32)[-1] == b


def test_pick_rate():
    for minr, maxr, want in ((8_000, 48_000, 16_000), (44_100, 48_000, 48_000)):
        assert _cfg(minr, maxr, "f32", 1).pick_rate(16_000) == want
        assert jax_audio.SupportedConfig(minr, maxr, "f32", 1).pick_rate(16_000) == want


def _selected(devs, settings, default):
    """The port's choice, held against JAX's on the same settings (the
    same device, or the same error)."""
    js = jax_input.Settings(selected_device=settings.selected_device,
                            on_error=jax_input.OnError(settings.on_error.value))
    try:
        want = jax_audio.select_device(devs, js, default)
    except Exception as e:  # noqa: BLE001 - compared by class name below
        with pytest.raises((SelectedDeviceNotFound, DeviceError)) as got:
            select_device(devs, settings, default)
        assert type(got.value).__name__ == type(e).__name__
        raise got.value
    got = select_device(devs, settings, default)
    assert got == want
    return got


def test_select_device_policies():
    devs = ["usb-mic", "builtin"]
    assert _selected(devs, Settings(), "builtin") == "builtin"
    assert _selected(devs, Settings(selected_device="usb-mic"), "builtin") == "usb-mic"
    assert _selected(devs, Settings(selected_device="nope"), "builtin") == "builtin"
    with pytest.raises(SelectedDeviceNotFound):
        _selected(devs, Settings(selected_device="nope", on_error=OnError.ERROR), "builtin")
    with pytest.raises(DeviceError):
        _selected(devs, Settings(), None)


@pytest.mark.parametrize("seed", range(4))
def test_rank_configs_matches_jax_on_random_sets(seed):
    rng = np.random.default_rng(seed)
    rates = (8_000, 16_000, 22_050, 44_100, 48_000, 96_000)
    for _ in range(50):
        configs = []
        for _ in range(int(rng.integers(1, 12))):
            lo, hi = sorted(rng.choice(rates, 2))
            configs.append(_cfg(int(lo), int(hi), str(rng.choice(FORMATS)), int(rng.integers(1, 5))))
        for rate in (16_000, 44_100):
            for dtype in (np.float32, np.float64, np.uint8, np.uint32):
                _ranked(configs, rate, dtype)
    with pytest.raises(ValueError):
        rank_configs(configs, 16_000, np.int16)  # not a valid model dtype, as in JAX
