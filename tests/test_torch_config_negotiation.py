"""The port's production config negotiation (``norma_tpu_torch/audio/native/
alsa.py::open_native_mic``), the eight cases of
``tests/test_config_negotiation.py``.

A scripted ALSA function table advertises a device's configs and records
which (format, rate, channels) each package's ``open_native_mic`` opens;
the port must open exactly what the JAX package opens, in the same order,
on the same script.
"""

import ctypes
import os
import subprocess
import tempfile

import numpy as np
import pytest

import norma_tpu.audio.native.alsa as jax_alsa
import norma_tpu.input as jax_input
from norma_tpu.errors import BuildStreamError as JaxBuildStreamError
from norma_tpu_torch.audio.device import SupportedConfig, rank_configs
from norma_tpu_torch.audio.native.alsa import FMT_CODES, open_native_mic, query_configs
from norma_tpu_torch.errors import BuildStreamError
from norma_tpu_torch.input import Settings


def _lines(configs):
    return "".join(
        f"{FMT_CODES[c.sample_format]},{c.min_sample_rate},{c.max_sample_rate},{c.channels}\n"
        for c in configs
    ).encode()


class FakeLib:
    """Scripted ALSA fn-table mimicking the ctypes surface."""

    def __init__(self, configs, fail_first_n_starts=0, queryable=True):
        self.configs = list(configs)
        self.fail = fail_first_n_starts
        self.queryable = queryable
        self.start_calls = []  # (fmt_code, rate, channels)

    def nta_alsa_available(self):
        return 1

    def nta_alsa_devices(self, buf, cap):
        data = b"default\nhw:0"
        buf.value = data
        return len(data)

    def nta_alsa_query_configs(self, device, buf, cap):
        if not self.queryable:
            return -1
        data = _lines(self.configs)
        buf.value = data
        return len(data)

    def nta_alsa_start_fmt(self, device, rate, channels, fmt, target, ring):
        self.start_calls.append((int(fmt), int(rate), int(channels)))
        if self.fail > 0:
            self.fail -= 1
            return None
        return ctypes.c_void_p(0xDEAD)

    def nta_alsa_start(self, device, rate, channels, target, ring):
        return self.nta_alsa_start_fmt(device, rate, channels, FMT_CODES["i16"], target, ring)

    def nta_alsa_stop(self, handle):
        pass


CONFIGS = [
    SupportedConfig(8_000, 48_000, "i16", 1),
    SupportedConfig(8_000, 48_000, "i16", 2),
    SupportedConfig(8_000, 48_000, "f32", 2),
    SupportedConfig(8_000, 48_000, "u8", 1),
]


def _open_both(configs, **kw):
    """Run both packages' open_native_mic on the same script: (the port's
    FakeLib, its pipeline); asserts JAX opened the same configs in the same
    order, or raised the same error."""
    ours, theirs = FakeLib(configs, **kw), FakeLib(configs, **kw)
    args = dict(model_rate=16_000, model_dtype=np.float32, n_slots=4, chunk_len=1600)
    try:
        pipe, _ = open_native_mic(Settings(), lib=ours, **args)
    except BuildStreamError:
        with pytest.raises(JaxBuildStreamError):
            jax_alsa.open_native_mic(jax_input.Settings(), lib=theirs, **args)
        assert ours.start_calls == theirs.start_calls
        raise
    jpipe, _ = jax_alsa.open_native_mic(jax_input.Settings(), lib=theirs, **args)
    assert ours.start_calls == theirs.start_calls
    jpipe.stop()
    return ours, pipe


def test_best_ranked_config_is_opened():
    """f32 matches the model dtype -> ranked best despite stereo."""
    lib, pipe = _open_both(CONFIGS)
    assert lib.start_calls == [(FMT_CODES["f32"], 16_000, 2)]
    pipe.stop()


def test_negotiation_order_on_failures():
    """Start failures walk the ranked list best-to-worst."""
    lib, _ = _open_both(CONFIGS, fail_first_n_starts=2)
    ranked = rank_configs(CONFIGS, 16_000, np.float32)
    want = [(FMT_CODES[c.sample_format], c.pick_rate(16_000), c.channels) for c in reversed(ranked)][:3]
    assert lib.start_calls == want


def test_unsupported_model_rate_uses_max_rate():
    """A range below the model rate opens at its max rate (the C++ sinc
    resampler then converts), reference lib.rs:538-541."""
    lib, _ = _open_both([SupportedConfig(44_100, 48_000, "i16", 1)])
    assert lib.start_calls == [(FMT_CODES["i16"], 48_000, 1)]


def test_f64_preferred_when_rate_unsupported():
    """Among non-rate-supporters: f64 > other floats > ints (lib.rs:580-593)."""
    lib, _ = _open_both([
        SupportedConfig(44_100, 48_000, "i16", 1),
        SupportedConfig(44_100, 48_000, "f64", 2),
        SupportedConfig(44_100, 48_000, "f32", 1),
    ])
    assert lib.start_calls[0] == (FMT_CODES["f64"], 48_000, 2)


def test_unqueryable_device_falls_back_to_blind_probe():
    lib, _ = _open_both([], queryable=False)
    assert lib.start_calls == [(FMT_CODES["i16"], 16_000, 1)]


def test_all_negotiated_configs_failing_raises():
    with pytest.raises(BuildStreamError):
        _open_both(CONFIGS, fail_first_n_starts=99)


def test_query_configs_parses_lines():
    assert query_configs(FakeLib(CONFIGS), "default") == CONFIGS
    assert [(c.min_sample_rate, c.max_sample_rate, c.sample_format, c.channels)
            for c in jax_alsa.query_configs(FakeLib(CONFIGS), "default")] == [
        (c.min_sample_rate, c.max_sample_rate, c.sample_format, c.channels) for c in CONFIGS]


def test_real_library_query_shape():
    """The C++ query path returns well-formed SupportedConfigs: against the
    system libasound when present, else against the stub (tests/stub_alsa)
    in a child process, so this never skips."""
    from norma_tpu_torch.audio.native import load

    lib = load()
    if lib is not None and lib.nta_alsa_available():
        for c in query_configs(lib, "null"):
            assert c.min_sample_rate <= c.max_sample_rate
            assert c.sample_format in FMT_CODES
            assert 1 <= c.channels <= 32
        return

    from helpers import build_alsa_stub, run_stub_driver

    with tempfile.TemporaryDirectory() as td:
        try:
            stub = build_alsa_stub(os.path.join(td, "libasound_stub.so"))
        except (OSError, subprocess.SubprocessError) as e:
            pytest.fail(f"no libasound AND no C toolchain for the stub: {e}")
        driver = (
            "import sys; sys.path.insert(0, sys.argv[1])\n"
            "from norma_tpu_torch.audio.native import load\n"
            "from norma_tpu_torch.audio.native.alsa import FMT_CODES, query_configs\n"
            "lib = load(); assert lib is not None and lib.nta_alsa_available()\n"
            "cs = query_configs(lib, 'null')\n"
            "assert cs, 'stub must advertise configs'\n"
            "for c in cs:\n"
            "    assert c.min_sample_rate <= c.max_sample_rate\n"
            "    assert c.sample_format in FMT_CODES\n"
            "    assert 1 <= c.channels <= 32\n"
            "print('QUERY-SHAPE-OK')\n"
        )
        proc = run_stub_driver(driver, stub, timeout=60)
        assert proc.returncode == 0, (proc.stdout, proc.stderr)
        assert "QUERY-SHAPE-OK" in proc.stdout
