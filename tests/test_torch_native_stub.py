"""The port's native ALSA path through the stub libasound
(``tests/stub_alsa/stub_asound.c``, one capture device "stubmic").

The two cases of ``tests/test_native_stub.py`` on the port, and the
microphone end to end: ``Transcriber.blocking_start(Settings())`` on the
mock model captures from the stub through the port's native runtime and
ends with exactly one final message.  The stub is injected with the
``NTA_ALSA_LIB`` override, which the C++ side reads when it first loads
ALSA, so each check runs in a child process (this process may have loaded
the library already).  Skipped only where the JAX file skips: when no C
toolchain builds the stub.
"""

import subprocess

import pytest

from helpers import build_alsa_stub, run_stub_driver


@pytest.fixture(scope="module")
def stub_lib(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("stub_alsa") / "libasound_stub.so")
    try:
        return build_alsa_stub(out)
    except (OSError, subprocess.SubprocessError) as e:
        pytest.skip(f"no C toolchain to build the ALSA stub: {e}")


DRIVER = r"""
import sys

sys.path.insert(0, sys.argv[1])
import numpy as np

from norma_tpu_torch.audio.native import load
from norma_tpu_torch.audio.native.alsa import (
    list_devices, open_native_mic, query_configs,
)
from norma_tpu_torch.input import Settings

lib = load()
assert lib is not None, "native library unavailable"
assert lib.nta_alsa_available() == 1, "stub libasound not picked up"

devices = list_devices(lib)
assert "stubmic" in devices, devices

configs = query_configs(lib, "stubmic")
# 3 formats x 2 channel counts advertised by the stub.
assert len(configs) == 6, configs
fmts = {c.sample_format for c in configs}
assert fmts == {"i16", "i32", "f32"}, fmts
for c in configs:
    assert (c.min_sample_rate, c.max_sample_rate) == (16000, 48000)
    assert c.channels in (1, 2)

# The ranked open: an f32 model at 16 kHz negotiates the f32 format
# (cmp_mic_config: 16k support > matching format > float, lib.rs:559-600)
# at the model rate, mono preferred.
pipeline, ring = open_native_mic(
    Settings(selected_device="stubmic"), 16000, np.float32,
    n_slots=8, chunk_len=1600,
)
chunks = []
for _ in range(3):
    c = ring.recv(timeout=2.0)
    assert c is not None, "no audio from stub capture"
    chunks.append(np.asarray(c.data, np.float32).copy())
pipeline.stop()
audio = np.concatenate(chunks)
rms = float(np.sqrt(np.mean(audio**2)))
# 440 Hz sine at 0.5 amplitude -> rms ~0.354.
assert 0.2 < rms < 0.6, rms
spec = np.abs(np.fft.rfft(audio * np.hanning(audio.size)))
peak_hz = float(np.argmax(spec)) * 16000.0 / audio.size
assert abs(peak_hz - 440.0) < 15.0, peak_hz
print("STUB-NATIVE-OK", rms, peak_hz)
"""


def test_ranked_negotiation_and_capture_via_stub(stub_lib):
    proc = run_stub_driver(DRIVER, stub_lib, timeout=120)
    assert proc.returncode == 0, (proc.stdout, proc.stderr)
    assert "STUB-NATIVE-OK" in proc.stdout, proc.stdout


def test_stub_rejects_unknown_device(stub_lib):
    driver = (
        "import sys; sys.path.insert(0, sys.argv[1]);\n"
        "from norma_tpu_torch.audio.native import load\n"
        "from norma_tpu_torch.audio.native.alsa import query_configs\n"
        "lib = load(); assert lib is not None\n"
        "assert query_configs(lib, 'nonexistent-device') == []\n"
        "print('REJECT-OK')\n"
    )
    proc = run_stub_driver(driver, stub_lib, timeout=60)
    assert proc.returncode == 0, (proc.stdout, proc.stderr)
    assert "REJECT-OK" in proc.stdout


MIC_DRIVER = r"""
import sys, time

sys.path.insert(0, sys.argv[1])
from norma_tpu_torch import Transcriber
from norma_tpu_torch.audio.native import load
from norma_tpu_torch.input import Settings
from norma_tpu_torch.models.mock import FINAL_MSG, MSG, MockDef

lib = load()
opened = []
start_fmt = lib.nta_alsa_start_fmt
lib.nta_alsa_start_fmt = lambda name, *a: (opened.append((name.decode(),) + a[:3]), start_fmt(name, *a))[1]
jh, th = Transcriber.blocking_spawn(MockDef())
rx = th.blocking_start(Settings())
time.sleep(2.5)  # the mock model takes 1 s chunks at 44.1 kHz
th.stop()
res = list(rx)
th.close()
jh.join(timeout=10)
# "default" aliases the stub mic; the mock's 44.1 kHz is inside the stub's
# range, so the capture opens at the model rate, mono.
assert len(opened) == 1 and opened[0][:3] == ("default", 44100, 1), opened
assert res.count(FINAL_MSG) == 1 and res[-1] == FINAL_MSG, res
assert res.count(MSG) >= 1, res
print("MIC-OK", res)
"""


def test_blocking_start_settings_captures_from_the_stub(stub_lib):
    proc = run_stub_driver(MIC_DRIVER, stub_lib, timeout=120)
    assert proc.returncode == 0, (proc.stdout, proc.stderr)
    assert "MIC-OK" in proc.stdout, proc.stdout
