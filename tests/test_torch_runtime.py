"""The port's Transcriber runtime and public API surface
(runtime/transcriber.py, models/__init__.py, models/mock.py), on the mock
model: the cases of tests/test_runtime.py and the pins of
tests/test_api_surface.py that the port's slice carries.

A SyntheticSource replaces the microphone; the protocol asserted is the
reference's: non-empty output, only MSG / FINAL_MSG strings, and exactly
one final message after stop().  ``Settings()`` (the microphone) reaches
the native capture (``audio/native/alsa.py::open_native_mic``), here faked;
tests/test_torch_native_stub.py drives it through the stub libasound.
"""

import asyncio
import inspect
import time

import numpy as np
import pytest

import norma_tpu_torch
from norma_tpu_torch import NoStreamRunning, Transcriber, TranscriberHandle, TranscriberRunning
from norma_tpu_torch.audio.sources import SyntheticSource
from norma_tpu_torch.input import Settings
from norma_tpu_torch.models import CommonModelParams, Model, ModelDefinition, SelectedDevice
from norma_tpu_torch.models.mock import FINAL_MSG, MSG, MockDef
from norma_tpu_torch.models.whisper import monolingual, multilingual
from norma_tpu_torch.runtime.batching import BatchedTranscriber


def _settings(duration=None, rate=48_000, dtype=np.int16):
    # 48 kHz stereo i16: exercises mixdown, conversion and resampling down
    # to the mock model's 44.1 kHz f64.
    return Settings(source=SyntheticSource(sample_rate=rate, channels=2, dtype=dtype, duration=duration,
                                           realtime=False))


def _check(res):
    assert res, "expected non-empty message list"
    assert all(m in (MSG, FINAL_MSG) for m in res), res
    assert res.count(FINAL_MSG) == 1, "expected exactly one FINAL_MSG"


def test_blocking_mock_model():
    jh, th = Transcriber.blocking_spawn(MockDef())
    stream = th.blocking_start(_settings())
    time.sleep(0.5)
    th.stop()
    th.close()
    _check(list(stream))
    jh.join(timeout=10)


def test_async_mock_model():
    async def main():
        jh, th = await Transcriber.spawn(MockDef())
        stream = await th.start(_settings())
        await asyncio.sleep(0.5)
        th.stop()
        th.close()
        res = []
        while (msg := await stream.recv()) is not None:
            res.append(msg)
        _check(res)
        jh.join(timeout=10)

    asyncio.run(main())


def test_double_start_rejected():
    jh, th = Transcriber.blocking_spawn(MockDef())
    stream = th.blocking_start(_settings())
    time.sleep(0.1)
    with pytest.raises(TranscriberRunning):
        th.blocking_start(_settings())
    th.stop()
    th.close()
    list(stream)
    jh.join(timeout=10)


def test_stop_without_stream():
    jh, th = Transcriber.blocking_spawn(MockDef())
    with pytest.raises(NoStreamRunning):
        th.stop()
    th.close()
    jh.join(timeout=10)


def test_restart_after_stop():
    jh, th = Transcriber.blocking_spawn(MockDef())
    for _ in range(2):
        stream = th.blocking_start(_settings())
        time.sleep(0.3)
        th.stop()
        _check(list(stream))
    th.close()
    jh.join(timeout=10)


def test_receiver_close_tears_down_stream():
    """Dropping the string receiver stops the stream but keeps the
    transcriber serving (reference: lib.rs:479-489)."""
    jh, th = Transcriber.blocking_spawn(MockDef())
    stream = th.blocking_start(_settings())
    time.sleep(0.3)
    stream.close()
    time.sleep(1.0)
    stream2 = th.blocking_start(_settings())
    time.sleep(0.2)
    th.stop()
    th.close()
    _check(list(stream2))
    jh.join(timeout=10)


def test_transcribe_error_surfaces_via_join():
    class Boom(Model):
        SAMPLE_RATE = 16_000
        dtype = np.float32

        def transcribe(self, data, final_chunk):
            raise RuntimeError("boom")

    class BoomDef(ModelDefinition):
        def common_params(self):
            return CommonModelParams(16_000, 3, 3)

        def blocking_try_to_model(self):
            return Boom()

    jh, th = Transcriber.blocking_spawn(BoomDef())
    stream = th.blocking_start(_settings(rate=16_000))
    time.sleep(0.5)
    with pytest.raises(RuntimeError, match="boom"):
        jh.join(timeout=10)
    assert stream.blocking_recv(timeout=0.5) is None  # torn down on error


@pytest.mark.parametrize("settings", [Settings(), None], ids=["Settings()", "no-arguments"])
def test_microphone_settings_reach_native_mic(settings, monkeypatch):
    """``Settings()`` (and ``blocking_start()``) open the microphone through
    ``audio/native/alsa.py::open_native_mic`` with the model's rate, dtype,
    ring size and chunk length, as the JAX package's ``_open_stream`` does;
    a fake native side (no toolchain needed) feeds two full chunks and the
    final short one, then closes its ring."""
    from norma_tpu_torch.audio.native import alsa
    from norma_tpu_torch.runtime.channels import RecycledRing

    calls = []

    class FakeMic:
        stopped = False

        def stop(self):
            self.stopped = True

    def fake_open(settings, model_rate, model_dtype, n_slots, chunk_len):
        calls.append((settings, model_rate, np.dtype(model_dtype), n_slots, chunk_len))
        ring = RecycledRing(n_slots + 2, chunk_len, model_dtype)
        for n in (chunk_len, chunk_len, chunk_len // 3):
            ring.try_send(np.zeros(n, model_dtype), n)
        ring.close()
        mic = FakeMic()
        calls.append(mic)
        return mic, ring

    monkeypatch.setattr(alsa, "open_native_mic", fake_open)
    jh, th = Transcriber.blocking_spawn(MockDef())
    res = list(th.blocking_start(settings) if settings is not None else th.blocking_start())
    th.close()
    jh.join(timeout=10)
    assert res == [MSG, MSG, FINAL_MSG]
    (s, rate, dtype, n_slots, chunk_len), mic = calls
    assert s == Settings() and s.source is None
    p = MockDef().common_params()
    assert (rate, dtype, n_slots, chunk_len) == (44_100, np.dtype(np.float64), p.data_buffer_size,
                                                 p.get_max_chunk_len())
    assert mic.stopped, "the stream's end must stop the native capture"


def test_common_params_clamps():
    p = CommonModelParams(10, 1, 0)
    assert (p.max_chunk_len, p.data_buffer_size, p.string_buffer_size) == (100, 3, 1)
    p.set_max_chunk_len(5)
    p.set_data_buffer_size(4)
    p.set_string_buffer_size(0)
    assert (p.get_max_chunk_len(), p.data_buffer_size, p.string_buffer_size) == (100, 6, 1)
    assert CommonModelParams.from_dict(p.to_dict()) == p
    d = monolingual.Definition(monolingual.ModelType.TINY_EN, SelectedDevice.cpu())
    d.set_responsiveness(2.0)
    assert d.common_params().max_chunk_len == 32_000
    with pytest.raises(Exception, match="responsiveness"):
        d.set_responsiveness(0.5)


# -- API pins (tests/test_api_surface.py, for the port) ------------------------


def _params(fn):
    return list(inspect.signature(fn).parameters)


def test_top_level_exports():
    assert set(norma_tpu_torch.__all__) == {
        "audio", "eval", "input", "models", "parallel", "tracing",
        "BatchedTranscriber", "Transcriber", "TranscriberHandle", "JoinHandle", "StringReceiver",
        "NormaError", "StartError", "StopError", "TranscriberDown", "TranscriberRunning", "NoStreamRunning",
        "__version__",
    }
    for name in norma_tpu_torch.__all__:
        assert hasattr(norma_tpu_torch, name), name


def test_transcriber_construction_variants():
    assert _params(Transcriber.blocking_new) == ["definition"]
    assert _params(Transcriber.blocking_spawn) == ["definition"]
    assert inspect.iscoroutinefunction(Transcriber.new.__func__)
    assert inspect.iscoroutinefunction(Transcriber.spawn.__func__)


def test_handle_api():
    assert _params(TranscriberHandle.blocking_start)[:2] == ["self", "settings"]
    assert inspect.iscoroutinefunction(TranscriberHandle.start)
    assert _params(TranscriberHandle.stop) == ["self"]
    assert hasattr(TranscriberHandle, "close")


def test_model_definition_protocol():
    for name in ("blocking_try_to_model", "try_to_model", "common_params"):
        assert hasattr(ModelDefinition, name)
    assert hasattr(Model, "transcribe")
    for name in ("set_max_chunk_len", "set_data_buffer_size", "set_string_buffer_size"):
        assert hasattr(CommonModelParams, name)


def test_selected_device_variants():
    for name in ("cpu", "cuda", "auto"):
        assert hasattr(SelectedDevice, name)


def test_whisper_definitions():
    assert len(list(monolingual.ModelType)) >= 8
    assert len(list(multilingual.ModelType)) >= 8
    for mod in (monolingual, multilingual):
        for name in ("set_responsiveness", "set_data_buffer_size", "set_string_buffer_size", "to_dict",
                     "from_dict", "blocking_try_to_model", "try_to_model"):
            assert hasattr(mod.Definition, name)
    assert hasattr(multilingual, "Task") and hasattr(monolingual, "MultiAsMono")


def test_batched_transcriber_api():
    assert _params(BatchedTranscriber.__init__)[:3] == ["self", "model", "max_streams"]
    for name in ("blocking_start", "close", "from_definition"):
        assert hasattr(BatchedTranscriber, name)
    assert _params(BatchedTranscriber.from_definition)[:2] == ["definition", "max_streams"]
