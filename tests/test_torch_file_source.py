"""File-source EOF semantics through the port's Transcriber
(tests/test_file_source.py's case): the stream finalizes without stop(),
with the same messages as the JAX package's, and a new start succeeds."""

import time
import wave

import numpy as np

from norma_tpu import Transcriber as JTranscriber
from norma_tpu.audio.sources import FileSource as JFileSource
from norma_tpu.input import Settings as JSettings
from norma_tpu.models.mock import MockDef as JMockDef
from norma_tpu_torch import Transcriber
from norma_tpu_torch.audio.sources import FileSource
from norma_tpu_torch.input import Settings
from norma_tpu_torch.models.mock import FINAL_MSG, MSG, MockDef


def _write_wav(path, seconds=0.7, sr=16_000):
    t = np.arange(int(seconds * sr)) / sr
    pcm = (0.4 * np.sin(2 * np.pi * 440 * t) * 32767).astype(np.int16)
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(pcm.tobytes())


def _run(transcriber, settings, source, mock, path):
    jh, th = transcriber.blocking_spawn(mock())
    # No stop(): EOF must flush the final chunk and close the channel.
    res = list(th.blocking_start(settings(source=source(str(path)))))
    # The keepalive was cleared: a new start succeeds.
    deadline, stream2 = time.time() + 5, None
    while time.time() < deadline:
        try:
            stream2 = th.blocking_start(settings(source=source(str(path))))
            break
        except Exception:
            time.sleep(0.05)
    assert stream2 is not None
    res2 = list(stream2)
    th.close()
    jh.join(timeout=10)
    return res, res2


def test_eof_finalizes_stream_and_allows_restart(tmp_path):
    path = tmp_path / "tone.wav"
    _write_wav(path)
    res, res2 = _run(Transcriber, Settings, FileSource, MockDef, path)
    assert res, "expected messages from the file stream"
    assert res.count(FINAL_MSG) == 1 and res2.count(FINAL_MSG) == 1
    assert all(m in (MSG, FINAL_MSG) for m in res + res2)
    jres, jres2 = _run(JTranscriber, JSettings, JFileSource, JMockDef, path)
    assert (res, res2) == (jres, jres2)
