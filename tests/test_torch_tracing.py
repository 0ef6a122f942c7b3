"""The port's tracing (norma_tpu_torch/tracing.py) against the JAX
package's (tests/test_tracing.py's cases), on the CPU.

  - the span structure of a debug-level run of the hermetic streaming path,
    through both packages' Transcriber on the same tiny Definition (the
    same weights): the same span names and fields in each package's log;
  - ``instrument``: skipped extraction when disabled, coroutines, fields
    named ``name`` / ``level``;
  - the device report's parser on a synthetic Chrome trace (two devices,
    host events, every device category): per-name totals and counts in
    ms, the per-device max rule, order by total, host events ignored, one
    pass for several lines;
  - a session's own check: a kernel or graph launch with no device event
    is counted as lost, one with its events is not;
  - ``profile`` / ``annotate`` on the CPU: a trace per session under the
    directory, the engine's three regions in it, no device line, and no
    process-wide setting left behind; ``profiled_device_ms`` raises
    ``RuntimeError`` (never 0) and takes a session that lost device
    events again, twice at most.

Every comparison is exact.
"""

import json
import logging
import os
import time

import numpy as np
import pytest
import torch

from helpers import TEST_LANG_IDS, TEST_ST, ToyTokenizer, tiny_config
from torch_port_helpers import port_cfg, port_params, port_st

import norma_tpu_torch.tracing as ttr
from norma_tpu.model import init_params as jinit

SPANS = (
    "Transcriber.blocking_new enter", "Transcriber.blocking_spawn enter", "Transcriber.run enter",
    "TranscriberHandle.blocking_start enter", "TranscriberHandle.stop enter",
    "WhisperModel.transcribe enter", "Transcribe slice enter", "DecodeEngine.transcribe_window enter",
    "WhisperModel.transcribe exit",
)
FIELDS = ("input_data_len", "buf_len", "slice_len")


def _definition(pkg):
    """The same tiny Definition for either package (JAX params carried to
    the port for ``norma_tpu_torch``)."""
    if pkg == "norma_tpu":
        from norma_tpu.decode import DecodeEngine, LanguageState
        from norma_tpu.models import CommonModelParams
        from norma_tpu.models.whisper.model import WhisperModel
        from norma_tpu.runtime.transcriber import Transcriber

        cfg, st, conv = tiny_config(), TEST_ST, lambda p: p
    else:
        from norma_tpu_torch.decode import DecodeEngine, LanguageState
        from norma_tpu_torch.models import CommonModelParams
        from norma_tpu_torch.models.whisper.model import WhisperModel
        from norma_tpu_torch.runtime.transcriber import Transcriber

        cfg, st, conv = port_cfg(tiny_config()), port_st(TEST_ST), port_params

    class Definition:
        def common_params(self):
            return CommonModelParams(max_chunk_len=8000, data_buffer_size=3, string_buffer_size=3)

        def blocking_try_to_model(self):
            engine = DecodeEngine(conv(jinit(tiny_config(), seed=0)), cfg, st, language_token_ids=TEST_LANG_IDS)
            return WhisperModel(engine, ToyTokenizer(), LanguageState(const=TEST_LANG_IDS[0]),
                                language_tokens=TEST_LANG_IDS)

    return Transcriber, Definition()


@pytest.mark.parametrize("pkg", ["norma_tpu", "norma_tpu_torch"])
def test_e2e_span_structure(caplog, pkg):
    """tests/test_tracing.py::test_e2e_span_structure through either
    package: every public entry's span, the hot-path fields."""
    import importlib

    Transcriber, defn = _definition(pkg)
    sources = importlib.import_module(f"{pkg}.audio.sources")
    settings = importlib.import_module(f"{pkg}.input")
    errors = importlib.import_module(f"{pkg}.errors")
    with caplog.at_level(logging.DEBUG, logger=pkg):
        jh, handle = Transcriber.blocking_spawn(defn)
        src = sources.SyntheticSource(sample_rate=16_000, channels=1, dtype=np.float32, freq=330.0, noise=0.02,
                                      duration=0.8, realtime=False)
        rx = handle.blocking_start(settings.Settings(source=src))
        time.sleep(0.3)
        try:
            handle.stop()
        except errors.NoStreamRunning:
            pass  # the stream already ended at EOF (the span was entered all the same)
        list(rx)
        handle.close()
        jh.join(timeout=10)
    text = caplog.text
    for s in SPANS + FIELDS:
        assert s in text, (pkg, s)


def test_instrument_disabled_is_cheap():
    """Below the span level, instrumented fns skip field extraction."""
    calls = []

    @ttr.instrument(fields={"x": lambda a: calls.append(1)})
    def f(x):
        return x + 1

    old = ttr.logger.level
    ttr.logger.setLevel(logging.WARNING)
    try:
        assert f(1) == 2
        assert calls == []
    finally:
        ttr.logger.setLevel(old)


def test_async_instrument_wraps_coroutines():
    import asyncio

    @ttr.instrument
    async def g(v):
        return v * 2

    assert asyncio.run(g(21)) == 42


def test_instrument_field_named_name_or_level(caplog):
    """Fields named 'name'/'level' are renamed, as the JAX package's are,
    rather than TypeError the call."""

    @ttr.instrument(fields={"name": lambda a: a["x"], "level": lambda a: a["x"]})
    def f(x):
        return x * 2

    with caplog.at_level(logging.DEBUG, logger="norma_tpu_torch"):
        assert f(21) == 42
    msgs = " ".join(r.getMessage() for r in caplog.records)
    assert "name_" in msgs and "level_" in msgs


def _ev(cat, name, dur_us, device=0, corr=None, pid=None, ts=0.0):
    args = {"device": device} if device is not None else {}
    if corr is not None:
        args["correlation"] = corr
    return {"ph": "X", "cat": cat, "name": name, "pid": device if pid is None else pid, "tid": 7, "ts": ts,
            "dur": dur_us, "args": args}


def _write_trace(path, events):
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps({"schemaVersion": 1, "traceEvents": events + [
        {"ph": "M", "name": "process_name", "pid": 0, "args": {"name": "GPU 0"}}]}))


def test_device_time_report_synthetic_trace(tmp_path):
    """Totals and counts per name in ms; per name the max over devices
    (device 1's 'gemm' is longer, device 0's 'softmax'); sorted by total;
    host events (a cpu_op named as a kernel, a user_annotation named as a
    region, a launch call) ignored; files found in subdirectories."""
    _write_trace(tmp_path / "run1" / "h.1.1.pt.trace.json", [
        _ev("kernel", "gemm", 5.0, 0), _ev("kernel", "gemm", 7.0, 0), _ev("kernel", "softmax", 3.0, 0),
        _ev("kernel", "gemm", 9.0, 1), _ev("kernel", "gemm", 4.0, 1), _ev("kernel", "softmax", 1.0, 1),
        _ev("gpu_memcpy", "Memcpy DtoH (Device -> Pinned)", 2.0, 0),
        _ev("gpu_memset", "Memset (Device)", 0.5, 0),
        _ev("gpu_user_annotation", "token_loop", 40.0, 0), _ev("gpu_user_annotation", "token_loop", 20.0, 0),
        _ev("cpu_op", "gemm", 999.0, None, pid=4242),
        _ev("user_annotation", "token_loop", 999.0, None, pid=4242),
        _ev("cuda_runtime", "cudaLaunchKernel", 999.0, None, pid=4242, corr=1),
    ])
    r = ttr.device_time_report_multi(str(tmp_path), ttr.DEVICE_LINES)
    assert r["kernel"] == {"gemm": (0.013, 2), "softmax": (0.003, 1)}
    assert list(r["kernel"]) == ["gemm", "softmax"]
    assert r["gpu_memcpy"] == {"Memcpy DtoH (Device -> Pinned)": (0.002, 1)}
    assert r["gpu_memset"] == {"Memset (Device)": (0.0005, 1)}
    assert r["gpu_user_annotation"] == {"token_loop": (0.06, 2)}
    assert ttr.device_time_report(str(tmp_path)) == r["kernel"]
    assert ttr.device_time_report(str(tmp_path), "gpu_user_annotation") == r["gpu_user_annotation"]
    assert ttr.device_time_report(str(tmp_path), "cpu_op") == {}


def test_report_merges_files_by_device_max(tmp_path):
    """Two trace files are two devices' worth of events for the max rule
    (one process per card), and a file not named as a trace is skipped
    (a lost session's ``*.lost``)."""
    _write_trace(tmp_path / "a.pt.trace.json", [_ev("kernel", "k", 2.0, 0)])
    _write_trace(tmp_path / "b.pt.trace.json", [_ev("kernel", "k", 3.0, 0), _ev("kernel", "k", 3.0, 0)])
    _write_trace(tmp_path / "c.pt.trace.json.lost", [_ev("kernel", "k", 100.0, 0)])
    assert ttr.device_time_report(str(tmp_path)) == {"k": (0.006, 2)}


def test_lost_launches_counts_launches_without_device_events():
    """A session's check: launches (a kernel launch, a graph launch whose
    kernels carry its correlation id) with device events are kept; a
    launch whose id no device event carries is lost; other runtime calls
    (a synchronize) are not launches."""
    events = [
        _ev("cuda_runtime", "cudaLaunchKernel", 1.0, None, corr=1, pid=9),
        _ev("cuda_runtime", "cudaGraphLaunch", 1.0, None, corr=2, pid=9),
        _ev("cuda_runtime", "cudaLaunchKernelExC", 1.0, None, corr=3, pid=9),
        _ev("cuda_runtime", "cudaStreamSynchronize", 1.0, None, corr=4, pid=9),
        _ev("cuda_driver", "cuLaunchKernel", 1.0, None, corr=5, pid=9),
        _ev("kernel", "a", 1.0, 0, corr=1), _ev("kernel", "g1", 1.0, 0, corr=2), _ev("kernel", "g2", 1.0, 0, corr=2),
        _ev("gpu_user_annotation", "token_loop", 5.0, 0),
    ]
    lost, n, dev = ttr._lost_launches(events)
    assert ([e["name"] for e in lost], n, dev) == (["cudaLaunchKernelExC", "cuLaunchKernel"], 4, 4)
    lost, n, dev = ttr._lost_launches(events[:3] + events[5:])
    assert ([e["name"] for e in lost], n, dev) == (["cudaLaunchKernelExC"], 3, 4)
    detail = ttr._lost_detail(events, lost)
    assert "('cudaLaunchKernelExC', None), 1" in detail
    err = ttr.DeviceEventsLost("x.json", 1, 3, 4, detail)
    assert isinstance(err, RuntimeError) and err.launches == 1 and err.device_events == 4
    assert "1 of 3 kernel launches have no device event" in str(err)


def test_profile_and_engine_regions_on_cpu(tmp_path):
    """On the CPU a session writes one trace under the directory; the
    engine's three named regions are in it (host events, so the device
    report sees none of them)."""
    from norma_tpu_torch.decode import DecodeEngine
    from norma_tpu_torch.frontend.mel import prepare_audio

    cfg = port_cfg(tiny_config())
    engine = DecodeEngine(port_params(jinit(tiny_config(), seed=0)), cfg, port_st(TEST_ST),
                          language_token_ids=TEST_LANG_IDS)
    audio = prepare_audio((0.1 * np.random.default_rng(0).standard_normal(8000)).astype(np.float32),
                          2 * cfg.max_source_positions)[None]
    d = tmp_path / "prof"
    with ttr.profile(str(d)) as got:
        engine.transcribe_window(audio, [TEST_LANG_IDS[0]], seed=0)
    assert got == str(d)
    files = sorted(p.name for p in d.iterdir())
    assert len(files) == 1 and files[0].endswith(".pt.trace.json")
    names = {e["name"] for e in ttr._events(str(d / files[0])) if e.get("cat") == "user_annotation"}
    assert {"window_front", "token_loop", "ladder_finish"} <= names
    assert all(v == {} for v in ttr.device_time_report_multi(str(d), ttr.DEVICE_LINES).values())


def test_profiled_device_ms_raises_without_device_events(tmp_path):
    """No card: the report finds no device events and raises, naming the
    directory, instead of returning 0 ms."""
    d = str(tmp_path / "p")
    with pytest.raises(RuntimeError, match="no device events") as e:
        ttr.profiled_device_ms(lambda: torch.ones(8) + 1, 2, d, ops=3)
    assert d in str(e.value)
    assert ttr.last_profile["sessions"] == 1 and ttr.last_profile["lost"] == []


@pytest.mark.parametrize("n_lost", [0, 1, 2, 3])
def test_profiled_device_ms_retries_lost_sessions(tmp_path, monkeypatch, n_lost):
    """A session that loses device events is taken again, twice at most:
    the report reads only the kept session's trace, ``last_profile`` says
    how many sessions it took and how many device events each lost one
    held, and a third loss raises."""
    import contextlib

    sessions, calls = [], []

    @contextlib.contextmanager
    def fake_profile(log_dir):
        sessions.append(log_dir)
        yield log_dir
        if len(sessions) <= n_lost:
            raise ttr.DeviceEventsLost(log_dir, 2, 5, 10 + len(sessions))
        _write_trace(tmp_path / "p" / f"h.{len(sessions)}.pt.trace.json", [
            _ev("kernel", "gemm", 4000.0), _ev("kernel", "gemm", 2000.0), _ev("kernel", "softmax", 1000.0),
            _ev("gpu_memcpy", "Memcpy HtoD", 500.0), _ev("gpu_user_annotation", "token_loop", 9000.0)])

    monkeypatch.setattr(ttr, "profile", fake_profile)
    d = str(tmp_path / "p")
    if n_lost == 3:
        with pytest.raises(ttr.DeviceEventsLost):
            ttr.profiled_device_ms(lambda: calls.append(1), 2, d)
        assert len(sessions) == 3 and len(calls) == 6
        return
    busy, rows = ttr.profiled_device_ms(lambda: calls.append(1), 2, d, ops=1)
    assert len(sessions) == n_lost + 1 and len(calls) == 2 * (n_lost + 1)
    assert ttr.last_profile == {"sessions": n_lost + 1, "lost": [11, 12][:n_lost]}
    assert busy == pytest.approx(3.75)  # (6 + 1 + 0.5) ms of kernels and copies over 2 calls
    assert rows == [{"op": "gemm", "ms_per_call": 3.0, "n": 2}]


def test_profile_leaves_the_environment_alone(tmp_path, monkeypatch):
    """A session sets no process-wide profiler option (CUPTI's teardown
    stays torch's choice), and each session writes its own trace."""
    monkeypatch.delenv("TEARDOWN_CUPTI", raising=False)
    env = dict(os.environ)
    for _ in range(2):
        with ttr.profile(str(tmp_path)):
            torch.ones(4).add_(1)
    assert dict(os.environ) == env
    assert len([p for p in tmp_path.iterdir() if p.name.endswith(".pt.trace.json")]) == 2


@pytest.mark.parametrize("case", ["no_card", "after_a_session", "session_open", "first"])
def test_prime_device_tracer_once(monkeypatch, case):
    """The engine's tracer start before a WHILE graph's capture: one short
    session, once in the process, and none without a card, after a session
    of :func:`profile`, or while another session is open."""
    import contextlib

    import torch.profiler

    opened = []

    @contextlib.contextmanager
    def fake_session(activities):
        opened.append(activities)
        yield

    zeros = torch.zeros
    monkeypatch.setattr(torch.profiler, "profile", fake_session)
    monkeypatch.setattr(torch, "zeros", lambda *a, device=None, **k: zeros(*a, **k))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: case != "no_card")
    monkeypatch.setattr(torch.autograd.profiler, "_is_profiler_enabled", case == "session_open")
    monkeypatch.setattr(ttr, "_tracer_started", case == "after_a_session")
    for _ in range(2):
        ttr.prime_device_tracer()
    assert len(opened) == (case == "first")
    assert ttr._tracer_started == (case != "no_card")
