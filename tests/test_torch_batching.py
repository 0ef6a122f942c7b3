"""The port's multi-stream batching scheduler (norma_tpu_torch.runtime.batching).

The cases of tests/test_batching.py that need no mesh, on the port's tiny
engine (texty_config + confident_params converted from the JAX package's
weights, so greedy rung-0 decodes are deterministic and emit text) and
non-realtime synthetic sources.  Plus the port's own contract: ``mesh=``
raises, and the SLA round cap counts streams.
"""

import copy
import threading
import time

import numpy as np
import pytest

from helpers import TEST_LANG_IDS, TEST_ST, ToyTokenizer, confident_params, texty_config, tiny_config
from torch_port_helpers import port_cfg, port_params, port_st

import norma_tpu_torch.decode.engine as engine_mod
from norma_tpu_torch.audio.sources import SyntheticSource
from norma_tpu_torch.decode import DecodeEngine, LanguageState, LongFormDecoder
from norma_tpu_torch.errors import NormaError
from norma_tpu_torch.frontend.mel import prepare_audio
from norma_tpu_torch.input import Settings
from norma_tpu_torch.model import init_params
from norma_tpu_torch.models.whisper.model import WhisperModel
from norma_tpu_torch.runtime.batching import BatchedTranscriber, TooManyStreams

ST = port_st(TEST_ST)


@pytest.fixture(scope="module")
def model():
    cfg = texty_config()
    engine = DecodeEngine(
        port_params(confident_params(cfg)), port_cfg(cfg), ST, language_token_ids=TEST_LANG_IDS
    )
    return WhisperModel(
        engine, ToyTokenizer(), LanguageState(const=TEST_LANG_IDS[0]), language_tokens=TEST_LANG_IDS
    )


def _tiny_model():
    cfg = port_cfg(tiny_config())
    engine = DecodeEngine(init_params(cfg, seed=3), cfg, ST, language_token_ids=TEST_LANG_IDS)
    return WhisperModel(
        engine, ToyTokenizer(), LanguageState(const=TEST_LANG_IDS[0]), language_tokens=TEST_LANG_IDS
    )


def _source(seed, seconds=1.2, freq=330.0):
    return SyntheticSource(
        sample_rate=16_000, channels=1, dtype=np.float32, freq=freq, noise=0.02,
        duration=seconds, realtime=False, seed=seed,
    )


def _drain_all(handles, timeout=120):
    outs = {}
    threads = [
        threading.Thread(target=lambda i=i, h=h: outs.setdefault(i, list(h.receiver)), daemon=True)
        for i, h in enumerate(handles)
    ]
    for t in threads:
        t.start()
    return outs, threads


def test_start_after_close_refused(model):
    bt = BatchedTranscriber(model, max_streams=2)
    bt.close()
    with pytest.raises(NormaError, match="closed"):
        bt.blocking_start(Settings(source=_source(0)))


def test_mesh_is_refused(model):
    with pytest.raises(NormaError, match="mesh"):
        BatchedTranscriber(model, max_streams=2, mesh=object())


@pytest.mark.filterwarnings("ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_fatal_decode_error_tears_down(model, monkeypatch):
    bt = BatchedTranscriber(model, max_streams=2)
    monkeypatch.setattr(
        bt, "_dispatch_round", lambda ready: (_ for _ in ()).throw(RuntimeError("device lost"))
    )
    h = bt.blocking_start(Settings(source=_source(1, seconds=0.6)))
    texts = list(h.receiver)
    assert texts == [] or all(isinstance(t, str) for t in texts)
    bt._thread.join(timeout=10)
    assert not bt._thread.is_alive()
    assert bt._closed.is_set()
    with pytest.raises(NormaError, match="closed"):
        bt.blocking_start(Settings(source=_source(2)))
    with bt._lock:
        streams = list(bt._streams.values())
    for s in streams:
        assert s.pipeline._stopped


@pytest.mark.filterwarnings("ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_fatal_round_before_start_returns(model, monkeypatch):
    """Fault (a flake of test_fatal_decode_error_tears_down, 1 in 50 runs
    under -n 6): a fast source can fill its ring, and a fatal round retire
    the stream, before the source's start() returns in blocking_start.  The
    admitted, served stream then gets its handle (its receiver ends), not a
    "closed" error.  start() is held here until the teardown has run, so
    the race always goes that way."""
    from norma_tpu_torch.audio.pipeline import StreamPipeline

    bt = BatchedTranscriber(model, max_streams=2)
    monkeypatch.setattr(
        bt, "_dispatch_round", lambda ready: (_ for _ in ()).throw(RuntimeError("device lost"))
    )
    start = StreamPipeline.start

    def start_then_wait_for_teardown(self):
        start(self)
        assert bt._closed.wait(timeout=10)
        bt._thread.join(timeout=10)

    monkeypatch.setattr(StreamPipeline, "start", start_then_wait_for_teardown)
    h = bt.blocking_start(Settings(source=_source(3, seconds=0.6)))
    assert list(h.receiver) == []
    assert not bt._thread.is_alive() and bt._closed.is_set()
    with bt._lock:
        assert not bt._streams
    with pytest.raises(NormaError, match="closed"):
        bt.blocking_start(Settings(source=_source(4)))


def test_batch_size_padding():
    bs = BatchedTranscriber._batch_size
    assert [bs(n, 8) for n in (1, 2, 3, 4, 5, 8)] == [1, 2, 4, 4, 8, 8]
    assert bs(7, 4) == 4


def test_three_concurrent_streams(model):
    bt = BatchedTranscriber(model, max_streams=4)
    handles = [
        bt.blocking_start(Settings(source=_source(i, freq=220.0 + 110 * i))) for i in range(3)
    ]
    time.sleep(0.5)
    for h in handles:
        h.stop()
    texts = ["".join(list(h.receiver)) for h in handles]
    m = bt.metrics()
    bt.close()
    assert all(isinstance(t, str) for t in texts)
    assert all(texts), texts  # confident params emit text on every stream
    assert m["transcript_drops"] == 0 and m["audio_drops"] == 0


def test_stream_limit(model):
    bt = BatchedTranscriber(model, max_streams=2)
    h1 = bt.blocking_start(Settings(source=_source(1)))
    h2 = bt.blocking_start(Settings(source=_source(2)))
    with pytest.raises(TooManyStreams):
        bt.blocking_start(Settings(source=_source(3)))
    h1.stop()
    h2.stop()
    list(h1.receiver)
    list(h2.receiver)
    deadline = time.time() + 5
    while time.time() < deadline:
        try:
            h3 = bt.blocking_start(Settings(source=_source(4)))
            break
        except TooManyStreams:
            time.sleep(0.05)
    else:
        pytest.fail("slot never freed")
    h3.stop()
    list(h3.receiver)
    bt.close()


def test_batched_matches_single_stream(model):
    """Same audio through the batched scheduler == the single-stream
    decoder (the packer's final flush drops one trailing sample)."""
    seconds = 1.0
    t = np.arange(int(16_000 * seconds)) / 16_000
    tone = (0.3 * np.sin(2 * np.pi * 440 * t)).astype(np.float32)
    lf = LongFormDecoder(
        model.engine, model.tokenizer, LanguageState(const=TEST_LANG_IDS[0]),
        language_tokens=TEST_LANG_IDS,
    )
    expected = lf.transcribe(tone[:-1], final_chunk=True)

    bt = BatchedTranscriber(model, max_streams=4)
    src = SyntheticSource(
        sample_rate=16_000, channels=1, dtype=np.float32, freq=440.0, noise=0.0,
        duration=seconds, realtime=False,
    )
    h = bt.blocking_start(Settings(source=src))
    time.sleep(0.3)
    h.stop()
    got = "".join(list(h.receiver))
    bt.close()
    assert got == expected and got


def test_admission_bounded_by_one_round():
    """A stream whose audio arrives while a round is in flight is admitted
    in the immediately following round."""
    m = _tiny_model()
    engine = m.engine
    bt = BatchedTranscriber(m, max_streams=4)
    permits = threading.Semaphore(0)
    gate_on = threading.Event()
    gate_on.set()
    rounds = []
    orig_round = bt._dispatch_round
    orig_window = engine.transcribe_window_async

    def gated_window(audio, langs, seed, n_active=None):
        if gate_on.is_set():
            assert permits.acquire(timeout=60), "test gate timed out"
        return orig_window(audio, langs, seed, n_active=n_active)

    def spy_round(ready):
        rounds.append(sorted(s.sid for s in ready))
        return orig_round(ready)

    engine.transcribe_window_async = gated_window
    bt._dispatch_round = spy_round
    try:
        ha = bt.blocking_start(Settings(source=SyntheticSource(
            sample_rate=16_000, channels=1, duration=3.0, freq=330.0, realtime=False)))
        ta = threading.Thread(target=lambda: list(ha.receiver), daemon=True)
        ta.start()
        deadline = time.monotonic() + 30
        while not rounds and time.monotonic() < deadline:
            time.sleep(0.01)
        assert rounds, "no round started"
        hb = bt.blocking_start(Settings(source=SyntheticSource(
            sample_rate=16_000, channels=1, duration=0.6, freq=440.0, realtime=False)))
        tb = threading.Thread(target=lambda: list(hb.receiver), daemon=True)
        tb.start()
        time.sleep(0.3)
        n_before = len(rounds)
        permits.release()
        deadline = time.monotonic() + 30
        while len(rounds) <= n_before and time.monotonic() < deadline:
            permits.release()
            time.sleep(0.01)
        assert len(rounds) > n_before, "no further round started"
        assert hb._sid in rounds[n_before], f"stream admitted late: rounds={rounds}"
        gate_on.clear()
        for _ in range(64):
            permits.release()
        ta.join(timeout=60)
        tb.join(timeout=60)
        assert not ta.is_alive() and not tb.is_alive()
    finally:
        gate_on.clear()
        for _ in range(256):
            permits.release()
        bt.close()


def test_pad_rows_are_inert(monkeypatch):
    """Padded rows (n_active) decode nothing, give no result, and leave the
    real rows' results identical to an unpadded batch."""
    monkeypatch.setattr(engine_mod, "LOGPROB_THRESHOLD", -100.0)
    cfg = port_cfg(tiny_config())
    engine = DecodeEngine(init_params(cfg, seed=0), cfg, ST, language_token_ids=TEST_LANG_IDS)
    n_frames = 2 * cfg.max_source_positions
    rng = np.random.default_rng(7)
    wins = np.stack([
        prepare_audio((0.1 * rng.standard_normal(12_000)).astype(np.float32), n_frames=n_frames)
        for _ in range(2)
    ])
    lang = TEST_LANG_IDS[0]
    want, _ = engine.transcribe_window(wins, [lang] * 2, seed=0)
    padded = np.concatenate([wins, wins[:1], wins[:1]], axis=0)
    got, _ = engine.transcribe_window(padded, [lang] * 4, seed=0, n_active=2)
    for i in range(2):
        assert got[i].tokens == want[i].tokens
        assert got[i].avg_logprob == pytest.approx(want[i].avg_logprob, abs=1e-4, nan_ok=True)
    assert got[2] is None and got[3] is None


def test_round_cap_rotates_and_completes(model):
    bt = BatchedTranscriber(model, max_streams=4, max_round_streams=2)
    rounds = []
    orig = bt._dispatch_round

    def spy(ready):
        rounds.append(sorted(s.sid for s in ready))
        return orig(ready)

    bt._dispatch_round = spy
    handles = [
        bt.blocking_start(Settings(source=_source(i, seconds=1.4, freq=220.0 + 60 * i)))
        for i in range(4)
    ]
    outs, threads = _drain_all(handles)
    time.sleep(0.5)
    for h in handles:
        h.stop()
    for t in threads:
        t.join(timeout=120)
    bt.close()
    assert len(outs) == 4
    assert rounds and all(len(r) <= 2 for r in rounds), rounds
    assert set().union(*map(set, rounds)) == {h._sid for h in handles}


def test_failing_source_start_releases_slot(model):
    bt = BatchedTranscriber(model, max_streams=1)
    try:
        class BoomSource(SyntheticSource):
            def start(self, on_data, on_end=None):
                raise RuntimeError("device open failed")

        for _ in range(3):
            with pytest.raises(RuntimeError, match="device open failed"):
                bt.blocking_start(Settings(source=BoomSource(
                    sample_rate=16_000, channels=1, duration=0.5)))
        h = bt.blocking_start(Settings(source=SyntheticSource(
            sample_rate=16_000, channels=1, duration=0.4, realtime=False)))
        assert list(h.receiver)
    finally:
        bt.close()


def test_warmup_covers_scheduler_buckets(model):
    model2 = copy.copy(model)
    bt = BatchedTranscriber(model2, max_streams=5)
    try:
        calls = []
        model2.warmup = lambda batch=1: calls.append(batch)
        bt.warmup()
        assert calls == [1, 2, 4, 5], calls
    finally:
        bt.close()
    model3 = copy.copy(model)
    bt2 = BatchedTranscriber(model3, max_streams=8, max_round_streams=3)
    try:
        calls2 = []
        model3.warmup = lambda batch=1: calls2.append(batch)
        bt2.warmup()
        assert calls2 == [1, 2, 4], calls2
    finally:
        bt2.close()


def test_warmup_runs_each_bucket_window(model):
    """The real warmup runs one window per bucket through the engine."""
    bt = BatchedTranscriber(model, max_streams=3)
    seen = []
    orig = model.engine.transcribe_window

    def spy(audio, langs, seed, n_active=None):
        seen.append(int(audio.shape[0]))
        return orig(audio, langs, seed, n_active)

    model.engine.transcribe_window = spy
    try:
        bt.warmup()
    finally:
        del model.engine.transcribe_window
        bt.close()
    assert seen == [1, 2, 3]  # buckets of max_streams=3: 1, 2, min(4, 3)


def test_close_start_race_does_not_leak_scheduler():
    cfg = port_cfg(tiny_config())
    params = init_params(cfg, seed=3)
    for _ in range(10):
        engine = DecodeEngine(params, cfg, ST, language_token_ids=TEST_LANG_IDS)
        m = WhisperModel(engine, ToyTokenizer(), LanguageState(const=TEST_LANG_IDS[0]))
        bt = BatchedTranscriber(m, max_streams=2)
        barrier = threading.Barrier(2)
        errors = []

        def starter():
            barrier.wait()
            try:
                bt.blocking_start(Settings(source=SyntheticSource(
                    sample_rate=16_000, channels=1, duration=0.3, realtime=False)))
            except Exception as e:
                errors.append(e)

        t = threading.Thread(target=starter, daemon=True)
        t.start()
        barrier.wait()
        bt.close()
        t.join(timeout=10)
        assert not t.is_alive()
        assert not bt._thread.is_alive(), "scheduler thread leaked"


def test_latency_metrics_populated(model):
    bt = BatchedTranscriber(model, max_streams=4)
    handles = [bt.blocking_start(Settings(source=_source(i, seconds=1.0))) for i in range(2)]
    time.sleep(0.4)
    for h in handles:
        h.stop()
    for h in handles:
        "".join(list(h.receiver))
    m = bt.metrics()
    bt.close()
    ra = m["latency"]["ready_to_applied"]
    assert ra is not None and ra["n"] >= 2
    assert 0.0 <= ra["p50_ms"] <= ra["p99_ms"] <= ra["max_ms"]
    af = m["latency"]["admit_to_first_partial"]
    assert af is not None and af["n"] >= 1 and af["p50_ms"] > 0
    assert m["round_cost_ema_ms"]


def test_pipelined_rounds_are_disjoint(model):
    bt = BatchedTranscriber(model, max_streams=4)
    assert bt.pipeline_rounds  # the engine's window splits into dispatch and fetch
    dispatched = []
    orig = bt._dispatch_round

    def spy(ready):
        assert all(not s.in_flight for s in ready)
        dispatched.append([s.sid for s in ready])
        return orig(ready)

    bt._dispatch_round = spy
    handles = [bt.blocking_start(Settings(source=_source(i, seconds=1.6))) for i in range(3)]
    _, threads = _drain_all(handles)
    time.sleep(0.5)
    for h in handles:
        h.stop()
    for t in threads:
        t.join(timeout=120)
    bt.close()
    assert dispatched, "no rounds dispatched"


def test_sla_round_cap_counts_streams(model):
    """The SLA cap is a stream count checked against the bucket that count
    dispatches: with max_streams=6 the buckets are 1, 2, 4, 6."""
    bt = BatchedTranscriber(model, max_streams=6, target_p99_ms=100.0)
    try:
        assert bt._sla_round_cap() == 6  # nothing measured: optimistic
        bt._round_cost_ema.update({1: 0.01, 2: 0.02, 4: 0.04, 6: 0.08})
        assert bt._sla_round_cap() == 4  # bucket 6 (5-6 streams) predicts 160 ms
        bt._round_cost_ema[4] = 0.06
        assert bt._sla_round_cap() == 2  # bucket 4 (3-4 streams) predicts 120 ms
        bt._round_cost_ema[1] = 0.2
        assert bt._sla_round_cap() == 1  # floor: one stream
        assert bt.metrics()["sla"]["round_cap"] == 1
    finally:
        bt.close()
