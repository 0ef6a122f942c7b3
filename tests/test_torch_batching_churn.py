"""Stream churn on the port's batched scheduler
(``norma_tpu_torch/runtime/batching.py``), the seven cases of
``tests/test_batching_churn.py`` on the port's tiny engine (the JAX
package's ``texty_config`` + ``confident_params`` carried by
``params_from_numpy``).

Streams start and end in overlapping waves, one receiver is abandoned
mid-stream (the scheduler must tear that stream down and keep serving the
others), slots must be reusable after retirement, and close() must join
cleanly with no stuck threads.  The last case is the port's soak tool's
CPU self-test.
"""

import threading
import time

import pytest

from helpers import TEST_LANG_IDS, TEST_ST, ToyTokenizer, confident_params, texty_config
from torch_port_helpers import port_cfg, port_params, port_st

from norma_tpu_torch.audio.sources import SyntheticSource
from norma_tpu_torch.decode import DecodeEngine, LanguageState
from norma_tpu_torch.input import Settings
from norma_tpu_torch.models.whisper.model import WhisperModel
from norma_tpu_torch.runtime.batching import BatchedTranscriber, TooManyStreams


def _source(i):
    return SyntheticSource(
        sample_rate=16000, channels=1, duration=0.6, freq=250.0 + 40 * i,
        realtime=False,
    )


def _toy_model():
    cfg = texty_config()
    engine = DecodeEngine(
        port_params(confident_params(cfg)), port_cfg(cfg), port_st(TEST_ST), language_token_ids=TEST_LANG_IDS
    )
    return WhisperModel(engine, ToyTokenizer(), LanguageState(const=TEST_LANG_IDS[0]))


def test_churn_waves_and_abandoned_receiver():
    bt = BatchedTranscriber(_toy_model(), max_streams=3)
    try:
        results = {}
        threads = []

        def drain(tag, handle):
            results[tag] = list(handle.receiver)

        total_started = 0
        for wave in range(3):
            handles = []
            for i in range(3):
                # The abandoned stream from the previous wave retires
                # asynchronously (the scheduler notices ReceiverClosed at a
                # round boundary) — bounded-wait admission absorbs that.
                h = bt.blocking_start(
                    Settings(source=_source(total_started)), timeout=60.0
                )
                handles.append(h)
                total_started += 1
            # Abandon one receiver immediately: the scheduler must drop the
            # stream (ReceiverClosed) without affecting its batch-mates.
            handles[0].receiver.close()
            for i, h in enumerate(handles[1:], start=1):
                t = threading.Thread(
                    target=drain, args=(f"w{wave}s{i}", h), daemon=True
                )
                t.start()
                threads.append(t)
            for t in threads:
                t.join(timeout=120)
            assert not any(t.is_alive() for t in threads), "drain thread stuck"
            threads.clear()

        # 9 streams on 3 slots: retirement must have freed slots each wave.
        assert total_started == 9
        # Every non-abandoned stream produced output and terminated.
        assert len(results) == 6
        for tag, segs in results.items():
            assert segs, f"stream {tag} produced no output"
            assert all(isinstance(s, str) for s in segs)
        # Under nominal load (receivers drained promptly) the lossy paths
        # must not fire: zero transcript drops, zero audio-chunk drops.
        m = bt.metrics()
        assert m["transcript_drops"] == 0, m
        assert m["audio_drops"] == 0, m
    finally:
        bt.close()
    assert not bt._thread.is_alive(), "scheduler thread did not exit"


def test_stop_mid_stream_releases_slot():
    bt = BatchedTranscriber(_toy_model(), max_streams=1)
    try:
        h1 = bt.blocking_start(
            Settings(source=SyntheticSource(sample_rate=16000, channels=1,
                                            duration=30.0, realtime=False))
        )
        time.sleep(0.2)
        h1.stop()  # flushes the final chunk; stream retires after drain
        out1 = list(h1.receiver)
        assert out1, "stopped stream must still flush its transcript"

        # The single slot must be free again.
        h2 = bt.blocking_start(Settings(source=_source(1)))
        out2 = list(h2.receiver)
        assert out2
    finally:
        bt.close()


def test_admission_timeout_semantics():
    """timeout=0 rejects a full scheduler immediately (reference shape,
    lib.rs:649-661); timeout>0 admits once an in-flight retirement frees
    the slot; waiters see close() promptly instead of timing out."""
    bt = BatchedTranscriber(_toy_model(), max_streams=1)
    try:
        h1 = bt.blocking_start(Settings(source=_source(0)))
        with pytest.raises(TooManyStreams):
            bt.blocking_start(Settings(source=_source(1)))  # timeout=0
        # h1's source is finite and non-realtime: it retires as soon as the
        # scheduler drains it, so a bounded wait must win the slot.
        drained = threading.Thread(
            target=lambda: list(h1.receiver), daemon=True
        )
        drained.start()
        h2 = bt.blocking_start(Settings(source=_source(1)), timeout=60.0)
        assert list(h2.receiver)
        drained.join(timeout=60)
    finally:
        bt.close()
    # A waiter behind a closed scheduler errors out promptly.
    t0 = time.monotonic()
    with pytest.raises(Exception, match="closed"):
        bt.blocking_start(Settings(source=_source(2)), timeout=60.0)
    assert time.monotonic() - t0 < 5.0


class _GatedStartSource(SyntheticSource):
    """start() blocks on an event first — models a slow/hung device open."""

    def __init__(self, gate: threading.Event, fail: bool = False, **kw):
        kw.setdefault("sample_rate", 16000)
        kw.setdefault("channels", 1)
        kw.setdefault("duration", 0.6)
        kw.setdefault("realtime", False)
        super().__init__(**kw)
        self._gate = gate
        self._fail = fail

    def start(self, on_data, on_end=None):
        assert self._gate.wait(timeout=30), "test gate never opened"
        if self._fail:
            raise RuntimeError("device open failed")
        super().start(on_data, on_end)


def _toy_bt(max_streams):
    return BatchedTranscriber(_toy_model(), max_streams=max_streams)


def test_failed_start_wakes_admission_waiter():
    """A source whose start() raises frees its reserved slot AND signals a
    blocked bounded-wait admitter — without the notify the waiter would
    sleep out its whole timeout against a free slot."""
    bt = _toy_bt(1)
    try:
        gate = threading.Event()
        errs = []

        def admit_failing():
            try:
                bt.blocking_start(Settings(source=_GatedStartSource(gate, fail=True)))
            except RuntimeError as e:
                errs.append(e)

        a = threading.Thread(target=admit_failing, daemon=True)
        a.start()
        time.sleep(0.2)  # A holds the only slot, parked in start()
        got = {}

        def admit_waiting():
            got["h"] = bt.blocking_start(Settings(source=_source(1)), timeout=30.0)

        b = threading.Thread(target=admit_waiting, daemon=True)
        b.start()
        time.sleep(0.2)  # B is now waiting on the slot condition
        t0 = time.monotonic()
        gate.set()  # A's start() raises -> slot freed + notified
        a.join(timeout=10)
        b.join(timeout=10)
        assert errs and "device open failed" in str(errs[0])
        assert "h" in got, "waiter never admitted after failed-start freed the slot"
        assert time.monotonic() - t0 < 5.0, "waiter woke only by timeout, not notify"
        assert list(got["h"].receiver)
    finally:
        bt.close()


def test_slow_source_start_does_not_stall_scheduler():
    """pipeline.start() runs outside the scheduler lock: while one
    admission is parked in a slow source start, live streams keep
    decoding and retiring."""
    bt = _toy_bt(2)
    try:
        h1 = bt.blocking_start(Settings(source=_source(0)))
        gate = threading.Event()
        got = {}
        t = threading.Thread(
            target=lambda: got.setdefault(
                "h", bt.blocking_start(Settings(source=_GatedStartSource(gate)))
            ),
            daemon=True,
        )
        t.start()
        time.sleep(0.2)  # admission parked inside start()
        # Stream 1 must run to completion while the start is pending.
        out1 = list(h1.receiver)
        assert out1, "live stream starved while another admission was starting"
        gate.set()
        t.join(timeout=30)
        assert "h" in got and list(got["h"].receiver)
    finally:
        bt.close()


def test_close_races_inflight_start():
    """close() during an in-flight source start must not wedge, and the
    raced admission must come back closed with its source torn down (a
    stop-then-start interleave would otherwise leave the worker live)."""
    bt = _toy_bt(1)
    gate = threading.Event()
    src = _GatedStartSource(gate, duration=30.0)
    errs = []

    def admit():
        try:
            bt.blocking_start(Settings(source=src))
        except Exception as e:
            errs.append(e)

    t = threading.Thread(target=admit, daemon=True)
    t.start()
    time.sleep(0.2)  # admission parked inside start()
    t0 = time.monotonic()
    bt.close()  # must not block on the parked start
    assert time.monotonic() - t0 < 10.0
    gate.set()
    t.join(timeout=30)
    assert errs and "closed" in str(errs[0])
    assert src._thread is None or not src._thread.is_alive(), (
        "source worker left running behind a closed transcriber"
    )


def test_soak_tool_self_test(capsys):
    """``python -m norma_tpu_torch.tools.soak_serving --cpu`` is the
    hermetic self-test of the card's soak; keep it green."""
    from norma_tpu_torch.tools import soak_serving

    out = soak_serving.main(["--cpu", "--minutes", "0.05", "--streams", "2"])
    assert "SOAK PASS" in capsys.readouterr().out
    assert out["streams"] >= 2 and out["metrics"]["audio_drops"] == 0
