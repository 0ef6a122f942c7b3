"""The port's latency knobs (``norma_tpu_torch/runtime/batching.py``,
``audio/pipeline.py``): SLA round sizing and the early first-partial
flush, the six cases of ``tests/test_latency_knobs.py`` on the port's tiny
engine (the JAX package's seeded weights carried by ``params_from_numpy``).
"""

import time

import numpy as np

from helpers import TEST_LANG_IDS, TEST_ST, ToyTokenizer, tiny_config
from norma_tpu.model import init_params as jax_init_params
from torch_port_helpers import port_cfg, port_params, port_st

from norma_tpu_torch.audio.pipeline import Packer
from norma_tpu_torch.audio.sources import SyntheticSource
from norma_tpu_torch.decode import DecodeEngine, LanguageState
from norma_tpu_torch.input import Settings
from norma_tpu_torch.models.whisper.model import WhisperModel
from norma_tpu_torch.runtime.batching import BatchedTranscriber
from norma_tpu_torch.runtime.channels import RecycledRing


def test_packer_first_flush_is_short_but_not_final():
    ring = RecycledRing(8, chunk_len=1000)
    p = Packer(ring, first_flush_len=300)
    p.append(np.ones(250, np.float32))
    assert ring.poll()[0] == "empty"  # below the early threshold
    p.append(np.ones(100, np.float32))
    status, chunk = ring.poll()
    assert status == "chunk"
    assert chunk.length == 350  # flushed the moment the threshold passed
    assert chunk.is_final is False  # short but EXPLICITLY non-final
    ring.release(chunk)
    # Steady state reverts to full-chunk cadence.
    p.append(np.ones(1400, np.float32))
    status, chunk = ring.poll()
    assert status == "chunk"
    assert chunk.length == 1000 and not chunk.is_final
    ring.release(chunk)
    # EOS stays the reference's capacity-based protocol (one sample
    # popped, short chunk == final).
    p.close()
    status, chunk = ring.poll()
    assert status == "chunk"
    assert chunk.length == 1400 - 1000 - 1  # leftover minus the popped one
    assert chunk.is_final is True


def test_packer_without_first_flush_unchanged():
    ring = RecycledRing(8, chunk_len=100)
    p = Packer(ring)
    p.append(np.ones(99, np.float32))
    assert ring.poll()[0] == "empty"
    p.close()
    status, chunk = ring.poll()
    assert status == "chunk" and chunk.length == 98 and chunk.is_final


def _model():
    cfg = tiny_config()
    engine = DecodeEngine(
        port_params(jax_init_params(cfg, seed=3)), port_cfg(cfg), port_st(TEST_ST),
        language_token_ids=TEST_LANG_IDS,
    )
    return WhisperModel(
        engine, ToyTokenizer(), LanguageState(const=TEST_LANG_IDS[0]), language_tokens=TEST_LANG_IDS,
    )


def _source(seed=0, seconds=1.0):
    return SyntheticSource(
        sample_rate=16_000, channels=1, dtype=np.float32,
        freq=330.0, noise=0.02, duration=seconds, realtime=False, seed=seed,
    )


def test_first_partial_stream_still_retires_exactly_once():
    # The early short non-final chunk must not be mistaken for EOS: the
    # stream keeps capturing, retires on the true final chunk, and the
    # receiver terminates.
    bt = BatchedTranscriber(_model(), max_streams=2, first_partial_seconds=0.25)
    h = bt.blocking_start(Settings(source=_source()))
    time.sleep(0.3)
    h.stop()
    list(h.receiver)  # terminates (sender closed on retire)
    deadline = time.time() + 5
    while time.time() < deadline and bt._streams:
        time.sleep(0.05)
    assert not bt._streams, "stream never retired"
    bt.close()


def test_sla_round_cap_from_cost_model():
    # The port's cap is a stream COUNT, checked against the bucket each
    # count dispatches (ROADMAP, "Faults in the reference" 3: JAX's
    # _sla_round_cap returns a bucket width).  At max_streams=8 the buckets
    # are powers of two, so every case below gives the JAX test's numbers
    # as counts; tests/test_torch_batching.py::
    # test_sla_round_cap_counts_streams covers buckets where they differ.
    bt = BatchedTranscriber(_model(), max_streams=8, target_p99_ms=500.0)
    try:
        # No measurements yet: optimistic (all 8 streams).
        assert bt._sla_round_cap() == 8
        # 2 x 300 ms > 500 ms: 5-8 streams (bucket 8) violate, 3-4 streams
        # (bucket 4, 160 ms) hold.
        bt._round_cost_ema = {8: 0.300, 4: 0.160, 2: 0.100}
        assert bt._sla_round_cap() == 4
        # Everything violates: floor at one stream.
        bt._round_cost_ema = {1: 0.400, 2: 0.5, 4: 0.6, 8: 0.7}
        assert bt._sla_round_cap() == 1
        # A violating middle bucket stops the scan even when a wider bucket
        # is unmeasured (cost is monotone in B): 3 streams (bucket 4) violate.
        bt._round_cost_ema = {4: 0.400}
        assert bt._sla_round_cap() == 2
        m = bt.metrics()
        assert m["sla"]["target_p99_ms"] == 500.0
        assert m["sla"]["round_cap"] == 2
    finally:
        bt.close()


def test_sla_caps_live_round_width():
    model = _model()
    engine = model.engine
    calls = []
    orig = engine.transcribe_window_async

    def spy(audio, langs, seed, n_active=None):
        calls.append(int(audio.shape[0]))
        return orig(audio, langs, seed, n_active=n_active)

    engine.transcribe_window_async = spy
    bt = BatchedTranscriber(model, max_streams=8, target_p99_ms=50.0)
    # Pretend every bucket above 1 already measured way over the SLA.
    bt._round_cost_ema = {2: 10.0, 4: 10.0, 8: 10.0}
    hs = [bt.blocking_start(Settings(source=_source(i))) for i in range(4)]
    time.sleep(0.6)
    for h in hs:
        h.stop()
    for h in hs:
        list(h.receiver)
    bt.close()
    assert calls, "no rounds dispatched"
    # Every round was capped to ONE stream (bucket 1) by the SLA.
    assert all(b == 1 for b in calls), calls


def test_round_cost_ema_populates():
    bt = BatchedTranscriber(_model(), max_streams=4)
    hs = [bt.blocking_start(Settings(source=_source(i))) for i in range(2)]
    time.sleep(0.3)
    for h in hs:
        h.stop()
    for h in hs:
        list(h.receiver)
    m = bt.metrics()
    bt.close()
    assert m["round_cost_ema_ms"], "cost model never updated"
    assert all(v > 0 for v in m["round_cost_ema_ms"].values())
