"""BatchedTranscriber on a mesh (the twin of tests/test_batching_mesh.py),
on the CPU over virtual devices.  The JAX file's dp=2 tp=2 plain-serving
cases run at dp=2 tp=1 here (the tp engine serves in
test_torch_batching_tp.py); its speculative ones run at dp=2 tp=2.

  - a dp=2 scheduler transcribes what the unsharded one does;
  - at dp=3 every round's batch is a multiple of 3, and the scheduler's
    thread exits on close;
  - ``warmup()`` warms every bucket on every replica: each (replica, local
    batch, detect) window a served round runs was run by the warmup, and
    so was each replica's speculative fallback at its local batch, at tp=1
    and, speculative, at dp2 x tp2.  These are the CUDA graphs' keys; on
    the card chip_smoke's mesh phase counts ``graph_captures`` after
    warmup (0; the CPU captures none);
  - at dp2 x tp2 the live speculative fallback keys its token loops'
    buffers (the CUDA graphs' keys on the card) as ``warmup_fallback``
    did, so it captures nothing new mid-utterance.
"""

import time

import numpy as np
import pytest

from helpers import TEST_LANG_IDS, TEST_ST, ToyTokenizer, confident_params, texty_config, tiny_config
from torch_port_helpers import port_cfg, port_params, port_st

from norma_tpu.model import init_params as jax_init
import norma_tpu_torch.decode.engine as engine_mod
import norma_tpu_torch.decode.speculative as spec_mod
from norma_tpu_torch.audio.sources import SyntheticSource
from norma_tpu_torch.decode import DecodeEngine, LanguageState, SpeculativeEngine
from norma_tpu_torch.errors import NormaError
from norma_tpu_torch.frontend.mel import prepare_audio
from norma_tpu_torch.input import Settings
from norma_tpu_torch.models.whisper.model import WhisperModel
from norma_tpu_torch.parallel import make_mesh, shard_batch, shard_params
from norma_tpu_torch.parallel.collectives import first
from norma_tpu_torch.runtime.batching import BatchedTranscriber

ST = port_st(TEST_ST)


def _source(seed, seconds=1.0, freq=330.0):
    return SyntheticSource(
        sample_rate=16_000, channels=1, dtype=np.float32, freq=freq, noise=0.02,
        duration=seconds, realtime=False, seed=seed,
    )


def _run_streams(bt, n=3):
    handles = [bt.blocking_start(Settings(source=_source(i, freq=220.0 + 110 * i))) for i in range(n)]
    time.sleep(0.4)
    for h in handles:
        h.stop()
    texts = ["".join(list(h.receiver)) for h in handles]
    bt.close()
    return texts


def _model(engine):
    return WhisperModel(engine, ToyTokenizer(), LanguageState(const=TEST_LANG_IDS[0]), language_tokens=TEST_LANG_IDS)


def _cpu_mesh(dp):
    return make_mesh(dp=dp, devices=["cpu"] * dp)


def test_batched_on_mesh_matches_unsharded(monkeypatch):
    # Greedy-only ladder: t>0 rungs draw seeds tied to the round's
    # composition, which depends on thread timing.
    monkeypatch.setattr(engine_mod, "TEMPERATURES", (0.0,))
    cfg = texty_config(d_model=64, encoder_attention_heads=4, decoder_attention_heads=4)
    params = port_params(confident_params(cfg))
    pcfg = port_cfg(cfg)

    def build(params_, mesh=None):
        engine = DecodeEngine(params_, pcfg, ST, language_token_ids=TEST_LANG_IDS)
        return BatchedTranscriber(_model(engine), max_streams=4, mesh=mesh)

    want = _run_streams(build(params))
    mesh = _cpu_mesh(2)
    bt = build(shard_params(params, mesh), mesh=mesh)
    engine = bt.engine
    got = _run_streams(bt)
    engine.close()
    assert got == want
    assert all(want)  # every stream emitted text


def test_non_power_of_two_dp_rounds_batch(monkeypatch):
    """dp=3: the round batch (power-of-two sized) rounds up to a multiple of
    dp, and the streams terminate."""
    monkeypatch.setattr(engine_mod, "LOGPROB_THRESHOLD", -100.0)
    cfg = port_cfg(tiny_config())
    mesh = _cpu_mesh(3)
    params = shard_params(port_params(jax_init(tiny_config(), seed=3)), mesh)
    engine = DecodeEngine(params, cfg, ST, language_token_ids=TEST_LANG_IDS)
    bt = BatchedTranscriber(_model(engine), max_streams=6, mesh=mesh)
    seen = []
    orig = engine.transcribe_window_async

    def spy(audio, langs, seed, n_active=None):
        seen.append(int(audio.shape[0]))
        return orig(audio, langs, seed=seed, n_active=n_active)

    engine.transcribe_window_async = spy
    try:
        _run_streams(bt, n=2)
    finally:
        engine.close()
    assert seen, "no decode round ran"
    assert all(b % 3 == 0 for b in seen), seen
    assert not bt._thread.is_alive()
    assert [bt._round_batch(n) for n in range(1, 7)] == [3, 3, 6, 6, 6, 6]


def test_max_streams_must_divide_over_dp():
    cfg = port_cfg(tiny_config())
    mesh = _cpu_mesh(3)
    from norma_tpu_torch.model import init_params

    engine = DecodeEngine(shard_params(init_params(cfg, seed=3), mesh), cfg, ST, language_token_ids=TEST_LANG_IDS)
    try:
        with pytest.raises(NormaError, match="not divisible by dp=3"):
            BatchedTranscriber(_model(engine), max_streams=4, mesh=mesh)
        with pytest.raises(NormaError, match="mesh"):
            BatchedTranscriber(_model(engine), max_streams=6, mesh=_cpu_mesh(2))
    finally:
        engine.close()


def _record_windows(engine, log):
    """Record (replica, local batch, detect, fallback rows) of every window
    each replica runs."""
    for i, r in enumerate(engine.replicas):
        e = r.engine
        inner = e._window_inputs  # the preamble of every window, plain or speculative

        def window(audio, langs, n_active, i=i, inner=inner):
            out = inner(audio, langs, n_active)
            log.append(("window", i, int(audio.shape[0]), out[1]))
            return out

        e._window_inputs = window
        if hasattr(e, "_fallback_rungs"):
            fb = e._fallback_rungs

            def fallback(feats, langs, seed, settled, i=i, fb=fb):
                log.append(("fallback", i, int(first(feats).shape[0])))  # each rank's features under tp
                return fb(feats, langs, seed, settled)

            e._fallback_rungs = fallback


@pytest.mark.parametrize("speculative,tp", [(False, 1), (True, 1), (True, 2)], ids=["False", "True", "True-tp2"])
def test_mesh_warmup_covers_every_served_window(monkeypatch, speculative, tp):
    """warmup() runs, on every replica, every window shape a served round
    runs there (and, speculative, every fallback shape: the gate is forced
    to fail, so every live window takes it), on dp=2 and, speculative, on
    dp2 x tp2.  Random weights: the plain ladder's t>0 rungs run too."""
    if speculative:
        monkeypatch.setattr(spec_mod, "LOGPROB_THRESHOLD", float("inf"))
    tc = dict(d_model=64, encoder_attention_heads=4, decoder_attention_heads=4)
    cfg = tiny_config(**tc)
    mesh = make_mesh(dp=2, tp=tp, devices=["cpu"] * (2 * tp))
    sp = shard_params(port_params(jax_init(cfg, seed=3)), mesh)
    if speculative:
        dcfg = tiny_config(**tc, decoder_layers=1, encoder_layers=1)
        draft = shard_params(port_params(jax_init(dcfg, seed=103)), mesh)
        engine = SpeculativeEngine(sp, port_cfg(cfg), draft, port_cfg(dcfg), ST, language_token_ids=TEST_LANG_IDS)
    else:
        engine = DecodeEngine(sp, port_cfg(cfg), ST, language_token_ids=TEST_LANG_IDS)
    bt = BatchedTranscriber(_model(engine), max_streams=4, mesh=mesh)
    warm = []
    _record_windows(engine, warm)
    try:
        bt.warmup()
        warmed = set(warm)
        assert {(w[1], w[2]) for w in warmed if w[0] == "window"} == {(0, 1), (1, 1), (0, 2), (1, 2)}
        warm.clear()
        texts = _run_streams(bt, n=3)
    finally:
        engine.close()
    assert warm, "no served window ran"
    assert set(warm) <= warmed, sorted(set(warm) - warmed)
    if speculative:
        assert any(w[0] == "fallback" for w in warm)
    assert engine.graph_captures == 0  # the CPU captures no graphs
    assert all(isinstance(t, str) for t in texts)


def test_spec_fallback_live_dispatch_hits_warmed_cache(monkeypatch):
    """The twin of the JAX test at dp2 x tp2: the t>0 fallback that
    ``warmup_fallback`` runs on each replica keys its program
    (``_fallback_key``: the CUDA graph's key on the card) exactly as the
    live gate-failure dispatch does, each rank's features included, so the
    live fallback replays the warmed graph."""
    monkeypatch.setattr(spec_mod, "LOGPROB_THRESHOLD", float("inf"))
    tc = dict(d_model=64, encoder_attention_heads=4, decoder_attention_heads=4)
    cfg, dcfg = tiny_config(**tc), tiny_config(**tc, decoder_layers=1, encoder_layers=1)
    mesh = make_mesh(dp=2, tp=2, devices=["cpu"] * 4)
    engine = SpeculativeEngine(
        shard_params(port_params(jax_init(cfg, seed=3)), mesh), port_cfg(cfg),
        shard_params(port_params(jax_init(dcfg, seed=103)), mesh), port_cfg(dcfg), ST,
        language_token_ids=TEST_LANG_IDS,
    )
    keys = {"warm": set(), "live": set()}
    phase = ["warm"]
    for i, r in enumerate(engine.replicas):
        inner = r.engine._fallback_key

        def spy(feats, i=i, inner=inner):
            key = inner(feats)
            keys[phase[0]].add((i, key))
            return key

        r.engine._fallback_key = spy
    B = 2
    try:
        engine.warmup_fallback(batch=B)
        phase[0] = "live"
        sr = 16_000
        sine = (0.1 * np.sin(2 * np.pi * 440 * np.arange(2 * sr) / sr)).astype(np.float32)
        win = prepare_audio(sine, n_frames=2 * cfg.max_source_positions)
        results, _ = engine.transcribe_window(shard_batch(np.stack([win] * B), mesh), [TEST_LANG_IDS[0]] * B, seed=7)
    finally:
        engine.close()
    assert len(results) == B
    assert {i for i, _ in keys["live"]} == {0, 1}, "the live fallback did not run on every replica"
    assert keys["live"] <= keys["warm"], sorted(keys["live"] - keys["warm"])
    assert engine.graph_captures == 0
