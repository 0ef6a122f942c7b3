"""BatchedTranscriber on tensor-parallel meshes (the (2, 2) and (1, 2)
twins of tests/test_batching_mesh.py's mesh cases), on the CPU over
virtual devices: each dp position's tp ranks in one process.

  - a dp2 x tp2 and a tp=2 scheduler transcribe what the unsharded one
    does;
  - ``warmup()`` on those meshes runs every window shape a served round
    runs on every dp position (the CUDA graphs' keys on the card; the CPU
    captures none).

Tolerance: emitted texts equal (greedy-only ladder, confident weights).
"""

import time

import numpy as np
import pytest

from helpers import TEST_LANG_IDS, TEST_ST, ToyTokenizer, confident_params, texty_config, tiny_config
from torch_port_helpers import port_cfg, port_params, port_st

from norma_tpu.model import init_params as jax_init
import norma_tpu_torch.decode.engine as engine_mod
from norma_tpu_torch.audio.sources import SyntheticSource
from norma_tpu_torch.decode import DecodeEngine, LanguageState
from norma_tpu_torch.input import Settings
from norma_tpu_torch.models.whisper.model import WhisperModel
from norma_tpu_torch.parallel import make_mesh, shard_params
from norma_tpu_torch.runtime.batching import BatchedTranscriber

ST = port_st(TEST_ST)
TC = dict(d_model=64, encoder_attention_heads=4, decoder_attention_heads=4)


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


@pytest.mark.parametrize("dp,tp", [(2, 2), (1, 2)])
def test_batched_on_tp_mesh_matches_unsharded(monkeypatch, dp, tp):
    monkeypatch.setattr(engine_mod, "TEMPERATURES", (0.0,))
    cfg = texty_config(**TC)
    params = port_params(confident_params(cfg))
    pcfg = port_cfg(cfg)

    def build(params_, mesh=None):
        engine = DecodeEngine(params_, pcfg, ST, language_token_ids=TEST_LANG_IDS)
        return BatchedTranscriber(_model(engine), max_streams=4, mesh=mesh)

    want = _run_streams(build(params))
    mesh = make_mesh(dp=dp, tp=tp, devices=["cpu"] * (dp * tp))
    bt = build(shard_params(params, mesh), mesh=mesh)
    engine = bt.engine
    try:
        assert all(r.engine._group.size == tp for r in engine.replicas)
        got = _run_streams(bt)
    finally:
        engine.close()
    assert got == want
    assert all(want)


@pytest.mark.parametrize("dp,tp", [(2, 2), (1, 2)])
def test_tp_mesh_warmup_covers_every_served_window(dp, tp):
    cfg = tiny_config(**TC)
    mesh = make_mesh(dp=dp, tp=tp, devices=["cpu"] * (dp * tp))
    engine = DecodeEngine(shard_params(port_params(jax_init(cfg, seed=3)), mesh), port_cfg(cfg), ST,
                          language_token_ids=TEST_LANG_IDS)
    bt = BatchedTranscriber(_model(engine), max_streams=4, mesh=mesh)
    log = []
    for i, r in enumerate(engine.replicas):
        inner = r.engine._window_inputs

        def window(audio, langs, n_active, i=i, inner=inner):
            out = inner(audio, langs, n_active)
            log.append((i, int(audio.shape[0]), out[1]))
            return out

        r.engine._window_inputs = window
    try:
        bt.warmup()
        warmed = set(log)
        assert {(w[0], w[1]) for w in warmed} == {(i, b // dp) for i in range(dp) for b in bt_buckets(bt)}
        log.clear()
        texts = _run_streams(bt, n=3)
    finally:
        engine.close()
    assert log, "no served window ran"
    assert set(log) <= warmed, sorted(set(log) - warmed)
    assert engine.graph_captures == 0
    assert all(isinstance(t, str) for t in texts)


def bt_buckets(bt):
    return sorted({bt._round_batch(n) for n in range(1, bt.max_streams + 1)})
