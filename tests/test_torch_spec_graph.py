"""The speculative window and its t>0 fallback as device programs, on the CPU.

On CUDA a speculative window is one CUDA graph per (rows, samples,
detection, K) whose round loop is one WHILE node, and its fallback one
graph per rows; each makes one host read, its fetch.  On the CPU the same
structure runs eagerly, the stop tests read on the host and not counted.
These tests hold that structure against the port's eager paths and the
JAX package, f32:

  - a window at K = 1, 2, 4 and B = 1, 3 (one padding row) makes one host
    read; its results and rounds equal ``transcribe_window_eager``'s (the
    rounds one by one, a host read before each) bit for bit, and its
    tokens the plain engine's greedy ladder's and the JAX
    SpeculativeEngine's at the same K;
  - a window whose live rows fail the logprob gate makes two host reads,
    the second the fallback's, and equals the eager path's and the plain
    sequential ladder's;
  - the run before a capture makes one round even when every row is born
    finished, so a warm-up window of silence captures the round loop that
    a live window replays;
  - ``SpeculativeEngine.transcribe_window_eager`` decodes speculatively;
  - a tp=2 engine over one process's ranks (a LocalGroup) makes one host
    read a window, its results equal to tp=1's;
  - ``decode_with_fallback`` (one ``run_loop`` program and read per rung
    tried) equals the JAX package's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import TEST_LANG_IDS, TEST_ST, confident_params, texty_config, tiny_config
from torch_port_helpers import port_cfg, port_params, port_st

import norma_tpu.decode.engine as jax_engine_mod
import norma_tpu_torch.decode.engine as engine_mod
from norma_tpu.decode.engine import DecodeEngine as JaxEngine
from norma_tpu.decode.speculative import SpeculativeEngine as JaxSpec
from norma_tpu.model import init_params as jax_init
from norma_tpu_torch.decode import DecodeEngine, SpeculativeEngine
from norma_tpu_torch.frontend.mel import prepare_audio
from norma_tpu_torch.parallel import make_mesh, shard_params

ST = port_st(TEST_ST)
LANG = TEST_LANG_IDS[0]
TC = dict(d_model=64, encoder_attention_heads=4, decoder_attention_heads=4)


def _models(**tc):
    """(JAX target, draft, their configs; the port's params, draft, configs):
    a confident texty target (every row accepted at rung 0, EOT suppressed,
    so rows run to the length guard) and a random one-layer draft."""
    jcfg, jdcfg = texty_config(**tc), texty_config(**tc, decoder_layers=1, encoder_layers=1)
    jp, jd = confident_params(jcfg, seed=3), jax_init(jdcfg, seed=103)
    return (jp, jd, jcfg, jdcfg), (port_params(jp), port_params(jd), port_cfg(jcfg), port_cfg(jdcfg))


@pytest.fixture(scope="module")
def models():
    return _models()


def _spec(port, **kw):
    params, dparams, cfg, dcfg = port
    return SpeculativeEngine(params, cfg, dparams, dcfg, ST, language_token_ids=TEST_LANG_IDS, **kw)


def _audio(B, cfg, seed):
    rng = np.random.default_rng(seed)
    k = 2 * cfg.max_source_positions * 160
    return np.stack([prepare_audio((0.1 * rng.standard_normal(k)).astype(np.float32),
                                   n_frames=2 * cfg.max_source_positions) for _ in range(B)])


def _rows(drs):
    """Each row's tokens and both floats' bits (NaN equals itself)."""
    bits = lambda x: np.float64(x).tobytes()  # noqa: E731
    return [d and (d.tokens, bits(d.avg_logprob), bits(d.no_speech_prob)) for d in drs]


def _telemetry(eng):
    return eng.last_spec_rounds, eng.last_tokens_per_round, eng.last_spec_k


@pytest.mark.parametrize("B", [1, 3], ids=["B1", "B3_padded"])
@pytest.mark.parametrize("spec_k", [1, 2, 4])
def test_spec_window_one_read(models, spec_k, B):
    (jp, jd, jcfg, jdcfg), port = models
    cfg = port[2]
    audio = _audio(B, cfg, seed=10 + B)
    na = None if B == 1 else 2
    spec = _spec(port, spec_k=spec_k)
    rounds = []
    inner = spec._spec_round
    spec._spec_round = lambda *a: (rounds.append(1), inner(*a))[1]
    got, gi = spec.transcribe_window(audio, [LANG] * B, 5, n_active=na)
    assert spec.host_syncs == 1  # the window's one read: no fallback on confident rows
    assert len(rounds) == spec.last_spec_rounds >= 1  # the round loop's passes: the rounds
    tel = _telemetry(spec)
    h0 = spec.host_syncs
    eager, ei = spec.transcribe_window_eager(audio, [LANG] * B, 5, n_active=na)
    assert _rows(got) == _rows(eager) and _telemetry(spec) == tel
    budget = cfg.max_target_positions - 4
    assert spec.host_syncs - h0 == min(tel[0] + 1, budget) + 1  # a read a round, and the fetch
    np.testing.assert_array_equal(gi["langs"], ei["langs"])
    rows = na or 1
    assert all(d is not None and len(d.tokens) > 3 for d in got[:rows]) and got[rows:] == [None] * (B - rows)
    plain = DecodeEngine(port[0], cfg, ST, language_token_ids=TEST_LANG_IDS)
    want, _ = plain.transcribe_window(audio, [LANG] * B, 5, n_active=na)
    assert [d and d.tokens for d in got] == [d and d.tokens for d in want]
    jspec = JaxSpec(jp, jcfg, jd, jdcfg, TEST_ST, language_token_ids=TEST_LANG_IDS, spec_k=spec_k)
    jgot, _ = jspec.transcribe_window(jnp.asarray(audio), [LANG] * B, 5, n_active=na)
    assert [d and d.tokens for d in got] == [d and d.tokens for d in jgot]
    assert tel[0] == jspec.last_spec_rounds and tel[1] == pytest.approx(jspec.last_tokens_per_round)


# Random weights at mtp 12 stop before the tiny timestamp space deadlocks,
# so avg_logprob stays finite and the default gate rejects rung 0
# (tests/test_torch_window_graph.py).
FCFG = tiny_config(max_target_positions=12)


@pytest.fixture(scope="module")
def failing():
    jp = jax_init(FCFG, seed=0)
    jdcfg = tiny_config(max_target_positions=12, decoder_layers=1, encoder_layers=1)
    return jp, (port_params(jp), port_params(jax_init(jdcfg, seed=100)), port_cfg(FCFG), port_cfg(jdcfg))


@pytest.mark.parametrize("spec_k", [1, 2, 4])
def test_spec_fallback_two_reads(failing, spec_k):
    """Live rows whose greedy rung fails the logprob gate take the t>0
    fallback: two host reads (the window's, the fallback's), results equal
    the eager path's bit for bit and the plain engine's sequential ladder
    (the same rung keys) result for result; the padding row stays empty."""
    _, port = failing
    audio = _audio(3, port[2], seed=21)
    spec = _spec(port, spec_k=spec_k)
    calls = []
    inner = spec._fallback
    spec._fallback = lambda *a, **k: (calls.append(1), inner(*a, **k))[1]
    got, _ = spec.transcribe_window(audio, [LANG] * 3, 9, n_active=2)
    assert spec.host_syncs == 2 and len(calls) == 1
    eager, _ = spec.transcribe_window_eager(audio, [LANG] * 3, 9, n_active=2)
    assert len(calls) == 2
    assert _rows(got) == _rows(eager)
    assert got[2] is None
    plain = DecodeEngine(port[0], port[2], ST, language_token_ids=TEST_LANG_IDS)
    want, _ = plain.transcribe_window(audio, [LANG] * 3, 9, n_active=2)
    for a, b in zip(got, want):
        assert (a is None) == (b is None)
        if a is not None:
            assert a.tokens == b.tokens and a.avg_logprob == pytest.approx(b.avg_logprob, abs=1e-4)


def test_spec_warm_run_makes_one_round(models):
    """Rows all born finished (padding, as silence under the no-speech
    gate): the round loop runs no round, but the run before a capture
    (``_warming``) runs one, so the capture records the round's body; the
    loop's stop test is rows and rounds against ``mtp - 1 - n0``."""
    _, port = models
    cfg = port[2]
    spec = _spec(port, spec_k=2)
    rounds, whiles = [], []
    inner, dwhile = spec._spec_round, spec._device_while
    spec._spec_round = lambda *a: (rounds.append(1), inner(*a))[1]
    spec._device_while = lambda buf, pos_end, body: (whiles.append((buf.fin.tolist(), pos_end)),
                                                     dwhile(buf, pos_end, body))[1]
    audio = torch.from_numpy(_audio(2, cfg, seed=3))
    args = (audio, torch.tensor([LANG] * 2), torch.zeros(2, dtype=torch.bool))
    packed, _ = spec._spec_window(*args, detect=False, k=2)
    assert rounds == [] and (packed[:, -1] == 0).all()
    spec._warming = True
    try:
        spec._spec_window(*args, detect=False, k=2)
    finally:
        spec._warming = False
    assert rounds == [1]
    assert whiles == [([True, True], cfg.max_target_positions - 4)] * 2


def test_spec_eager_decodes_speculatively(models):
    """The speculative engine's own eager window: rounds of draft and
    verify, not the plain ladder's per-step loop (which only a fallback
    runs)."""
    _, port = models
    spec = _spec(port, spec_k=4)
    rounds, steps = [], []
    inner, plain_loop = spec._spec_round, spec._token_loop_eager
    spec._spec_round = lambda *a: (rounds.append(1), inner(*a))[1]
    spec._token_loop_eager = lambda *a, **k: (steps.append(1), plain_loop(*a, **k))[1]
    audio = _audio(1, port[2], seed=30)
    eager, _ = spec.transcribe_window_eager(audio, [LANG], 0)
    assert rounds and not steps and len(rounds) == spec.last_spec_rounds
    got, _ = spec.transcribe_window(audio, [LANG], 0)
    assert _rows(got) == _rows(eager)


@pytest.mark.parametrize("B", [1, 3], ids=["B1", "B3_padded"])
def test_local_group_spec_window_one_read(B):
    """tp=2 ranks in one process (a LocalGroup): the window is one device
    program with one host read, its results and rounds equal tp=1's and
    its own eager window's."""
    _, port = _models(**TC)
    params, dparams, cfg, dcfg = port
    audio = _audio(B, cfg, seed=40 + B)
    na = None if B == 1 else 2
    one = _spec(port, spec_k=2)
    want, _ = one.transcribe_window(audio, [LANG] * B, 3, n_active=na)
    mesh = make_mesh(tp=2, devices=["cpu"] * 2)
    eng = SpeculativeEngine(shard_params(params, mesh), cfg, shard_params(dparams, mesh), dcfg, ST,
                            language_token_ids=TEST_LANG_IDS, spec_k=2)
    try:
        r0 = eng.replicas[0].engine
        got, _ = eng.transcribe_window(audio, [LANG] * B, 3, n_active=na)
        assert r0.host_syncs == 1
        assert _telemetry(r0) == _telemetry(one)
        eager, _ = r0.transcribe_window_eager(audio, [LANG] * B, 3, n_active=na)
    finally:
        eng.close()
    assert _rows(got) == _rows(eager)
    assert [d and d.tokens for d in got] == [d and d.tokens for d in want]
    np.testing.assert_allclose([d.avg_logprob for d in got[:na or 1]], [d.avg_logprob for d in want[:na or 1]],
                               atol=1e-4)


@pytest.mark.parametrize("forced", [False, True], ids=["rung0", "every_rung_fails"])
def test_decode_with_fallback_matches_jax(models, failing, monkeypatch, forced):
    """decode_with_fallback at B=1: one host read for the prefill's
    no-speech probe and one a rung tried (each rung one run_loop program);
    rung 0's tokens equal the JAX package's (confident weights), and with
    every rung forced to fail (finite averages under an infinite
    threshold) both return None after all six."""
    if forced:
        jp, port = failing
        jcfg = FCFG
        monkeypatch.setattr(engine_mod, "LOGPROB_THRESHOLD", float("inf"))
        monkeypatch.setattr(jax_engine_mod, "LOGPROB_THRESHOLD", float("inf"))
    else:
        (jp, _, jcfg, _), port = models
    cfg = port[2]
    feats = np.random.default_rng(50).standard_normal((1, cfg.max_source_positions, cfg.d_model))
    feats = (0.5 * feats).astype(np.float32)
    eng = DecodeEngine(port[0], cfg, ST, language_token_ids=TEST_LANG_IDS)
    got = eng.decode_with_fallback(torch.from_numpy(feats), LANG, seed=4)
    je = JaxEngine(jp, jcfg, TEST_ST, language_token_ids=TEST_LANG_IDS)
    want = je.decode_with_fallback(jnp.asarray(feats), LANG, seed=4)
    if forced:
        assert got is None and want is None
        assert eng.host_syncs == 1 + len(engine_mod.TEMPERATURES)
        return
    assert eng.host_syncs == 2
    assert got.tokens == want.tokens and len(got.tokens) > 3
    assert got.avg_logprob == pytest.approx(want.avg_logprob, abs=1e-4, nan_ok=True)
