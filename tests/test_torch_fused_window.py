"""The port's fused window (DecodeEngine.transcribe_window: mel, encoder,
prefill, token loop and ladder in one call) against its own compositional
path (encode -> decode_with_fallback) and against the JAX package's
window (tests/test_fused_window.py's cases), on the CPU at f32.

Random tiny models essentially never pass the avg_logprob >= -1 gate, so
the thresholds are monkeypatched in both packages' engine modules to carve
out each deterministic regime: LOGPROB_THRESHOLD=-100 (every window
accepts at rung 0, greedy), NO_SPEECH_THRESHOLD=0 (the probe always fires)
and a greedy-only ladder at the default gates (all rungs fail).  Tokens
must be equal; avg_logprob within 1e-4 and no_speech_prob within 1e-5
(f32 sums in other orders).
"""

import numpy as np
import pytest
import torch

import norma_tpu.decode.engine as jengine_mod
import norma_tpu_torch.decode.engine as engine_mod
from helpers import TEST_LANG_IDS, TEST_ST, tiny_config
from norma_tpu.decode.engine import DecodeEngine as JEngine
from norma_tpu.model import init_params as jinit
from norma_tpu_torch.decode.engine import DecodeEngine
from norma_tpu_torch.frontend.mel import log_mel_spectrogram, prepare_audio
from torch_port_helpers import port_cfg, port_params, port_st

JCFG = tiny_config()
JPARAMS = jinit(JCFG, seed=0)
CFG = port_cfg(JCFG)
PARAMS = port_params(JPARAMS)
ST = port_st(TEST_ST)


def engines(jcfg=JCFG, jparams=JPARAMS):
    port = DecodeEngine(PARAMS if jparams is JPARAMS else port_params(jparams), port_cfg(jcfg), ST,
                        language_token_ids=TEST_LANG_IDS)
    return port, JEngine(jparams, jcfg, TEST_ST, language_token_ids=TEST_LANG_IDS)


def window(seed, seconds=0.5, cfg=CFG, samples=None):
    rng = np.random.default_rng(seed)
    raw = (0.1 * rng.standard_normal(samples or int(seconds * 16000))).astype(np.float32)
    return prepare_audio(raw, n_frames=2 * cfg.max_source_positions)[None]


def unfused(engine, audio, lang, seed=0):
    cfg = engine.cfg
    mel = log_mel_spectrogram(torch.from_numpy(audio), n_mels=cfg.num_mel_bins, n_frames=2 * cfg.max_source_positions)
    return engine.decode_with_fallback(engine.encode(mel), lang, seed=seed)


def _same(got, want, avg=True):
    assert got is not None and want is not None
    assert got.tokens == want.tokens
    if avg:
        assert got.avg_logprob == pytest.approx(want.avg_logprob, abs=1e-4, nan_ok=True)
    assert got.no_speech_prob == pytest.approx(want.no_speech_prob, abs=1e-5)


def _accept_all(monkeypatch):
    monkeypatch.setattr(engine_mod, "LOGPROB_THRESHOLD", -100.0)
    monkeypatch.setattr(jengine_mod, "LOGPROB_THRESHOLD", -100.0)


def test_fused_rung0_exact_parity(monkeypatch):
    """Accept-everything gate: the fused window equals the compositional
    path and the JAX window, token for token."""
    _accept_all(monkeypatch)
    port, jax_engine = engines()
    lang = TEST_LANG_IDS[0]
    for seed in range(4):
        audio = window(seed)
        got = port.transcribe_window(audio, [lang], seed=0)[0][0]
        _same(got, unfused(port, audio, lang))
        _same(got, jax_engine.transcribe_window(audio, [lang], seed=0)[0][0])


def test_fused_no_speech_early_exit_parity(monkeypatch):
    """Probe-always-fires gate: prefix-only results on every path."""
    monkeypatch.setattr(engine_mod, "NO_SPEECH_THRESHOLD", 0.0)
    monkeypatch.setattr(jengine_mod, "NO_SPEECH_THRESHOLD", 0.0)
    port, jax_engine = engines()
    lang = TEST_LANG_IDS[2]
    for seed in (0, 1):
        audio = window(seed)
        want = unfused(port, audio, lang)
        got = port.transcribe_window(audio, [lang], seed=0)[0][0]
        jgot = jax_engine.transcribe_window(audio, [lang], seed=0)[0][0]
        assert want.tokens == got.tokens == jgot.tokens == [ST.sot, lang, ST.task]
        assert want.avg_logprob == got.avg_logprob == 0.0
        _same(got, jgot)


def test_fused_all_rungs_fail_parity(monkeypatch):
    """Default gates, greedy-only ladder: a rung-0 rejection is None on
    every path (mtp=12 caps the decode before the tiny timestamp space
    deadlocks, so avg_logprob stays finite and the gate rejects)."""
    monkeypatch.setattr(engine_mod, "TEMPERATURES", (0.0,))
    monkeypatch.setattr(jengine_mod, "TEMPERATURES", (0.0,))
    jcfg = tiny_config(max_target_positions=12)
    port, jax_engine = engines(jcfg, jinit(jcfg, seed=0))
    lang = TEST_LANG_IDS[0]
    nones = 0
    for seed in range(4):
        audio = window(seed, cfg=port.cfg, samples=8000)
        want = unfused(port, audio, lang)
        got = port.transcribe_window(audio, [lang], seed=0)[0][0]
        jgot = jax_engine.transcribe_window(audio, [lang], seed=0)[0][0]
        if want is None:
            assert got is None and jgot is None
            nones += 1
        else:
            _same(got, want)
            _same(got, jgot)
    assert nones >= 1, "no all-rungs-failed case exercised"


def test_fused_detection_matches_detect_language(monkeypatch):
    _accept_all(monkeypatch)
    port, jax_engine = engines()
    for seed in (0, 3):
        audio = window(seed)
        mel = log_mel_spectrogram(torch.from_numpy(audio), n_mels=CFG.num_mel_bins,
                                  n_frames=2 * CFG.max_source_positions)
        probs = port.detect_language(port.encode(mel))
        want_tok = TEST_LANG_IDS[int(np.argmax(probs[0]))]
        res, info = port.transcribe_window(audio, [-1], seed=0)
        assert int(info["langs"][0]) == want_tok
        np.testing.assert_allclose(info["lang_probs"][0], probs[0], atol=1e-5)
        jres, jinfo = jax_engine.transcribe_window(audio, [-1], seed=0)
        assert int(jinfo["langs"][0]) == want_tok
        np.testing.assert_allclose(info["lang_probs"][0], jinfo["lang_probs"][0], atol=1e-5)
        # The detected decode equals a fused decode with the token given.
        res2, _ = port.transcribe_window(audio, [want_tok], seed=0)
        assert res[0].tokens == res2[0].tokens == jres[0].tokens


def test_fused_batched_matches_single(monkeypatch):
    _accept_all(monkeypatch)
    port, jax_engine = engines()
    lang = TEST_LANG_IDS[1]
    audios = [window(s) for s in (10, 11, 12)]
    batch = np.concatenate(audios, axis=0)
    batched, _ = port.transcribe_window(batch, lang, seed=0)
    jbatched, _ = jax_engine.transcribe_window(batch, lang, seed=0)
    for i, a in enumerate(audios):
        _same(batched[i], port.transcribe_window(a, [lang], seed=0)[0][0])
        _same(batched[i], jbatched[i])


def test_fused_mixed_langs_and_detection(monkeypatch):
    """A mixed batch: one detecting stream, two fixed languages."""
    _accept_all(monkeypatch)
    port, jax_engine = engines()
    batch = np.concatenate([window(s) for s in (20, 21, 22)], axis=0)
    langs = [-1, TEST_LANG_IDS[0], TEST_LANG_IDS[2]]
    res, info = port.transcribe_window(batch, langs, seed=0)
    jres, jinfo = jax_engine.transcribe_window(batch, langs, seed=0)
    assert len(res) == 3
    assert int(info["langs"][1]) == TEST_LANG_IDS[0] and int(info["langs"][2]) == TEST_LANG_IDS[2]
    assert int(info["langs"][0]) in TEST_LANG_IDS
    np.testing.assert_array_equal(np.asarray(info["langs"]), np.asarray(jinfo["langs"]))
    for i in range(3):  # each stream's prefix carries its own language
        assert res[i].tokens[1] == int(info["langs"][i])
        _same(res[i], jres[i])


def test_async_dispatch_fetch_matches_sync(monkeypatch):
    """transcribe_window_async + transcribe_window_fetch reproduce the
    synchronous call, with two rounds in flight at once."""
    _accept_all(monkeypatch)
    port, _ = engines()
    a1, a2 = window(1), window(2)
    langs = [TEST_LANG_IDS[0]]
    want1, info1 = port.transcribe_window(a1, langs, seed=0)
    want2, info2 = port.transcribe_window(a2, langs, seed=9)
    p1 = port.transcribe_window_async(a1, langs, seed=0)
    p2 = port.transcribe_window_async(a2, langs, seed=9)
    got2, ginfo2 = port.transcribe_window_fetch(p2)
    got1, ginfo1 = port.transcribe_window_fetch(p1)
    for want, got in ((want1, got1), (want2, got2)):
        assert [r and r.tokens for r in want] == [r and r.tokens for r in got]
    np.testing.assert_array_equal(info1["langs"], ginfo1["langs"])
    np.testing.assert_array_equal(info2["langs"], ginfo2["langs"])
