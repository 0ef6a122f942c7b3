"""The port's remaining DecodeEngine entry points against the JAX package
(``detect_language``, ``decode``, ``prefill_window``,
``decode_with_fallback_windowed`` and ``_fallback_from_state``), and the two
hooks the speculative engine uses (``_sequential_rungs(start_rung=)``,
``_unpack_ladder(trailing_cols=, reject_rung0_below_gate=)``), f32 on the
CPU with the same seeded weights in both packages.

Tolerances: probabilities and logits 1e-5; avg_logprob of equal token
sequences 1e-4.  t>0 draws come from another generator in each package,
so decodes compare across packages at t=0 only.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import TEST_LANG_IDS, TEST_ST, confident_params, random_feats, texty_config, tiny_config
from torch_port_helpers import n, port_cfg, port_params, port_st

from norma_tpu.decode.engine import DecodeEngine as JaxEngine
from norma_tpu.decode.engine import DecodingResult as JaxResult
from norma_tpu.model import init_params as jax_init
from norma_tpu_torch.constants import LOGPROB_THRESHOLD, TEMPERATURES
from norma_tpu_torch.decode import DecodeEngine, DecodingResult
from norma_tpu_torch.frontend.mel import prepare_audio

ST = port_st(TEST_ST)


def _pair(seed=0, jcfg=None, jparams=None, **kw):
    jcfg = jcfg or tiny_config()
    jp = jparams if jparams is not None else jax_init(jcfg, seed=seed)
    j = JaxEngine(jp, jcfg, TEST_ST, language_token_ids=TEST_LANG_IDS, **kw)
    p = DecodeEngine(port_params(jp), port_cfg(jcfg), ST, language_token_ids=TEST_LANG_IDS, **kw)
    return j, p


def _audio(seed, cfg, b=1):
    rng = np.random.default_rng(seed)
    win = prepare_audio((0.2 * rng.standard_normal(12_000)).astype(np.float32),
                        n_frames=2 * cfg.max_source_positions)
    return np.stack([win] * b)


def _cmp(a, b, tol=1e-4):
    assert (a is None) == (b is None)
    if a is None:
        return
    assert a.tokens == b.tokens
    assert a.avg_logprob == pytest.approx(b.avg_logprob, abs=tol, nan_ok=True)
    assert a.no_speech_prob == pytest.approx(b.no_speech_prob, abs=tol)


@pytest.mark.parametrize("seed", [0, 1])
def test_detect_language_matches_jax(seed):
    j, p = _pair(seed)
    feats = random_feats(tiny_config(), B=2, T=16, seed=seed + 40)
    want = np.asarray(j.detect_language(jnp.asarray(feats)))
    got = p.detect_language(feats)
    assert got.shape == (2, len(TEST_LANG_IDS))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got.sum(-1), 1.0, atol=1e-5)
    with pytest.raises(ValueError, match="language_token_ids"):
        DecodeEngine(p.params, p.cfg, ST).detect_language(feats)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_decode_matches_jax(seed):
    """decode() at t=0 (and over a reused prefill state) gives JAX's result."""
    j, p = _pair(seed)
    feats = random_feats(tiny_config(), B=1, T=16, seed=seed + 10)
    lang = TEST_LANG_IDS[1]
    want = j.decode(jnp.asarray(feats), lang, 0.0, seed=0)
    _cmp(p.decode(feats, lang, 0.0, seed=0), want)
    state = p.prefill(feats, lang)
    _cmp(p.decode(None, None, 0.0, seed=3, _prefill_state=state), want)


def test_prefill_window_matches_jax():
    """The raw-PCM prefill: same prefix, cross-K/V, caches, next logits and
    no-speech probability as JAX's, and as the port's own prefill of the
    encoded mel."""
    j, p = _pair(2)
    audio = _audio(7, tiny_config(), b=2)
    js = j.prefill_window(jnp.asarray(audio), TEST_LANG_IDS[0])
    ps = p.prefill_window(audio, TEST_LANG_IDS[0])
    np.testing.assert_array_equal(ps["prefix"], js["prefix"])
    assert ps["B"] == js["B"] == 2
    for k in ("xk", "xv", "next_logits"):
        np.testing.assert_allclose(n(ps[k]), n(js[k]), rtol=0, atol=1e-5, err_msg=k)
    for k in ("cache_k", "cache_v"):
        np.testing.assert_allclose(n(ps[k])[:, :, :3], n(js[k])[:, :, :3], rtol=0, atol=1e-5, err_msg=k)
    np.testing.assert_allclose(ps["no_speech_prob"], js["no_speech_prob"], rtol=0, atol=1e-5)
    assert p.run_loop(ps, 0.0, 0)[1].tokens == j.run_loop(js, 0.0, 0)[1].tokens


def test_decode_with_fallback_windowed_matches_jax():
    """Peaked weights (rung 0 accepted): the windowed ladder gives JAX's
    result, and the port's feats-based ladder the same."""
    from norma_tpu_torch.frontend.mel import log_mel_spectrogram

    cfg = texty_config()
    j, p = _pair(jcfg=cfg, jparams=confident_params(cfg, seed=3))
    for s in (1, 2):
        audio = _audio(s, cfg)
        want = j.decode_with_fallback_windowed(jnp.asarray(audio), TEST_LANG_IDS[0], seed=0)
        got = p.decode_with_fallback_windowed(audio, TEST_LANG_IDS[0], seed=0)
        assert not got.avg_logprob < LOGPROB_THRESHOLD  # rung 0 (a NaN average is accepted)
        _cmp(got, want)
        mel = log_mel_spectrogram(torch.from_numpy(audio), n_frames=2 * cfg.max_source_positions)
        _cmp(p.decode_with_fallback(p.encode(mel), TEST_LANG_IDS[0], seed=0), got)


def test_windowed_prefill_bucketed_matches_base():
    """Twin of tests/test_bucketed_decode.py: prefill_window + run_loop with
    decode buckets gives the unbucketed result."""
    cfg = port_cfg(tiny_config())
    _, p = _pair(3)
    b = DecodeEngine(p.params, cfg.with_(decode_buckets=(16, 32)), ST, language_token_ids=TEST_LANG_IDS)
    audio = _audio(7, cfg)
    r1 = p.run_loop(p.prefill_window(audio, TEST_LANG_IDS[0]), 0.0, seed=0)[0]
    r2 = b.run_loop(b.prefill_window(audio, TEST_LANG_IDS[0]), 0.0, seed=0)[0]
    assert r1.tokens == r2.tokens and abs(r1.avg_logprob - r2.avg_logprob) < 1e-6


def test_fallback_from_state_edges_match_jax(monkeypatch):
    """The two host-side exits, the same in both packages: a fired no-speech
    probe returns the prefix-only result; every rung failing the gate
    returns None after trying each temperature at seed + i."""
    j, p = _pair(1)
    for eng in (j, p):
        state = dict(prefix=np.array([[901, 902, 905]], np.int32), no_speech_prob=np.array([0.9]))
        r = eng._fallback_from_state(state, seed=0)
        assert (r.tokens, r.avg_logprob, r.no_speech_prob) == ([901, 902, 905], 0.0, 0.9)
    for eng, cls in ((j, JaxResult), (p, DecodingResult)):
        calls = []
        monkeypatch.setattr(eng, "run_loop", lambda state, t, seed, cls=cls, calls=calls: (
            calls.append((t, seed)), [cls(tokens=[901], avg_logprob=-5.0, no_speech_prob=0.1)])[1])
        state = dict(prefix=np.array([[901, 902, 905]], np.int32), no_speech_prob=np.array([0.1]))
        assert eng._fallback_from_state(state, seed=10) is None
        assert calls == [(t, 10 + i) for i, t in enumerate(TEMPERATURES)]


@pytest.mark.parametrize("trailing", [0, 1])
@pytest.mark.parametrize("reject", [False, True])
def test_unpack_ladder_matches_jax(trailing, reject):
    """The packed layout's host unpack, with a trailing telemetry column and
    the post-fallback rung-0 gate: the same results and info as JAX's."""
    j, p = _pair(0)
    Tmax = tiny_config().max_target_positions
    rng = np.random.default_rng(trailing + 2 * reject)
    B, L = 5, len(TEST_LANG_IDS)
    packed = np.zeros((B, Tmax + 5 + L + trailing), np.float32)
    packed[:, :Tmax] = rng.integers(0, 990, (B, Tmax))
    packed[:, Tmax] = [3, 10, 12, 20, 7]  # n
    packed[:, Tmax + 1] = [-0.2, -1.5, np.nan, -0.3, -2.0]  # avg
    packed[:, Tmax + 2] = [0, 0, 0, 2, -1]  # rung
    packed[:, Tmax + 3] = [0.1, 0.2, 0.3, 0.7, 0.1]  # nsp
    packed[:, Tmax + 4] = TEST_LANG_IDS[0]
    packed[:, Tmax + 5:Tmax + 5 + L] = rng.random((B, L))
    if trailing:
        packed[:, -1] = 99.0
    active = np.array([True, True, True, True, False])
    kw = dict(trailing_cols=trailing, reject_rung0_below_gate=reject)
    out_j, info_j = j._unpack_ladder(packed.copy(), active, True, **kw)
    out_p, info_p = p._unpack_ladder(packed.copy(), active, True, **kw)
    for a, b in zip(out_p, out_j):
        if a is None or b is None:
            assert a is b is None
        else:
            assert a.tokens == b.tokens and a.no_speech_prob == pytest.approx(b.no_speech_prob)
            assert a.avg_logprob == pytest.approx(b.avg_logprob, nan_ok=True)
    assert (out_p[1] is None) == reject and out_p[4] is None
    np.testing.assert_array_equal(info_p["langs"], info_j["langs"])
    np.testing.assert_array_equal(info_p["lang_probs"], np.asarray(info_j["lang_probs"]))
    assert info_p["lang_probs"].shape == (B, L)


def test_sequential_rungs_start_rung():
    """start_rung=1 skips the greedy rung: rows settle at rung >= 1 or not
    at all, one host read per rung tried; settled rows stay as given."""
    _, p = _pair(3)
    state = p.prefill(random_feats(tiny_config(), B=3, T=16, seed=5), TEST_LANG_IDS[0])
    B, Tmax = 3, p.cfg.max_target_positions
    tokens_init = torch.zeros((B, Tmax), dtype=torch.int32)
    prefix = torch.from_numpy(state["prefix"])
    tokens_init[:, :3] = prefix
    settled = torch.tensor([False, True, False])
    temps = []
    inner = p._token_loop
    p._token_loop = lambda *a, **k: (temps.append(float(a[9][0])), inner(*a, **k))[1]
    btoks, bn, bavg, brung = p._sequential_rungs(
        state["xk"], state["xv"], state["cache_k"], state["cache_v"], state["next_logits"],
        tokens_init, prefix, 11, settled, start_rung=1,
    )
    brung = brung.numpy()
    assert brung[1] == -1 and int(bn[1]) == 3
    assert all(r == -1 or r >= 1 for r in brung)
    assert temps and temps == pytest.approx(TEMPERATURES[1:1 + len(temps)])
    for b in (0, 2):
        if brung[b] >= 1:
            assert not float(bavg[b]) < LOGPROB_THRESHOLD
