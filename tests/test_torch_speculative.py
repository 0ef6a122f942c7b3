"""The port's speculative decoding (norma_tpu_torch.decode.speculative) and
its verify pass (model/whisper.py::decoder_chunk), against the JAX package
and against the port's own plain engine, f32 on the CPU.

The twins of tests/test_speculative.py, plus:
  - ``decoder_chunk`` logits within 1e-5 of the JAX package's
    ``decoder_chunk`` on the same weights and caches;
  - the spec window's tokens equal to the JAX SpeculativeEngine's and to the
    plain greedy ladder at K = 1, 4, 12 and "auto";
  - the device-tested round loop equal to its round-by-round eager twin,
    which makes one host read per round;
  - the sampling kernel's plan at the verify chunk's row counts.

Tolerances: logits 1e-5 (f32, matmul precision "highest" in JAX); the
avg_logprob of equal token sequences 1e-4 (sums of per-token logs over
different reduction orders).  Rung>0 draws come from another generator in
each package, so results compare across packages only where rung 0
(greedy) was accepted; within the port they compare result for result.
"""

import math
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import TEST_LANG_IDS, TEST_ST, ToyTokenizer, confident_params, texty_config, tiny_config
from torch_port_helpers import n, port_cfg, port_params, port_st, t

from norma_tpu.decode.speculative import SpeculativeEngine as JaxSpec
from norma_tpu.model import init_params as jax_init
from norma_tpu.model.whisper import cross_kv as jax_cross_kv
from norma_tpu.model.whisper import decoder_chunk as jax_chunk
from norma_tpu.model.whisper import decoder_prefill as jax_prefill
from norma_tpu_torch.audio.sources import SyntheticSource
from norma_tpu_torch.constants import LOGPROB_THRESHOLD, NO_SPEECH_THRESHOLD
from norma_tpu_torch.decode import DecodeEngine, LanguageState, SpeculativeEngine
from norma_tpu_torch.frontend.mel import prepare_audio
from norma_tpu_torch.input import Settings
from norma_tpu_torch.model import fuse_qkv, init_params
from norma_tpu_torch.model.quant import quantize_decoder, quantize_encoder
from norma_tpu_torch.model.whisper import (
    cross_kv,
    decoder_chunk,
    decoder_prefill,
    decoder_step,
    quantize_cross_kv,
)
from norma_tpu_torch.models.whisper.model import WhisperModel
from norma_tpu_torch.ops.sample_step import sample_step, sample_step_plan, sample_step_torch
from norma_tpu_torch.runtime.batching import BatchedTranscriber

CFG = port_cfg(tiny_config())
DCFG = port_cfg(tiny_config(decoder_layers=1, encoder_layers=1))
ST = port_st(TEST_ST)
LANG = TEST_LANG_IDS[0]


def _window(seed: int, b: int = 1) -> np.ndarray:
    rng = np.random.default_rng(seed)
    win = prepare_audio((0.1 * rng.standard_normal(12_000)).astype(np.float32), n_frames=2 * CFG.max_source_positions)
    return np.stack([win] * b)


def _engines(seed: int, cfg=CFG, **spec_kw):
    params = init_params(cfg, seed=seed)
    dparams = init_params(DCFG, seed=seed + 100)
    plain = DecodeEngine(params, cfg, ST, language_token_ids=TEST_LANG_IDS,
                         quantize_cross_kv=spec_kw.get("quantize_cross_kv", False))
    spec = SpeculativeEngine(params, cfg, dparams, DCFG, ST, language_token_ids=TEST_LANG_IDS, **spec_kw)
    return plain, spec


def _cmp(a, b, tol=1e-4):
    assert (a is None) == (b is None)
    if a is None:
        return
    assert a.tokens == b.tokens
    assert a.avg_logprob == pytest.approx(b.avg_logprob, abs=tol, nan_ok=True)
    assert a.no_speech_prob == pytest.approx(b.no_speech_prob, abs=tol)


def _rung0(r) -> bool:
    return r is not None and (math.isnan(r.avg_logprob) or r.avg_logprob >= LOGPROB_THRESHOLD)


# ---- decoder_chunk ---------------------------------------------------------


def _chunk_setup(seed, prefix):
    jp = jax_init(tiny_config(), seed=seed)
    params = port_params(jp)
    rng = np.random.default_rng(seed + 8)
    feats = rng.standard_normal((2, 16, CFG.d_model)).astype(np.float32)
    xk, xv = cross_kv(params, CFG, t(feats))
    _, ck, cv = decoder_prefill(params, CFG, t(prefix), xk, xv)
    return jp, params, feats, xk, xv, ck, cv


def test_decoder_chunk_matches_sequential_steps():
    """A C-token chunk == C sequential decoder_step forwards (logits and
    cache rows, 2e-5), and its logits are within 1e-5 of JAX's chunk."""
    prefix = np.array([[901, 902], [901, 903]], np.int32)
    jp, params, feats, xk, xv, ck0, cv0 = _chunk_setup(3, prefix)
    toks = np.array([[905, 10, 20], [905, 11, 21]], np.int32)
    ck, cv = ck0.clone(), cv0.clone()
    seq = [decoder_step(params, CFG, t(toks[:, j]), 2 + j, ck, cv, xk, xv)[0] for j in range(3)]
    seq = torch.stack(seq, 1)
    jxk, jxv = jax_cross_kv(jp, tiny_config(), jnp.asarray(feats))
    _, jck, jcv = jax_prefill(jp, tiny_config(), jnp.asarray(prefix), jxk, jxv)
    for C in (1, 2, 3):
        ckc, cvc = ck0.clone(), cv0.clone()
        lg, ckc, cvc = decoder_chunk(params, CFG, t(toks[:, :C]), torch.full((2,), 2), ckc, cvc, xk, xv)
        np.testing.assert_allclose(n(lg), n(seq[:, :C]), rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(n(ckc[:, :, 2:2 + C]), n(ck[:, :, 2:2 + C]), rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(n(cvc[:, :, 2:2 + C]), n(cv[:, :, 2:2 + C]), rtol=2e-5, atol=2e-5)
        jl, _, _ = jax_chunk(jp, tiny_config(), jnp.asarray(toks[:, :C]), jnp.full((2,), 2, jnp.int32),
                             jck, jcv, jxk, jxv)
        np.testing.assert_allclose(n(lg), n(jl), rtol=0, atol=1e-5)


def test_decoder_chunk_per_row_positions():
    """Rows of one chunk at different depths: row 0 at positions 3, 4; row 1
    (advanced one plain step first) at 4, 5; against per-row sequential
    steps (2e-5) and JAX's chunk on the same caches (1e-5)."""
    prefix = np.array([[901, 902, 905], [901, 903, 905]], np.int32)
    jp, params, feats, xk, xv, ck0, cv0 = _chunk_setup(4, prefix)
    cka, cva = ck0.clone(), cv0.clone()
    decoder_step(params, CFG, torch.tensor([30, 31]), 3, cka, cva, xk, xv)
    toks = np.array([[10, 20], [40, 41]], np.int32)
    ref = []
    for b, (bk, bv, p) in enumerate([(ck0, cv0, 3), (cka, cva, 4)]):
        ck, cv = bk.clone(), bv.clone()
        ref.append(torch.stack([decoder_step(params, CFG, t(toks[:, j]), p + j, ck, cv, xk, xv)[0][b]
                                for j in range(2)]))
    base_k, base_v = ck0.clone(), cv0.clone()
    base_k[:, 1], base_v[:, 1] = cka[:, 1], cva[:, 1]
    jk, jv = jnp.asarray(n(base_k)), jnp.asarray(n(base_v))
    lg, _, _ = decoder_chunk(params, CFG, t(toks), torch.tensor([3, 4]), base_k, base_v, xk, xv)
    np.testing.assert_allclose(n(lg), n(torch.stack(ref)), rtol=2e-5, atol=2e-5)
    jxk, jxv = jax_cross_kv(jp, tiny_config(), jnp.asarray(feats))
    jl, _, _ = jax_chunk(jp, tiny_config(), jnp.asarray(toks), jnp.asarray([3, 4], jnp.int32), jk, jv, jxk, jxv)
    np.testing.assert_allclose(n(lg), n(jl), rtol=0, atol=1e-5)


def test_decoder_chunk_quantized_matches_jax():
    """int8 decoder layers and head (w8 routes) and int8 cross-K/V dicts
    (the plain cross_q8_attn route) against JAX's chunk, 1e-5; the embedding
    gather clamps past mtp - 1 and the writes land in the slack rows."""
    from norma_tpu.model import fuse_qkv as jfuse
    from norma_tpu.model.quant import quantize_decoder as jqd
    from norma_tpu.model.whisper import quantize_cross_kv as jqx

    jp = jqd(jfuse(jax_init(tiny_config(), seed=6)))
    params = port_params(jp)
    rng = np.random.default_rng(6)
    feats = rng.standard_normal((2, 16, CFG.d_model)).astype(np.float32)
    prefix = np.array([[901, 902], [901, 903]], np.int32)
    xk, xv = cross_kv(params, CFG, t(feats))
    _, ck, cv = decoder_prefill(params, CFG, t(prefix), xk, xv)
    jxk, jxv = jax_cross_kv(jp, tiny_config(), jnp.asarray(feats))
    _, jck, jcv = jax_prefill(jp, tiny_config(), jnp.asarray(prefix), jxk, jxv)
    slack = 3
    pad = lambda c: torch.nn.functional.pad(c, (0, 0, 0, slack))  # noqa: E731
    jpad = lambda c: jnp.pad(c, ((0, 0), (0, 0), (0, slack), (0, 0)))  # noqa: E731
    ck, cv, jck, jcv = pad(ck), pad(cv), jpad(jck), jpad(jcv)
    qk, qv = quantize_cross_kv(xk, xv)
    jqk, jqv = jqx(jxk, jxv)
    mtp = CFG.max_target_positions
    toks = np.array([[905, 10, 20], [905, 11, 21]], np.int32)
    for pos in ([2, 2], [2, mtp - 1]):
        lg, ck, cv = decoder_chunk(params, CFG, t(toks), torch.tensor(pos), ck, cv, qk, qv)
        jl, jck, jcv = jax_chunk(jp, tiny_config(), jnp.asarray(toks), jnp.asarray(pos, jnp.int32),
                                 jck, jcv, jqk, jqv)
        np.testing.assert_allclose(n(lg), n(jl), rtol=0, atol=1e-5)
        np.testing.assert_allclose(n(ck), n(jck), rtol=0, atol=1e-5)


def test_decoder_chunk_refuses_int8_self_kv_and_kernel_layout():
    from norma_tpu_torch.model.whisper import quantize_self_kv_cache
    from norma_tpu_torch.ops.paged_cross import prep_cross_kv_kernel

    params = init_params(CFG, seed=1)
    xk, xv = cross_kv(params, CFG, torch.randn(1, 16, CFG.d_model))
    _, ck, cv = decoder_prefill(params, CFG, torch.tensor([[901, 902]]), xk, xv)
    with pytest.raises(NotImplementedError, match="self-KV"):
        decoder_chunk(params, CFG, torch.tensor([[905]]), torch.tensor([2]),
                      quantize_self_kv_cache(ck), quantize_self_kv_cache(cv), xk, xv)
    kk, kv = prep_cross_kv_kernel(*quantize_cross_kv(xk, xv), CFG.decoder_attention_heads)
    with pytest.raises(ValueError, match="single-query"):
        decoder_chunk(params, CFG, torch.tensor([[905]]), torch.tensor([2]), ck, cv, kk, kv)


# ---- SpeculativeEngine: parity -------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_spec_window_matches_plain_sequential_ladder(seed):
    """B=3 (the plain engine's sequential ladder arm, whose rung seeds the
    speculative fallback reuses): result for result, rungs > 0 included;
    and the rows JAX's SpeculativeEngine accepts at rung 0 are equal to
    JAX's."""
    plain, spec = _engines(seed)
    audio = _window(50 + seed, b=3)
    out_p, info_p = plain.transcribe_window(audio, [LANG] * 3, seed=7)
    out_s, info_s = spec.transcribe_window(audio, [LANG] * 3, seed=7)
    for a, b in zip(out_p, out_s):
        _cmp(a, b)
    np.testing.assert_array_equal(info_p["langs"], info_s["langs"])
    jspec = JaxSpec(jax_init(tiny_config(), seed=seed), tiny_config(),
                    jax_init(tiny_config(decoder_layers=1, encoder_layers=1), seed=seed + 100),
                    tiny_config(decoder_layers=1, encoder_layers=1), TEST_ST, language_token_ids=TEST_LANG_IDS)
    out_j, _ = jspec.transcribe_window(jnp.asarray(audio), [LANG] * 3, seed=7)
    assert [_rung0(r) for r in out_j] == [_rung0(r) for r in out_s]
    for a, b in zip(out_j, out_s):
        if _rung0(a):
            _cmp(a, b)


@pytest.mark.parametrize("spec_k", [1, 4, 12, "auto"])
def test_spec_tokens_equal_jax_and_plain_at_k(spec_k):
    """Peaked weights (every row accepted at rung 0, EOT suppressed so rows
    run into the length limit): the port's speculative tokens equal the JAX
    SpeculativeEngine's and the plain greedy ladder's, window after window
    (three for "auto", which walks K between them)."""
    jcfg = texty_config()
    jdcfg = texty_config(decoder_layers=1, encoder_layers=1)
    jp, jd = confident_params(jcfg, seed=3), jax_init(jdcfg, seed=103)
    cfg, dcfg = port_cfg(jcfg), port_cfg(jdcfg)
    params, dparams = port_params(jp), port_params(jd)
    plain = DecodeEngine(params, cfg, ST, language_token_ids=TEST_LANG_IDS)
    spec = SpeculativeEngine(params, cfg, dparams, dcfg, ST, language_token_ids=TEST_LANG_IDS, spec_k=spec_k)
    jspec = JaxSpec(jp, jcfg, jd, jdcfg, TEST_ST, language_token_ids=TEST_LANG_IDS, spec_k=spec_k)
    for i in range(3 if spec_k == "auto" else 1):
        audio = np.concatenate([_window(300 + i), _window(400 + i)])
        out_p, _ = plain.transcribe_window(audio, [LANG, TEST_LANG_IDS[1]], seed=0)
        out_s, _ = spec.transcribe_window(audio, [LANG, TEST_LANG_IDS[1]], seed=0)
        out_j, _ = jspec.transcribe_window(jnp.asarray(audio), [LANG, TEST_LANG_IDS[1]], seed=0)
        assert all(_rung0(r) for r in out_p)
        for a, b, c in zip(out_p, out_s, out_j):
            _cmp(a, b)
            _cmp(c, b)
        assert spec.last_spec_k == jspec.last_spec_k
        assert spec.last_spec_rounds == jspec.last_spec_rounds
        assert spec.last_tokens_per_round == pytest.approx(jspec.last_tokens_per_round)
        assert spec.spec_k == jspec.spec_k


@pytest.mark.parametrize("spec_k", [1, 4, 12])
def test_spec_selfdraft_accepts_everything(spec_k):
    """draft == target: every proposal is accepted, so each row's rounds are
    the fewest that commit its tokens (K+1 a round but the last, which may
    add the length limit's EOT), and the result equals the plain decode."""
    params = init_params(CFG, seed=5)
    plain = DecodeEngine(params, CFG, ST, language_token_ids=TEST_LANG_IDS)
    spec = SpeculativeEngine(params, CFG, params, CFG, ST, language_token_ids=TEST_LANG_IDS, spec_k=spec_k)
    audio = _window(60, b=2)
    out_p, _ = plain.transcribe_window(audio, [LANG] * 2, seed=0)
    out_s, _ = spec.transcribe_window(audio, [LANG] * 2, seed=0)
    for a, b in zip(out_p, out_s):
        if _rung0(a):
            _cmp(a, b)
    packed, _ = spec._spec_window(torch.from_numpy(audio), torch.tensor([LANG] * 2), torch.ones(2, dtype=torch.bool),
                                  detect=False, k=spec_k)
    Tmax = CFG.max_target_positions
    for row in n(packed):
        committed, r = int(row[Tmax]) - 3, int(row[-1])
        assert r >= 1 and (r - 1) * (spec_k + 1) < committed <= r * (spec_k + 1) + 1


def test_spec_fallback_path_writeback():
    """A sine window whose greedy rung fails the logprob gate takes the t>0
    fallback, whose rows land in the host buffer; B=3 equals the plain
    sequential ladder result for result."""
    params = init_params(CFG, seed=3)
    plain = DecodeEngine(params, CFG, ST, language_token_ids=TEST_LANG_IDS)
    spec = SpeculativeEngine(params, CFG, init_params(DCFG, seed=33), DCFG, ST, language_token_ids=TEST_LANG_IDS)
    calls = []
    inner = spec._fallback_rungs
    spec._fallback_rungs = lambda *a: (calls.append(1), inner(*a))[1]
    sr = 16_000
    sine = (0.1 * np.sin(2 * np.pi * 440 * np.arange(2 * sr) / sr)).astype(np.float32)
    audio = np.stack([prepare_audio(sine, n_frames=2 * CFG.max_source_positions)] * 3)
    out_p, _ = plain.transcribe_window(audio, [LANG] * 3, seed=4)
    out_s, _ = spec.transcribe_window(audio, [LANG] * 3, seed=4)
    assert calls, "the fallback did not run"
    for a, b in zip(out_p, out_s):
        _cmp(a, b)


def test_spec_language_detection():
    plain, spec = _engines(1)
    audio = _window(70)
    _, info_p = plain.transcribe_window(audio, [-1], seed=2)
    _, info_s = spec.transcribe_window(audio, [-1], seed=2)
    np.testing.assert_array_equal(info_p["langs"], info_s["langs"])
    np.testing.assert_allclose(info_p["lang_probs"], info_s["lang_probs"], rtol=1e-4, atol=1e-5)


def test_spec_pad_rows_inert():
    _, spec = _engines(2)
    out, _ = spec.transcribe_window(_window(90, b=2), [LANG] * 2, seed=0, n_active=1)
    assert out[1] is None


def test_spec_constructor_validation():
    params = init_params(CFG, seed=0)
    bad_width = port_cfg(tiny_config(d_model=32, decoder_layers=1))
    with pytest.raises(ValueError, match="d_model"):
        SpeculativeEngine(params, CFG, init_params(bad_width, seed=1), bad_width, ST)
    bad_pos = port_cfg(tiny_config(max_target_positions=32, decoder_layers=1))
    with pytest.raises(ValueError, match="max_target_positions"):
        SpeculativeEngine(params, CFG, init_params(bad_pos, seed=1), bad_pos, ST)
    bad_vocab = port_cfg(tiny_config(vocab_size=1001, decoder_layers=1))
    with pytest.raises(ValueError, match="vocab"):
        SpeculativeEngine(params, CFG, init_params(bad_vocab, seed=1), bad_vocab, ST)
    with pytest.raises(ValueError, match="spec_k"):
        SpeculativeEngine(params, CFG, init_params(DCFG, seed=1), DCFG, ST, spec_k=0)
    with pytest.raises(ValueError, match="single-query"):
        SpeculativeEngine(params, CFG.with_(cross_kv_impl="kernel"), init_params(DCFG, seed=1), DCFG, ST,
                          quantize_cross_kv=True)


def test_spec_quantize_cross_kv_matches_plain():
    """int8 cross-K/V on the loop side: the speculative window equals the
    plain engine's with the same tier (sequential arm, B=3)."""
    plain, spec = _engines(0, quantize_cross_kv=True)
    assert spec.quantize_cross_kv
    audio = _window(95, b=3)
    out_p, _ = plain.transcribe_window(audio, [LANG] * 3, seed=0)
    out_s, _ = spec.transcribe_window(audio, [LANG] * 3, seed=0)
    for a, b in zip(out_p, out_s):
        _cmp(a, b)
    assert out_s[0] is None or out_s[0].tokens[0] == ST.sot


def test_spec_cross_kv_impls_match_einsum():
    """"chunked" runs the plain int8 cross-attention on the port (the same
    function, the softmax sum in another order): the same results as
    "einsum".  "a8" is another function (int8 q and softmax weights); its
    speculative window equals its own reference, the plain engine's window
    under "a8"."""
    params, dparams = init_params(CFG, seed=4), init_params(DCFG, seed=104)
    audio = _window(96)
    outs = {}
    for impl in ("einsum", "chunked", "a8"):
        cfg = CFG.with_(cross_kv_impl=impl, cross_kv_chunk=5)
        spec = SpeculativeEngine(params, cfg, dparams, DCFG.with_(cross_kv_impl=impl, cross_kv_chunk=5), ST,
                                 language_token_ids=TEST_LANG_IDS, quantize_cross_kv=True)
        outs[impl] = spec.transcribe_window(audio, [LANG], seed=0)[0][0]
    _cmp(outs["chunked"], outs["einsum"])
    plain = DecodeEngine(params, CFG.with_(cross_kv_impl="a8"), ST, language_token_ids=TEST_LANG_IDS,
                         quantize_cross_kv=True)
    _cmp(outs["a8"], plain.transcribe_window(audio, [LANG], seed=0)[0][0])


def test_spec_quantized_draft():
    """An int8 draft (w8 routes) only proposes: the result is still the f32
    target's own decode."""
    params = init_params(CFG, seed=0)
    dparams = quantize_decoder(fuse_qkv(init_params(DCFG, seed=100)))
    plain = DecodeEngine(params, CFG, ST, language_token_ids=TEST_LANG_IDS)
    spec = SpeculativeEngine(params, CFG, dparams, DCFG, ST, language_token_ids=TEST_LANG_IDS)
    audio = _window(7, b=3)
    out_p, _ = plain.transcribe_window(audio, [LANG] * 3, seed=0)
    out_s, _ = spec.transcribe_window(audio, [LANG] * 3, seed=0)
    for a, b in zip(out_p, out_s):
        _cmp(a, b)


def test_spec_telemetry_per_row_rounds():
    """Per-row live rounds ride a trailing column: live rows ran >= 1 round,
    pad rows 0, and the telemetry is the mean of per-row ratios."""
    _, spec = _engines(0)
    audio = np.concatenate([_window(200 + i) for i in range(3)])
    langs = torch.tensor([LANG] * 3)
    packed, _ = spec._spec_window(torch.from_numpy(audio), langs, torch.ones(3, dtype=torch.bool), detect=False, k=4)
    packed = n(packed)
    Tmax = CFG.max_target_positions
    bn, nsp, lr = packed[:, Tmax].astype(np.int32), packed[:, Tmax + 3], packed[:, -1].astype(np.int32)
    live = ~(nsp > NO_SPEECH_THRESHOLD)
    assert (lr[live] >= 1).all()
    spec.transcribe_window(audio, [LANG] * 3, seed=0)
    assert spec.last_spec_rounds == int(lr.max())
    live_r = live & (lr > 0)
    assert spec.last_tokens_per_round == pytest.approx(float(((bn[live_r] - 3) / lr[live_r]).mean()))
    packed_p, _ = spec._spec_window(torch.from_numpy(audio), langs, torch.tensor([True, False, False]),
                                    detect=False, k=4)
    packed_p = n(packed_p)
    assert (packed_p[1:, -1] == 0).all() and packed_p[0, -1] >= 1


def test_spec_w8a8_encoder_target_stays_exact():
    params = quantize_encoder(fuse_qkv(init_params(CFG, seed=0)))
    dparams = fuse_qkv(init_params(DCFG, seed=100))
    plain = DecodeEngine(params, CFG, ST, language_token_ids=TEST_LANG_IDS)
    spec = SpeculativeEngine(params, CFG, dparams, DCFG, ST, language_token_ids=TEST_LANG_IDS)
    audio = _window(31, b=3)
    out_p, info_p = plain.transcribe_window(audio, [LANG] * 3, seed=7)
    out_s, info_s = spec.transcribe_window(audio, [LANG] * 3, seed=7)
    for a, b in zip(out_p, out_s):
        _cmp(a, b)
    np.testing.assert_array_equal(info_p["langs"], info_s["langs"])


def test_spec_engine_in_batched_transcriber():
    """A speculative-engine model serves under BatchedTranscriber, with
    synchronous rounds (no pipelining: supports_async_window is False)."""
    _, spec = _engines(3)
    model = WhisperModel(spec, ToyTokenizer(), LanguageState(const=LANG), language_tokens=TEST_LANG_IDS)
    bt = BatchedTranscriber(model, max_streams=4)
    assert bt.pipeline_rounds is False
    handles = [
        bt.blocking_start(Settings(source=SyntheticSource(
            sample_rate=16_000, channels=1, dtype=np.float32, freq=220.0 + 110 * i, noise=0.02,
            duration=1.2, realtime=False, seed=i,
        )))
        for i in range(3)
    ]
    time.sleep(0.5)
    for h in handles:
        h.stop()
    texts = [list(h.receiver) for h in handles]
    bt.close()
    assert all(isinstance(x, str) for ts in texts for x in ts)
    assert spec.last_spec_rounds is not None


@pytest.mark.parametrize("spec_k", [2, 4])
def test_spec_bucketed_matches_unbucketed(spec_k):
    """decode_buckets are ignored by the speculative loop (the fallback
    rungs inherit them): results equal with and without."""
    params, dparams = init_params(CFG, seed=4), init_params(DCFG, seed=104)
    kw = dict(language_token_ids=TEST_LANG_IDS, spec_k=spec_k)
    spec = SpeculativeEngine(params, CFG, dparams, DCFG, ST, **kw)
    spec_b = SpeculativeEngine(params, CFG.with_(decode_buckets=(16, 32)), dparams, DCFG, ST, **kw)
    audio = _window(91, b=2)
    out, _ = spec.transcribe_window(audio, [LANG] * 2, seed=5)
    out_b, _ = spec_b.transcribe_window(audio, [LANG] * 2, seed=5)
    for a, b in zip(out, out_b):
        _cmp(a, b)


# ---- the round loop --------------------------------------------------------


@pytest.mark.parametrize("spec_k", [1, 4])
def test_round_loop_matches_eager_twin(spec_k):
    """The round loop as one device-tested loop (a WHILE node on the card;
    its stop test read uncounted on the CPU) gives the round-by-round eager
    twin's tokens, lengths, logprob sums and rounds bit for bit; the twin
    reads the flags on the host before each round, and once more when a
    row is still live at the round budget's end it does not reach."""
    _, spec = _engines(1, spec_k=spec_k)
    audio = torch.from_numpy(np.concatenate([_window(500), _window(501)]))
    args = (audio, torch.tensor([LANG] * 2), torch.ones(2, dtype=torch.bool))
    outs = {}
    for eager in (False, True):
        h0 = spec.host_syncs
        outs[eager] = (n(spec._spec_window(*args, detect=False, k=spec_k, eager=eager)[0]), spec.host_syncs - h0)
    rounds = int(outs[True][0][:, -1].max())
    budget = CFG.max_target_positions - 4  # mtp - 1 - n0
    np.testing.assert_array_equal(outs[False][0], outs[True][0])
    assert rounds >= 1 and outs[False][1] == 0
    assert outs[True][1] == min(rounds + 1, budget)


@pytest.mark.parametrize("rows", [5, 40, 104])
def test_sample_step_plan_at_verify_rows(rows):
    """The sampling kernel's plan holds at the verify chunk's rows (B x
    (K+1): 5 at B=1 K=4, 40 at B=8 K=4, 104 at B=8 K=12) on V = 51866:
    every id in one slice, B x cluster CTAs within the 132 SMs or one CTA a
    row, the slice in shared memory."""
    V = 51866
    plan = sample_step_plan(rows, V)
    c, sl = plan["cluster"], plan["slice"]
    assert plan["grid"] == (c, rows) and c * sl >= V and (c - 1) * sl < V
    assert rows * c <= 132 or c == 1
    assert plan["smem_bytes"] == 4 * sl <= 229376


def test_greedy_per_row_steps_match_rows_one_by_one():
    """greedy_only with per-row steps (the verify rows sit at different
    depths) equals each row stepped alone."""
    rng = np.random.default_rng(0)
    V, R = CFG.vocab_size, 10
    ll = torch.from_numpy(rng.standard_normal((R, V)).astype(np.float32) * 4)
    e = DecodeEngine(init_params(CFG, seed=0), CFG, ST)
    masks = (e._m_suppress, e._m_non_ts, e._m_ts, e._m_first)
    p1 = torch.from_numpy(rng.integers(0, V, R).astype(np.int32))
    p2 = torch.from_numpy(rng.integers(0, V, R).astype(np.int32))
    lts = torch.from_numpy(np.where(rng.random(R) < 0.5, 0, rng.integers(ST.no_timestamps + 1, V, R)).astype(np.int32))
    step = torch.from_numpy((np.arange(R) % 3).astype(np.int32))
    zero = torch.zeros(R)
    nxt, prob, _ = sample_step(ll, *masks, p1, p2, lts, step, zero, eot=ST.eot, no_timestamps=ST.no_timestamps,
                               greedy_only=True)
    for r in range(R):
        one = sample_step_torch(ll[r:r + 1], *masks, p1[r:r + 1], p2[r:r + 1], lts[r:r + 1], int(step[r]),
                                zero[:1], eot=ST.eot, no_timestamps=ST.no_timestamps, greedy_only=True)
        assert int(one[0]) == int(nxt[r]) and float(one[1]) == float(prob[r])


# ---- spec_k="auto" ----------------------------------------------------------


def test_spec_auto_k_controller_rules():
    _, spec = _engines(0, spec_k="auto")
    assert spec.auto_k and spec.spec_k == 4
    spec.last_tokens_per_round = 5.0  # ratio 1.0 at K=4
    spec._adapt_spec_k()
    assert spec.spec_k == 8 and spec._accept_ema is None
    spec.last_tokens_per_round = 1.0  # 1/9 at K=8
    spec._adapt_spec_k()
    assert spec.spec_k == 4
    spec.last_tokens_per_round = 3.0  # 0.6: hold
    spec._adapt_spec_k()
    assert spec.spec_k == 4
    spec.last_tokens_per_round = None  # silence: hold
    spec._adapt_spec_k()
    assert spec.spec_k == 4
    spec.spec_k, spec._accept_ema = spec._K_CHOICES[-1], None
    spec.last_tokens_per_round = float(spec._K_CHOICES[-1] + 1)
    spec._adapt_spec_k()
    assert spec.spec_k == spec._K_CHOICES[-1]
    spec.spec_k, spec._accept_ema = spec._K_CHOICES[0], None
    spec.last_tokens_per_round = 1.0
    spec._adapt_spec_k()
    assert spec.spec_k == spec._K_CHOICES[0]


def test_spec_auto_k_ema_smoothing():
    _, spec = _engines(0, spec_k="auto")
    spec.spec_k, spec._accept_ema = 8, 0.96
    spec.last_tokens_per_round = 1.8  # ratio 0.2, once
    spec._adapt_spec_k()
    assert spec.spec_k == 8
    spec._adapt_spec_k()
    spec._adapt_spec_k()
    assert spec.spec_k == 4


def test_spec_auto_k_fixed_engine_never_adapts():
    _, spec = _engines(0)
    assert not spec.auto_k
    spec.transcribe_window(_window(60), [LANG], seed=0)
    assert spec.spec_k == 4


def test_spec_auto_k_escalates_and_stays_exact():
    """A self-draft escalates K across windows, and every window still
    equals the plain decode."""
    params = init_params(CFG, seed=5)
    plain = DecodeEngine(params, CFG, ST, language_token_ids=TEST_LANG_IDS)
    spec = SpeculativeEngine(params, CFG, params, CFG, ST, language_token_ids=TEST_LANG_IDS, spec_k="auto")
    seen = set()
    for i in range(3):
        audio = _window(60 + i)
        out_p, _ = plain.transcribe_window(audio, [LANG], seed=0)
        out_s, _ = spec.transcribe_window(audio, [LANG], seed=0)
        seen.add(spec.last_spec_k)
        if _rung0(out_p[0]):
            _cmp(out_p[0], out_s[0])
    assert len(seen) >= 2 and spec.spec_k > 4


def test_warmup_runs_fallback():
    """WhisperModel.warmup also runs the speculative engine's t>0 fallback
    (silence never reaches it)."""
    params = init_params(CFG, seed=5)
    spec = SpeculativeEngine(params, CFG, params, CFG, ST, language_token_ids=TEST_LANG_IDS, spec_k=2)
    spec.warmup_fallback()
    called = []
    orig = spec.warmup_fallback
    spec.warmup_fallback = lambda *a, **k: (called.append(a), orig(*a, **k))[1]
    WhisperModel(spec, ToyTokenizer(), LanguageState(const=LANG)).warmup(batch=2)
    assert called == [(2,)]
