"""Speculative decoding on tp-sharded params in the port
(norma_tpu_torch.decode.speculative on TPParams, model/whisper.py's
``_decoder_chunk`` rank generator), f32 on the CPU over virtual devices.

  - ``_decoder_chunk`` on each rank's shard at tp=2 and tp=4 (a
    LocalGroup over ``["cpu"] * tp``), for the f32 tied head, the int8
    decoder with the int8 head (ragged at tp=4: V=1002), the int4 head and
    int8 cross-K/V dicts: logits within 1e-5 of tp=1's and of JAX's
    ``decoder_chunk`` on the same caches; each rank's written cache columns
    equal to tp=1's (bit for bit in the first layer, whose input is the
    gathered embedding; within 1e-5 after a reduction);
  - ``SpeculativeEngine`` on dp1 x tp2, dp2 x tp2 and dp1 x tp4: tokens
    equal to the port's tp=1 speculative engine and to JAX's
    SpeculativeEngine on ``norma_tpu.parallel.make_mesh`` of the same
    shape; ``spec_k`` 1, 4 and "auto" (the same K sequence and telemetry
    as tp=1), detect mode, the forced t>0 fallback;
  - the collectives of one round: ``(K+1)(3 L_draft + 2) + 3 L + 2`` with
    the f32 tied heads (the counterpart of test_collectives_per_decode_step);
  - one speculative dp1 x tp2 engine in gloo worker processes: its tokens
    and telemetry the in-process engine's, no async window, and
    ``warmup_fallback`` reaching the workers.

Tolerance: tokens equal; logits 1e-5 (f32, JAX matmul precision
"highest"); avg_logprob and probabilities 1e-4.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from helpers import TEST_LANG_IDS, TEST_ST, confident_params, texty_config, tiny_config
from torch_port_helpers import n, port_cfg, port_params, port_st, t

from norma_tpu.decode.speculative import SpeculativeEngine as JaxSpec
from norma_tpu.model import fuse_qkv as jax_fuse_qkv
from norma_tpu.model import init_params as jax_init
from norma_tpu.model.quant import quantize_decoder as jax_quantize_decoder
from norma_tpu.model.quant import quantize_logits_head_int4 as jax_quantize_head4
from norma_tpu.model.whisper import decoder_chunk as jax_chunk
from norma_tpu.parallel import make_mesh as jax_make_mesh
from norma_tpu.parallel import shard_batch as jax_shard_batch
from norma_tpu.parallel import shard_params as jax_shard_params
import norma_tpu_torch.decode.engine as engine_mod
import norma_tpu_torch.decode.speculative as spec_mod
from norma_tpu_torch.decode import SpeculativeEngine
from norma_tpu_torch.errors import NormaError
from norma_tpu_torch.frontend.mel import prepare_audio
from norma_tpu_torch.model import whisper as pw
from norma_tpu_torch.model.whisper import cross_kv, decoder_chunk, decoder_prefill, quantize_cross_kv
from norma_tpu_torch.parallel import make_mesh, shard_params
from norma_tpu_torch.parallel.collectives import LocalGroup, Rank, TPParams, lockstep

TC = dict(d_model=64, encoder_attention_heads=4, decoder_attention_heads=4)
ST = port_st(TEST_ST)
LANG = TEST_LANG_IDS[0]
LANGS2 = [LANG, TEST_LANG_IDS[1]]


def _cpu_mesh(dp, tp):
    return make_mesh(dp=dp, tp=tp, devices=["cpu"] * (dp * tp))


def _tokens(results):
    return [None if r is None else r.tokens for r in results]


def _cmp(a, b, tol=1e-4):
    assert (a is None) == (b is None)
    if a is None:
        return
    assert a.tokens == b.tokens
    assert a.avg_logprob == pytest.approx(b.avg_logprob, abs=tol, nan_ok=True)
    assert a.no_speech_prob == pytest.approx(b.no_speech_prob, abs=tol)


# ---- _decoder_chunk on the ranks' shards -----------------------------------


def _chunk_tree(quant):
    jcfg = tiny_config(**TC, vocab_size=1002)  # 1002 over tp=4: the int8 head's ragged vocab
    jp = jax_init(jcfg, seed=6)
    if quant == "int8 decoder + head":
        jp = jax_quantize_decoder(jax_fuse_qkv(jp))
    elif quant == "int4 head":
        jp = jax_quantize_head4(jp)
    return jcfg, jp


def _cols(x, r, d):
    """Rank r's D / tp columns of a tensor or an int8 {"q", "s"} dict."""
    if isinstance(x, dict):
        return {k: v[..., r * d:(r + 1) * d].contiguous() for k, v in x.items()}
    return x[..., r * d:(r + 1) * d].contiguous()


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("quant", ["f32 head", "int8 decoder + head", "int4 head", "int8 cross-K/V"])
def test_decoder_chunk_on_rank_shards(tp, quant):
    jcfg, jp = _chunk_tree(quant)
    cfg, params = port_cfg(jcfg), port_params(jp)
    mtp, D, slack = cfg.max_target_positions, cfg.d_model, 3
    rng = np.random.default_rng(6)
    feats = t(rng.standard_normal((2, 16, D)).astype(np.float32))
    xk, xv = cross_kv(params, cfg, feats)
    _, ck, cv = decoder_prefill(params, cfg, t(np.array([[901, 902], [901, 903]], np.int32)), xk, xv)
    ck, cv = F.pad(ck, (0, 0, 0, slack)), F.pad(cv, (0, 0, 0, slack))  # the speculative loop's slack rows
    if quant == "int8 cross-K/V":
        xk, xv = quantize_cross_kv(xk, xv)
    toks = t(np.array([[905, 10, 20], [905, 11, 21]], np.int32))
    pos = torch.tensor([2, mtp - 1])  # row 1 past the embedding's clamp, its writes in the slack
    want, wk, wv = decoder_chunk(params, cfg, toks, pos, ck.clone(), cv.clone(), xk, xv)

    shards = shard_params(params, _cpu_mesh(1, tp)).ranks(0)
    if quant == "int8 decoder + head":
        sizes = [s["decoder"]["tok_emb_q8"]["q"].shape[1] for s in shards]
        assert sizes == ([501, 501] if tp == 2 else [251, 251, 251, 249])
    d = D // tp
    group = LocalGroup(["cpu"] * tp)
    gens = [pw._decoder_chunk(shards[r], cfg, toks, pos, _cols(ck, r, d), _cols(cv, r, d), _cols(xk, r, d),
                              _cols(xv, r, d), tp=Rank(r, tp)) for r in range(tp)]
    outs = lockstep(group, gens)
    heads = 0 if quant == "int4 head" else 1  # the int4 head is replicated: its ranks never meet
    assert group.collectives == 1 + 3 * cfg.decoder_layers + heads
    for r, (lg, k_r, v_r) in enumerate(outs):
        assert lg.shape == (2, 3, 1002)
        np.testing.assert_allclose(n(lg), n(want), rtol=0, atol=1e-5)
        for got, ref in ((k_r, wk), (v_r, wv)):
            ref = _cols(ref, r, d)
            assert torch.equal(got[0], ref[0])  # layer 0: no reduction before it
            np.testing.assert_allclose(n(got), n(ref), rtol=0, atol=1e-5)

    jx = (lambda x: {k: jnp.asarray(n(v)) for k, v in x.items()}) if isinstance(xk, dict) else (
        lambda x: jnp.asarray(n(x)))
    jl, _, _ = jax_chunk(jp, jcfg, jnp.asarray(n(toks).astype(np.int32)), jnp.asarray([2, mtp - 1], jnp.int32),
                         jnp.asarray(n(ck)), jnp.asarray(n(cv)), jx(xk), jx(xv))
    np.testing.assert_allclose(n(outs[0][0]), n(jl), rtol=0, atol=1e-5)


# ---- SpeculativeEngine on tp -------------------------------------------------


@pytest.fixture(scope="module")
def peaked():
    """Peaked target weights (every row accepted at rung 0, EOT suppressed
    so rows run to the length limit) and a random one-layer draft, in both
    packages."""
    jcfg = texty_config(**TC)
    jdcfg = texty_config(**TC, decoder_layers=1, encoder_layers=1)
    jp, jd = confident_params(jcfg, seed=3), jax_init(jdcfg, seed=103)
    return jcfg, jdcfg, jp, jd, port_cfg(jcfg), port_cfg(jdcfg), port_params(jp), port_params(jd)


def _window(seed: int, cfg) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return prepare_audio((0.1 * rng.standard_normal(12_000)).astype(np.float32),
                         n_frames=2 * cfg.max_source_positions)[None]


def _audio(cfg, i=0):
    return np.concatenate([_window(300 + i, cfg), _window(400 + i, cfg)])


def _spec(params, cfg, dparams, dcfg, **kw):
    return SpeculativeEngine(params, cfg, dparams, dcfg, ST, language_token_ids=TEST_LANG_IDS, **kw)


@pytest.mark.parametrize("dp,tp", [(1, 2), (2, 2), (1, 4)])
def test_spec_tp_tokens_equal_tp1_and_jax(peaked, dp, tp):
    jcfg, jdcfg, jp, jd, cfg, dcfg, params, dparams = peaked
    audio = _audio(cfg)
    one = _spec(params, cfg, dparams, dcfg, spec_k=4)
    want, _ = one.transcribe_window(audio, LANGS2, seed=0)
    mesh = _cpu_mesh(dp, tp)
    eng = _spec(shard_params(params, mesh), cfg, shard_params(dparams, mesh), dcfg, spec_k=4)
    try:
        assert len(eng.replicas) == dp and all(r.engine._group.size == tp for r in eng.replicas)
        assert all(r.engine._drp[0]["decoder"]["tok_emb"].shape[1] == cfg.d_model // tp for r in eng.replicas)
        got, _ = eng.transcribe_window(audio, LANGS2, seed=0)
        telemetry = (eng.last_spec_rounds, eng.last_tokens_per_round, eng.last_spec_k)
    finally:
        eng.close()
    jmesh = jax_make_mesh(dp=dp, tp=tp)
    jspec = JaxSpec(jax_shard_params(jp, jmesh), jcfg, jax_shard_params(jd, jmesh), jdcfg, TEST_ST,
                    language_token_ids=TEST_LANG_IDS, spec_k=4)
    jout, _ = jspec.transcribe_window(jax_shard_batch(audio, jmesh), LANGS2, seed=0)
    assert all(r is not None and len(r.tokens) > 3 for r in want)
    for a, b, c in zip(got, want, jout):
        _cmp(a, b)
        _cmp(a, c)
    if dp == 1:  # a dp engine's telemetry is its first replica's, over its own rows
        assert telemetry[0] == one.last_spec_rounds == jspec.last_spec_rounds
        assert telemetry[1] == pytest.approx(one.last_tokens_per_round)
        assert telemetry[1] == pytest.approx(jspec.last_tokens_per_round)
        assert telemetry[2] == one.last_spec_k == 4


@pytest.mark.parametrize("spec_k", [1, 4, "auto"])
def test_spec_tp_k_and_telemetry_as_tp1(peaked, spec_k):
    """tp=2 in one process, window after window (three for "auto", which
    walks K between them): tokens, the K used, rounds and tokens per round
    as at tp=1."""
    _, _, _, _, cfg, dcfg, params, dparams = peaked
    one = _spec(params, cfg, dparams, dcfg, spec_k=spec_k)
    mesh = _cpu_mesh(1, 2)
    eng = _spec(shard_params(params, mesh), cfg, shard_params(dparams, mesh), dcfg, spec_k=spec_k)
    try:
        for i in range(3 if spec_k == "auto" else 1):
            audio = _audio(cfg, i)
            want, _ = one.transcribe_window(audio, LANGS2, seed=0)
            got, _ = eng.transcribe_window(audio, LANGS2, seed=0)
            for a, b in zip(got, want):
                _cmp(a, b)
            assert (eng.last_spec_k, eng.spec_k, eng.last_spec_rounds) == (one.last_spec_k, one.spec_k,
                                                                           one.last_spec_rounds)
            assert eng.last_tokens_per_round == pytest.approx(one.last_tokens_per_round)
    finally:
        eng.close()


def test_spec_tp_detect_mode(peaked):
    _, _, _, _, cfg, dcfg, params, dparams = peaked
    audio = _audio(cfg, 5)
    langs = [-1, LANG]
    want, info_w = _spec(params, cfg, dparams, dcfg).transcribe_window(audio, langs, seed=2)
    mesh = _cpu_mesh(1, 2)
    eng = _spec(shard_params(params, mesh), cfg, shard_params(dparams, mesh), dcfg)
    try:
        got, info_g = eng.transcribe_window(audio, langs, seed=2)
    finally:
        eng.close()
    np.testing.assert_array_equal(info_g["langs"], info_w["langs"])
    np.testing.assert_allclose(info_g["lang_probs"], info_w["lang_probs"], rtol=0, atol=1e-5)
    for a, b in zip(got, want):
        _cmp(a, b)


def test_spec_tp_forced_fallback(monkeypatch):
    """The speculative gate forced to fail (and the fallback's own gate to
    accept its first rung, t=0.2): every live row takes the t>0 fallback
    over each rank's features, and its sampled tokens equal tp=1's."""
    monkeypatch.setattr(spec_mod, "LOGPROB_THRESHOLD", float("inf"))
    monkeypatch.setattr(engine_mod, "LOGPROB_THRESHOLD", float("-inf"))
    jdcfg = tiny_config(**TC, decoder_layers=1, encoder_layers=1)
    cfg, dcfg = port_cfg(tiny_config(**TC)), port_cfg(jdcfg)
    params, dparams = port_params(jax_init(tiny_config(**TC), seed=3)), port_params(jax_init(jdcfg, seed=103))
    sr = 16_000
    sine = (0.1 * np.sin(2 * np.pi * 440 * np.arange(2 * sr) / sr)).astype(np.float32)
    audio = np.stack([prepare_audio(sine, n_frames=2 * cfg.max_source_positions), _window(7, cfg)[0]])
    want, _ = _spec(params, cfg, dparams, dcfg).transcribe_window(audio, [LANG] * 2, seed=7)
    mesh = _cpu_mesh(1, 2)
    eng = _spec(shard_params(params, mesh), cfg, shard_params(dparams, mesh), dcfg)
    calls = []
    e = eng.replicas[0].engine
    inner = e._fallback_rungs
    e._fallback_rungs = lambda feats, *a: (calls.append(len(feats)), inner(feats, *a))[1]
    try:
        got, _ = eng.transcribe_window(audio, [LANG] * 2, seed=7)
    finally:
        eng.close()
    assert calls == [2], "the fallback did not run on each rank's features"
    assert want[0] is not None and len(want[0].tokens) > 3  # the sine row, settled at t=0.2
    for a, b in zip(got, want):
        _cmp(a, b)


def test_collectives_per_round():
    """One round at tp=2 meets the ranks (K+1)(3 L_draft + 2) times in the
    draft's one-token steps and 3 L + 2 in the verify chunk: o, xo and fc2
    of each layer, the embedding's gather and the tied head's sum."""
    cfg = port_cfg(tiny_config(**TC))
    dcfg = port_cfg(tiny_config(**TC, decoder_layers=1, encoder_layers=1))
    ranks = lambda p: shard_params(p, _cpu_mesh(1, 2)).ranks(0)  # noqa: E731
    group = LocalGroup(["cpu"] * 2)
    from norma_tpu_torch.model import init_params

    eng = SpeculativeEngine(TPParams(ranks(init_params(cfg, seed=1)), [0, 1], group), cfg,
                            TPParams(ranks(init_params(dcfg, seed=2)), [0, 1], group), dcfg, ST,
                            language_token_ids=TEST_LANG_IDS, spec_k=3)
    per_round = []
    inner = eng._spec_round

    def counted(buf, K, n0):
        c0 = group.collectives
        inner(buf, K, n0)
        per_round.append(group.collectives - c0)

    eng._spec_round = counted
    eng.transcribe_window(_audio(cfg, 9), [LANG] * 2, seed=0)
    K, L, Ld = 3, cfg.decoder_layers, dcfg.decoder_layers
    assert per_round and set(per_round) == {(K + 1) * (3 * Ld + 2) + 3 * L + 2}


def test_draft_on_another_group_raises():
    cfg = port_cfg(tiny_config(**TC))
    from norma_tpu_torch.model import init_params

    p = init_params(cfg, seed=0)
    ranks = shard_params(p, _cpu_mesh(1, 2)).ranks(0)
    target = TPParams(ranks, [0, 1], LocalGroup(["cpu"] * 2))
    for draft in (TPParams(ranks, [0, 1], LocalGroup(["cpu"] * 2)), p):
        with pytest.raises(NormaError, match="same group"):
            SpeculativeEngine(target, cfg, draft, cfg, ST, language_token_ids=TEST_LANG_IDS)
    with pytest.raises(NormaError, match="same group"):
        SpeculativeEngine(p, cfg, target, cfg, ST, language_token_ids=TEST_LANG_IDS)


def test_spec_tp2_in_worker_processes(peaked):
    """One speculative dp1 x tp2 engine in gloo worker processes (one
    spawn): each rank gets its own draft shard over the target's group; the
    tokens and telemetry are the in-process tp=2 engine's; the engine
    serves synchronous windows (the speculative window, never the inherited
    plain async one); ``warmup_fallback`` runs in the workers."""
    from test_torch_collectives import WorkerPositions

    _, _, _, _, cfg, dcfg, params, dparams = peaked
    mesh = _cpu_mesh(1, 2)
    sp, sd = shard_params(params, mesh), shard_params(dparams, mesh)
    audio = _audio(cfg, 2)
    local = _spec(sp, cfg, sd, dcfg, spec_k="auto")
    try:
        want, _ = local.transcribe_window(audio, LANGS2, seed=0)
        tel_want = (local.last_spec_rounds, local.last_tokens_per_round, local.last_spec_k, local.spec_k)
    finally:
        local.close()
    remote = WorkerPositions(SpeculativeEngine, sp, cfg, sd, dcfg, ST, language_token_ids=TEST_LANG_IDS,
                             spec_k="auto")
    try:
        w = remote.replicas[0].engine
        assert remote.replicas[0].remote and w.supports_async_window is False
        assert remote.supports_async_window is False
        got, _ = remote.transcribe_window(audio, LANGS2, seed=0)
        assert _tokens(got) == _tokens(want)
        tel = (remote.last_spec_rounds, remote.last_tokens_per_round, remote.last_spec_k, remote.spec_k)
        assert tel[0] == tel_want[0] and tel[2:] == tel_want[2:]
        assert math.isclose(tel[1], tel_want[1], rel_tol=1e-9)
        steps = remote.decode_steps
        assert hasattr(w, "warmup_fallback")
        remote.warmup_fallback(batch=2)  # the t>0 rungs' token loops run in the workers
        assert remote.decode_steps > steps
        assert remote.graph_captures == 0
    finally:
        remote.close()
