"""The port's fully-int8 cross-attention (``cross_kv_impl="a8"``,
model/whisper.py::attention_cross_q8_a8) against the JAX package's, f32 on
the CPU.

  - the function itself at the tiny width (D 64, 2 heads, Ta 32) and at
    distil-large-v3's cross-attention (D 1280, 20 heads, Ta 1500, B 2), at
    G in {1, 6} ladder rungs and Tq in {1, 5} query rows;
  - the exact int8 products (``int8_products``) past the 2**24 bound of one
    f32 sum;
  - ``decoder_step`` and ``decoder_chunk`` logits under "a8";
  - greedy tokens of a plain and of a speculative window equal to JAX's;
  - tp=2 on a LocalGroup CPU mesh: the row scale of q over both ranks'
    columns (logits and tokens equal tp=1's), and the one extra collective
    a layer that this costs per decode step and per speculative round;
    tp=2 in gloo worker processes (the cards' NCCL path) equal to the
    LocalGroup engine.

Tolerance of the function: every element within 1e-5 of the output's max,
except where a weight code flips at a rounding tie (the two softmaxes differ
in the last bits, and w / sw may straddle a half): there the gap is within
one code step of that row (``a8_code_step``: sw * max|v codes| * vq.s), and
at most two head rows of a case may use it.  Logits 1e-4; tokens equal (JAX matmul
precision "highest").
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import TEST_LANG_IDS, TEST_ST, confident_params, random_feats, texty_config, tiny_config
from torch_port_helpers import n, port_cfg, port_params, port_st, t

from norma_tpu.decode import DecodeEngine as JaxEngine
from norma_tpu.decode.speculative import SpeculativeEngine as JaxSpec
from norma_tpu.model import init_params as jax_init
from norma_tpu.model import whisper as jw
from norma_tpu_torch.decode import DecodeEngine, SpeculativeEngine
from norma_tpu_torch.frontend.mel import prepare_audio
from norma_tpu_torch.model import whisper as pw
from norma_tpu_torch.parallel import make_mesh, shard_params
from norma_tpu_torch.parallel.collectives import LocalGroup, TPParams, first
from norma_tpu_torch.parallel.workers import WorkerEngine

ST = port_st(TEST_ST)
LANG = TEST_LANG_IDS[0]
A8 = dict(cross_kv_impl="a8")
REL = 1e-5


def _xkv(B, Ta, D, seed):
    """int8 cross-K/V of one layer, from JAX's quantizer, for both sides."""
    rng = np.random.default_rng(seed)
    xk, xv = (jnp.asarray(rng.standard_normal((1, B, Ta, D)), jnp.float32) for _ in range(2))
    jk, jv = ({k: v[0] for k, v in d.items()} for d in jw.quantize_cross_kv(xk, xv))
    return (jk, jv), tuple({k: t(v) for k, v in d.items()} for d in (jk, jv))


def _assert_a8_close(got, want, step, dh):
    """Within REL of the output's max, or one code step where a code flipped
    (at most two head rows)."""
    tol = REL * np.abs(want).max()
    gap = np.abs(got - want)
    np.testing.assert_array_less(gap, tol + 1.01 * step)
    rows = (gap > tol).reshape(*gap.shape[:-1], -1, dh).any(-1)
    assert rows.sum() <= 2, f"{rows.sum()} head rows past {REL} of the max"


SHAPES = {"tiny": (1, 64, 2, 32), "distil-large-v3": (2, 1280, 20, 1500)}


@pytest.mark.parametrize("tq", [1, 5])
@pytest.mark.parametrize("G", [1, 6])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_a8_matches_jax(shape, G, tq):
    B, D, H, Ta = SHAPES[shape]
    (jk, jv), (pk, pv) = _xkv(B, Ta, D, seed=G + tq)
    q = np.random.default_rng(7 * G + tq).standard_normal((G * B, tq, D)).astype(np.float32)
    want = np.asarray(jw.attention_cross_q8_a8(jnp.asarray(q), jk, jv, H, G))
    got = pw.attention_cross_q8_a8(t(q), pk, pv, H, G)
    assert got.dtype == torch.float32 and tuple(got.shape) == (G * B, tq, D)
    _assert_a8_close(n(got), want, n(pw.a8_code_step(t(q), pk, pv, H, G)), D // H)
    # The "a8" dispatch is this function, not the plain einsum form, which
    # is a whole tier away from it.
    cfg = port_cfg(tiny_config()).with_(**A8)
    assert torch.equal(pw.cross_q8_attn(cfg, t(q), pk, pv, H, G), got)
    plain = n(pw.attention_cross_q8(t(q), pk, pv, H, G))
    assert np.abs(plain - want).max() > 100 * REL * np.abs(want).max()


def test_a8_bf16_query_matches_jax():
    """bf16 activations: q widened to f32 first, the output rounded to bf16."""
    B, D, H, Ta = SHAPES["tiny"]
    (jk, jv), (pk, pv) = _xkv(B, Ta, D, seed=3)
    q = np.random.default_rng(3).standard_normal((2 * B, 1, D)).astype(np.float32)
    want = np.asarray(jw.attention_cross_q8_a8(jnp.asarray(q, jnp.bfloat16), jk, jv, H, 2)).astype(np.float32)
    got = pw.attention_cross_q8_a8(t(q, torch.bfloat16), pk, pv, H, 2)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(n(got), want, rtol=2**-7, atol=REL)


@pytest.mark.parametrize("K", [64, 1040, 1041, 1500, 3000])
def test_int8_products_exact(K):
    """Codes at +-127 make every partial sum as large as it can be: 1500 such
    products (24.2M) pass 2**24, where one f32 sum would round."""
    rng = np.random.default_rng(K)
    a = rng.integers(-127, 128, (2, 3, 4, K))
    b = rng.integers(-127, 128, (2, 1, K, 5))
    a[..., 0, :] = 127
    b[..., 0] = 127
    want = np.matmul(a.astype(np.int64), b.astype(np.int64))
    got = pw.int8_products(torch.from_numpy(a.astype(np.int8)), torch.from_numpy(b.astype(np.int8)))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    if K >= 1500:
        assert want.max() > 2**24


# ---- the decoder's layers under "a8" ----------------------------------------

CFG = tiny_config()
PCFG = port_cfg(CFG)


@pytest.fixture(scope="module")
def model_params():
    jp = jax_init(CFG, seed=5)
    return jp, port_params(jp)


def _prefilled(jp, pp, B, seed):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, CFG.vocab_size, (B, 3)).astype(np.int32)
    xa = rng.standard_normal((B, CFG.max_source_positions, CFG.d_model)).astype(np.float32)
    jxk, jxv = jw.cross_kv(jp, CFG, jnp.asarray(xa))
    pxk, pxv = pw.cross_kv(pp, PCFG, t(xa))
    _, jck, jcv = jw.decoder_prefill(jp, CFG, jnp.asarray(toks), jxk, jxv)
    _, pck, pcv = pw.decoder_prefill(pp, PCFG, t(toks), pxk, pxv)
    return (jck, jcv, *jw.quantize_cross_kv(jxk, jxv)), (pck, pcv, *pw.quantize_cross_kv(pxk, pxv))


@pytest.mark.parametrize("n_rungs", [1, 3])
def test_decoder_step_a8_matches_jax(model_params, n_rungs):
    jp, pp = model_params
    (jck, jcv, jk, jv), (pck, pcv, pk, pv) = _prefilled(jp, pp, 2, 31 + n_rungs)
    if n_rungs > 1:
        jck, jcv = jnp.tile(jck, (1, n_rungs, 1, 1)), jnp.tile(jcv, (1, n_rungs, 1, 1))
        pck, pcv = pck.repeat(1, n_rungs, 1, 1), pcv.repeat(1, n_rungs, 1, 1)
    tok = np.arange(5, 5 + 2 * n_rungs, dtype=np.int32)
    for pos in (3, 4):
        jl, jck, jcv = jw.decoder_step(jp, CFG.with_(**A8), jnp.asarray(tok), jnp.int32(pos), jck, jcv, jk, jv,
                                       n_rungs=n_rungs)
        pl, pck, pcv = pw.decoder_step(pp, PCFG.with_(**A8), t(tok), pos, pck, pcv, pk, pv, n_rungs=n_rungs)
        np.testing.assert_allclose(n(pl), np.asarray(jl), rtol=1e-4, atol=1e-4)
        # The plain form's logits are another function's.
        el, _, _ = jw.decoder_step(jp, CFG, jnp.asarray(tok), jnp.int32(pos), jck, jcv, jk, jv, n_rungs=n_rungs)
        assert np.abs(n(pl) - np.asarray(el)).max() > 1e-3
        tok = tok[::-1].copy()


def test_decoder_chunk_a8_matches_jax(model_params):
    jp, pp = model_params
    (jck, jcv, jk, jv), (pck, pcv, pk, pv) = _prefilled(jp, pp, 2, 41)
    toks = np.array([[7, 8, 9], [10, 11, 12]], np.int32)
    jl, _, _ = jw.decoder_chunk(jp, CFG.with_(**A8), jnp.asarray(toks), jnp.full((2,), 3, jnp.int32),
                                jck, jcv, jk, jv)
    pl, _, _ = pw.decoder_chunk(pp, PCFG.with_(**A8), t(toks), torch.full((2,), 3), pck, pcv, pk, pv)
    np.testing.assert_allclose(n(pl), np.asarray(jl), rtol=1e-4, atol=1e-4)


# ---- windows ----------------------------------------------------------------


def _window(seed, cfg):
    rng = np.random.default_rng(seed)
    return prepare_audio((0.1 * rng.standard_normal(12_000)).astype(np.float32),
                         n_frames=2 * cfg.max_source_positions)


def _cmp(a, b):
    assert (a is None) == (b is None)
    if a is not None:
        assert a.tokens == b.tokens
        assert a.avg_logprob == pytest.approx(b.avg_logprob, abs=1e-4, nan_ok=True)


def test_window_tokens_equal_jax():
    """Greedy tokens of a plain and of a speculative window under "a8" equal
    the JAX package's (peaked weights: every row is accepted at rung 0)."""
    jcfg = texty_config(**A8)
    jdcfg = texty_config(decoder_layers=1, encoder_layers=1, **A8)
    jp, jd = confident_params(jcfg, seed=3), jax_init(jdcfg, seed=103)
    cfg, dcfg = port_cfg(jcfg), port_cfg(jdcfg)
    params, dparams = port_params(jp), port_params(jd)
    audio = np.stack([_window(300, jcfg), _window(400, jcfg)])
    langs = [LANG, TEST_LANG_IDS[1]]
    plain = DecodeEngine(params, cfg, ST, language_token_ids=TEST_LANG_IDS, quantize_cross_kv=True)
    spec = SpeculativeEngine(params, cfg, dparams, dcfg, ST, language_token_ids=TEST_LANG_IDS,
                             quantize_cross_kv=True)
    jplain = JaxEngine(jp, jcfg, TEST_ST, language_token_ids=TEST_LANG_IDS, quantize_cross_kv=True)
    jspec = JaxSpec(jp, jcfg, jd, jdcfg, TEST_ST, language_token_ids=TEST_LANG_IDS, quantize_cross_kv=True)
    out_p, _ = plain.transcribe_window(audio, langs, seed=0)
    out_s, _ = spec.transcribe_window(audio, langs, seed=0)
    out_jp, _ = jplain.transcribe_window(jnp.asarray(audio), langs, seed=0)
    out_js, _ = jspec.transcribe_window(jnp.asarray(audio), langs, seed=0)
    assert all(r is not None and len(r.tokens) > 4 for r in out_p)
    for a, b, c, d in zip(out_p, out_s, out_jp, out_js):
        _cmp(a, c)
        _cmp(b, d)
        _cmp(a, b)


# ---- tensor parallelism -----------------------------------------------------

TC = dict(d_model=64, encoder_attention_heads=4, decoder_attention_heads=4)
TCFG = tiny_config(**TC)
TPCFG = port_cfg(TCFG).with_(**A8)


def _tp_engine(p, cfg=TPCFG):
    """A tp=2 engine over a LocalGroup of two CPU ranks, int8 cross-K/V."""
    ranks = shard_params(p, make_mesh(dp=1, tp=2, devices=["cpu"] * 2)).ranks(0)
    return DecodeEngine(TPParams(ranks, [0, 1], LocalGroup(["cpu"] * 2)), cfg, ST,
                        language_token_ids=TEST_LANG_IDS, quantize_cross_kv=True)


def test_tp2_step_matches_tp1_with_one_more_collective_a_layer():
    """One decode step at tp=2 meets the ranks 3 L + 2 times, and once more
    a layer for q's row scale (8 + L at distil-large-v3's L = 2); its logits
    equal tp=1's (a per-rank row scale would give other ones)."""
    p = port_params(jax_init(TCFG, seed=0))
    one = DecodeEngine(p, TPCFG, ST, language_token_ids=TEST_LANG_IDS, quantize_cross_kv=True)
    eng = _tp_engine(p)
    feats = torch.from_numpy(random_feats(TCFG, B=2, T=16, seed=1))
    tok = torch.tensor([5, 6], dtype=torch.int32)
    s1, s2 = one.prefill(feats, LANG), eng.prefill(feats, LANG)
    want, _, _ = pw.decoder_step(p, TPCFG, tok, 3, s1["cache_k"], s1["cache_v"], s1["xk"], s1["xv"])
    g = eng._group
    n0 = g.collectives
    got, _, _ = eng._fan("decoder_step", eng._rp, TPCFG, tok, 3, s2["cache_k"], s2["cache_v"], s2["xk"], s2["xv"])
    L = TPCFG.decoder_layers
    assert g.collectives - n0 == 3 * L + 2 + L
    np.testing.assert_allclose(n(first(got)), n(want), rtol=1e-5, atol=1e-5)


def test_tp2_window_tokens_equal_tp1():
    jcfg = texty_config(**TC, **A8)
    p = port_params(confident_params(jcfg, seed=3))
    cfg = port_cfg(jcfg)
    one = DecodeEngine(p, cfg, ST, language_token_ids=TEST_LANG_IDS, quantize_cross_kv=True)
    two = _tp_engine(p, cfg)
    audio = np.stack([_window(500, jcfg), _window(501, jcfg)])
    out1, _ = one.transcribe_window(audio, [LANG] * 2, seed=0)
    out2, _ = two.transcribe_window(audio, [LANG] * 2, seed=0)
    assert all(r is not None and len(r.tokens) > 4 for r in out1)
    for a, b in zip(out1, out2):
        _cmp(a, b)


def test_tp2_spec_round_collectives():
    """One speculative round at tp=2 meets the ranks (K+1)(3 L_draft + 2)
    times in the draft's steps (its cross-K/V stays unquantized) and
    3 L + 2 + L in the "a8" verify chunk; tokens equal tp=1's."""
    cfg = TPCFG
    jdcfg = tiny_config(**TC, decoder_layers=1, encoder_layers=1)
    dcfg = port_cfg(jdcfg).with_(**A8)
    p, d = port_params(jax_init(TCFG, seed=1)), port_params(jax_init(jdcfg, seed=2))
    mesh = make_mesh(dp=1, tp=2, devices=["cpu"] * 2)
    group = LocalGroup(["cpu"] * 2)
    eng = SpeculativeEngine(TPParams(shard_params(p, mesh).ranks(0), [0, 1], group), cfg,
                            TPParams(shard_params(d, mesh).ranks(0), [0, 1], group), dcfg, ST,
                            language_token_ids=TEST_LANG_IDS, spec_k=3, quantize_cross_kv=True)
    one = SpeculativeEngine(p, cfg, d, dcfg, ST, language_token_ids=TEST_LANG_IDS, spec_k=3, quantize_cross_kv=True)
    per_round = []
    inner = eng._spec_round

    def counted(buf, K, n0):
        c0 = group.collectives
        inner(buf, K, n0)
        per_round.append(group.collectives - c0)

    eng._spec_round = counted
    audio = np.stack([_window(9, TCFG), _window(10, TCFG)])
    out2, _ = eng.transcribe_window(audio, [LANG] * 2, seed=0)
    out1, _ = one.transcribe_window(audio, [LANG] * 2, seed=0)
    K, L, Ld = 3, cfg.decoder_layers, dcfg.decoder_layers
    assert per_round and set(per_round) == {(K + 1) * (3 * Ld + 2) + 3 * L + 2 + L}
    for a, b in zip(out1, out2):
        _cmp(a, b)


def test_tp2_worker_window_equals_localgroup():
    """q's row scale met through a ProcessGroup (gloo worker processes, the
    path NCCL ranks take over the cards): the window's results equal the
    LocalGroup tp=2 engine's."""
    jcfg = texty_config(**TC, **A8)
    cfg = port_cfg(jcfg)
    p = port_params(confident_params(jcfg, seed=3))
    sp = shard_params(p, make_mesh(tp=2, devices=["cpu"] * 2))
    audio = np.stack([_window(600, jcfg), _window(601, jcfg)])
    w = WorkerEngine(DecodeEngine, sp.ranks(0), ["cpu", "cpu"], (cfg, ST),
                     dict(language_token_ids=TEST_LANG_IDS, quantize_cross_kv=True), spawn_timeout_s=120.0)
    try:
        got, _ = w.transcribe_window_fetch(w.transcribe_window_async(audio, [LANG] * 2, 2))
    finally:
        w.close()
    want, _ = _tp_engine(p, cfg).transcribe_window(audio, [LANG] * 2, 2)
    assert all(r is not None and len(r.tokens) > 4 for r in want)
    bits = lambda x: np.float64(x).tobytes()  # noqa: E731  (a NaN average equals itself)
    assert [(r.tokens, bits(r.avg_logprob)) for r in got] == [(r.tokens, bits(r.avg_logprob)) for r in want]
