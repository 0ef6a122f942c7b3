"""The port's int8 self-attention cache (quantize_self_kv) vs the JAX
package, on the CPU.

  - quantize_self_kv_cache codes and scales are bit-equal to JAX's, and
    attention_self_q8 matches JAX's at f32 (summation order);
  - decoder_step over an int8 cache writes the same quantized row and
    gives JAX's logits;
  - DecodeEngine(quantize_self_kv=True) gives JAX's greedy tokens on both
    ladder arms;
  - fault: with self_kv_impl="kernel" and an int8 cache the self-decode
    kernel's wrapper is never called (it reads bf16/f32 caches only), as
    in the JAX package.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import TEST_LANG_IDS, TEST_ST, confident_params, texty_config, tiny_config
from torch_port_helpers import n, port_cfg, port_params, port_st, t

from norma_tpu.decode.engine import DecodeEngine as JaxEngine
from norma_tpu.frontend.mel import prepare_audio
from norma_tpu.model import load as jload
from norma_tpu.model import whisper as jw
from norma_tpu_torch.decode import DecodeEngine
from norma_tpu_torch.model import whisper as pw
from norma_tpu_torch.ops import self_decode

CFG = tiny_config()
PCFG = port_cfg(CFG)
TOL = dict(rtol=2e-4, atol=2e-4)


def _cache(seed=0, L=2, B=3, T=16, D=64):
    c = np.random.default_rng(seed).standard_normal((L, B, T, D)).astype(np.float32)
    c[:, :, T - 4:] = 0.0  # unwritten rows quantize to zeros
    c[0, 1, 2, :5] = [127.5, -127.5, 0.5, -0.5, 1.5]  # half-way cases
    return c


def test_quantize_self_kv_cache_bit_equal():
    c = _cache()
    j = jw.quantize_self_kv_cache(jnp.asarray(c))
    p = pw.quantize_self_kv_cache(t(c))
    assert p["q"].dtype == torch.int8 and p["s"].dtype == torch.float32
    assert tuple(p["s"].shape) == c.shape[:3] + (1,)
    np.testing.assert_array_equal(n(p["q"]), np.asarray(j["q"]))
    np.testing.assert_array_equal(n(p["s"]), np.asarray(j["s"]))
    rq, rs = pw.quantize_kv_row(t(c[0, :, 5:6]))  # a loop row: the same grid
    np.testing.assert_array_equal(n(rq), n(p["q"][0, :, 5:6]))
    np.testing.assert_array_equal(n(rs), n(p["s"][0, :, 5:6]))


@pytest.mark.parametrize("pos", [0, 7, 15])
def test_attention_self_q8_matches_jax(pos):
    ck, cv = _cache(1)[0], _cache(2)[0]  # [B, T, D]
    q = np.random.default_rng(3).standard_normal((3, 1, 64)).astype(np.float32)
    mask = np.where(np.arange(16) <= pos, 0.0, -np.inf).astype(np.float32)
    jk, jv = jw.quantize_self_kv_cache(jnp.asarray(ck)), jw.quantize_self_kv_cache(jnp.asarray(cv))
    want = jw.attention_self_q8(jnp.asarray(q), jk, jv, 2, jnp.asarray(mask)[None, None, None, :])
    pk, pv = pw.quantize_self_kv_cache(t(ck)), pw.quantize_self_kv_cache(t(cv))
    got = pw.attention_self_q8(t(q), pk, pv, 2, t(mask))
    np.testing.assert_allclose(n(got), np.asarray(want), **TOL)


@pytest.fixture(scope="module")
def params():
    jp = jload.init_params(CFG, seed=4)
    return jp, port_params(jp)


def test_decoder_step_int8_cache_matches_jax(params):
    jp, pp = params
    rng = np.random.default_rng(5)
    toks = rng.integers(0, CFG.vocab_size, (2, 3)).astype(np.int32)
    xa = rng.standard_normal((2, CFG.max_source_positions, CFG.d_model)).astype(np.float32)
    jxk, jxv = jw.cross_kv(jp, CFG, jnp.asarray(xa))
    _, jck, jcv = jw.decoder_prefill(jp, CFG, jnp.asarray(toks), jxk, jxv)
    pxk, pxv = pw.cross_kv(pp, PCFG, t(xa))
    _, pck, pcv = pw.decoder_prefill(pp, PCFG, t(toks), pxk, pxv)
    jck, jcv = jw.quantize_self_kv_cache(jck), jw.quantize_self_kv_cache(jcv)
    pck, pcv = pw.quantize_self_kv_cache(pck), pw.quantize_self_kv_cache(pcv)
    tok = np.asarray([7, 911], np.int32)
    for pos in (3, 4):
        jl, jck, jcv = jw.decoder_step(jp, CFG, jnp.asarray(tok), jnp.int32(pos), jck, jcv, jxk, jxv)
        pl, _, _ = pw.decoder_step(pp, PCFG, t(tok), pos, pck, pcv, pxk, pxv)
        np.testing.assert_allclose(n(pl), np.asarray(jl), rtol=5e-4, atol=5e-4)
        # The written row quantizes alike (an f32 row on a rounding
        # boundary may land one code apart: summation order).
        assert np.mean(n(pck["q"][:, :, pos]) == np.asarray(jck["q"])[:, :, pos]) > 0.99
        np.testing.assert_allclose(n(pck["s"][:, :, pos]), np.asarray(jck["s"])[:, :, pos], rtol=1e-5)
        tok = tok[::-1].copy()


def _windows(cfg, B, seed):
    rng = np.random.default_rng(seed)
    n_frames = 2 * cfg.max_source_positions
    return np.stack([prepare_audio((0.1 * rng.standard_normal(12_000)).astype(np.float32), n_frames=n_frames)
                     for _ in range(B)])


@pytest.mark.parametrize("B", [1, 4], ids=["speculative", "sequential"])
def test_engine_quantize_self_kv_matches_jax(B):
    cfg = texty_config()
    jp = confident_params(cfg)
    je = JaxEngine(jp, cfg, TEST_ST, language_token_ids=TEST_LANG_IDS, quantize_self_kv=True)
    pe = DecodeEngine(port_params(jp), port_cfg(cfg), port_st(TEST_ST), language_token_ids=TEST_LANG_IDS,
                      quantize_self_kv=True)
    assert pe.quantize_self_kv is True
    audio = _windows(cfg, B, 11 + B)
    jdrs, _ = je.transcribe_window(audio, [TEST_LANG_IDS[0]] * B, seed=0)
    pdrs, _ = pe.transcribe_window(audio, [TEST_LANG_IDS[0]] * B, seed=0)
    for jd, pd in zip(jdrs, pdrs):
        assert jd is not None and pd is not None
        assert pd.tokens == jd.tokens and len(pd.tokens) > 10


def test_kernel_setting_skips_the_self_decode_kernel_on_an_int8_cache(monkeypatch):
    """Fault: self_kv_impl="kernel" over an int8 cache takes the int8
    attention, never the self-decode kernel's wrapper; over a float cache
    it does take the wrapper."""
    cfg = texty_config(self_kv_impl="kernel")
    pp = port_params(confident_params(cfg))
    calls = []
    orig = self_decode.self_attention_decode

    def spy(*a, **k):
        calls.append(1)
        return orig(*a, **k)

    monkeypatch.setattr(pw, "self_attention_decode", spy)
    audio = _windows(cfg, 1, 21)
    q8 = DecodeEngine(pp, port_cfg(cfg), port_st(TEST_ST), language_token_ids=TEST_LANG_IDS, quantize_self_kv=True)
    drs, _ = q8.transcribe_window(audio, [TEST_LANG_IDS[0]], seed=0)
    assert drs[0] is not None and q8.decode_steps > 0 and not calls
    plain = DecodeEngine(pp, port_cfg(cfg), port_st(TEST_ST), language_token_ids=TEST_LANG_IDS)
    plain.transcribe_window(audio, [TEST_LANG_IDS[0]], seed=0)
    assert calls
