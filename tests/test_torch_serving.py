"""The batched serving configuration, port vs JAX engine, on the CPU.

The serving point is the JAX package's ``batched8_serving`` arm: fused
QKV, ``quantize_encoder(quantize_decoder(params))`` (w8a8 encoder, int8
decoder and head), ``encoder_attn_impl="jax_flash"``,
``cross_kv_impl="kernel"``, ``self_kv_impl="kernel"`` and an engine with
``quantize_cross_kv=True``.  Here at texty_config() with confident_params()
(peaked softmax, EOT suppressed: greedy rung-0 decodes to the length cap).
``NORMA_XKV_KERNEL_INTERPRET=1`` makes the JAX engine build its kernel
layout and run the cross-decode kernel in Pallas interpret mode; its flash
encoder and self-decode kernel are TPU-only and take their XLA twins.  The
port runs the plain versions behind every kernel wrapper.

Both ladder arms: B=1 takes the speculative ladder (6 rungs as rows of one
loop, G=6 in the cross kernel), B=4 the sequential one.  Greedy tokens must
be equal.  The int4 tier matches JAX's int4 engine on the serving weights,
and follows tests/test_quant.py's shared-prefix rule against the
unquantized cross-K/V engine on full-precision weights.
"""

import numpy as np
import pytest
import torch

from helpers import TEST_LANG_IDS, TEST_ST, confident_params, texty_config
from torch_port_helpers import port_cfg, port_params, port_st

from norma_tpu.decode.engine import DecodeEngine as JaxEngine
from norma_tpu.frontend.mel import prepare_audio
from norma_tpu.model import load as jload
from norma_tpu.model import quant as jquant
from norma_tpu_torch.decode import DecodeEngine
from norma_tpu_torch.model import load as pload
from norma_tpu_torch.model import quant as pquant
from norma_tpu_torch.ops import paged_cross

SERVE = dict(encoder_attn_impl="jax_flash", cross_kv_impl="kernel", self_kv_impl="kernel")
CFG = texty_config().with_(**SERVE)
PCFG = port_cfg(CFG)
ST = port_st(TEST_ST)


@pytest.fixture(scope="module")
def params():
    jp = confident_params(CFG)
    jq = jquant.quantize_encoder(jquant.quantize_decoder(jload.fuse_qkv(jp)))
    pq = pquant.quantize_encoder(pquant.quantize_decoder(pload.fuse_qkv(port_params(jp))))
    return jp, jq, pq


def _windows(B, seed=41):
    rng = np.random.default_rng(seed)
    n_frames = 2 * CFG.max_source_positions
    return np.stack([
        prepare_audio((0.1 * rng.standard_normal(12_000)).astype(np.float32), n_frames=n_frames)
        for _ in range(B)
    ])


def test_port_quantizes_like_jax(params):
    """The port's own quantization of the fused tree equals the JAX tree
    carried over (so the engines below run the same weights)."""
    _, jq, pq = params
    carried = port_params(jq)
    for part in ("encoder", "decoder"):
        a, b = dict(carried[part]["layers"].items()), dict(pq[part]["layers"].items())
        assert a.keys() == b.keys()
        for k in a:
            assert torch.equal(a[k], b[k]), (part, k)
    assert torch.equal(carried["decoder"]["tok_emb_q8"]["q"], pq["decoder"]["tok_emb_q8"]["q"])


@pytest.mark.parametrize("B", [1, 4], ids=["speculative", "sequential"])
def test_serving_window_matches_jax(params, B, monkeypatch):
    monkeypatch.setenv("NORMA_XKV_KERNEL_INTERPRET", "1")
    _, jq, pq = params
    je = JaxEngine(jq, CFG, TEST_ST, language_token_ids=TEST_LANG_IDS, quantize_cross_kv=True)
    pe = DecodeEngine(pq, PCFG, ST, language_token_ids=TEST_LANG_IDS, quantize_cross_kv=True)
    assert pe.quantize_cross_kv is True
    calls = []
    orig = paged_cross.cross_attention_decode_torch
    monkeypatch.setattr(paged_cross, "cross_attention_decode_torch", lambda *a: calls.append(a[5]) or orig(*a))
    audio = _windows(B)
    langs = [TEST_LANG_IDS[0]] * B
    jdrs, _ = je.transcribe_window(audio, langs, seed=0)
    pdrs, _ = pe.transcribe_window(audio, langs, seed=0)
    assert calls and set(calls) == {6 if B == 1 else 1}  # the kernel layout, G rungs per stream
    for jd, pd in zip(jdrs, pdrs):
        assert jd is not None and pd is not None
        assert pd.tokens == jd.tokens and len(pd.tokens) > 10
        np.testing.assert_allclose(pd.avg_logprob, jd.avg_logprob, atol=1e-3)


def test_int4_tier_matches_jax(params, monkeypatch):
    """The serving weights with int4 cross-K/V: the port's tokens equal the
    JAX int4 engine's on both ladder arms."""
    monkeypatch.setenv("NORMA_XKV_KERNEL_INTERPRET", "1")
    _, jq, pq = params
    e_q4 = DecodeEngine(pq, PCFG, ST, language_token_ids=TEST_LANG_IDS, quantize_cross_kv="int4")
    je_q4 = JaxEngine(jq, CFG, TEST_ST, language_token_ids=TEST_LANG_IDS, quantize_cross_kv="int4")
    assert e_q4.quantize_cross_kv == "int4" and je_q4.quantize_cross_kv == "int4"
    win = _windows(1)[0]
    for B in (1, 4):
        audio = np.stack([win] * B)
        langs = [TEST_LANG_IDS[0]] * B
        out_q, _ = e_q4.transcribe_window(audio, langs, seed=0)
        out_j, _ = je_q4.transcribe_window(audio, langs, seed=0)
        for rq, rj in zip(out_q, out_j):
            assert rq is not None and rj is not None
            assert rq.tokens == rj.tokens


def test_int4_tier_shared_prefix():
    """tests/test_quant.py's rule on the port: on the peaked model (full
    precision weights) the int4 cross-K/V window shares a long greedy
    prefix with the unquantized one on both ladder arms."""
    pp = port_params(confident_params(CFG))
    e_ref = DecodeEngine(pp, PCFG, ST, language_token_ids=TEST_LANG_IDS)
    e_q4 = DecodeEngine(pp, PCFG, ST, language_token_ids=TEST_LANG_IDS, quantize_cross_kv="int4")
    win = _windows(1)[0]
    for B in (1, 4):
        audio = np.stack([win] * B)
        langs = [TEST_LANG_IDS[0]] * B
        out_q, _ = e_q4.transcribe_window(audio, langs, seed=0)
        out_r, _ = e_ref.transcribe_window(audio, langs, seed=0)
        for rq, rr in zip(out_q, out_r):
            assert rq is not None and rr is not None
            n = min(len(rq.tokens), len(rr.tokens))
            agree = next((i for i in range(n) if rq.tokens[i] != rr.tokens[i]), n)
            assert agree >= int(0.75 * n), f"B={B}: int4 diverged at {agree}/{n}"


def test_int4_needs_the_kernel_layout(params, caplog):
    _, _, pq = params
    with pytest.raises(ValueError, match="int4"):
        DecodeEngine(pq, PCFG, ST, quantize_cross_kv="int2")
    e = DecodeEngine(pq, PCFG.with_(cross_kv_impl="einsum"), ST, quantize_cross_kv="int4")
    assert e.quantize_cross_kv is True  # falls back to int8 with a warning


def test_quantized_xkv_is_loop_side_only(params, monkeypatch):
    """Prefill (and detection) read the unquantized cross-K/V; only the
    token loop gets the kernel layout."""
    _, _, pq = params
    pe = DecodeEngine(pq, PCFG, ST, language_token_ids=TEST_LANG_IDS, quantize_cross_kv=True)
    import norma_tpu_torch.decode.engine as em

    seen = {}
    orig_prefill, orig_step = em.decoder_prefill, em.decoder_step

    def prefill(params_, cfg, toks, xk, xv):
        seen.setdefault("prefill", type(xk))
        return orig_prefill(params_, cfg, toks, xk, xv)

    def step(*a, **k):
        seen.setdefault("step", sorted(a[6]) if isinstance(a[6], dict) else type(a[6]))
        return orig_step(*a, **k)

    monkeypatch.setattr(em, "decoder_prefill", prefill)
    monkeypatch.setattr(em, "decoder_step", step)
    pe.transcribe_window(_windows(1), [-1], seed=0)
    assert seen["prefill"] is torch.Tensor
    assert seen["step"] == ["codes", "s"]
    state = pe.prefill(torch.zeros(1, CFG.max_source_positions, CFG.d_model), TEST_LANG_IDS[0])
    assert sorted(state["xk"]) == ["codes", "s"]
    dr = pe.run_loop(state, 0.0, seed=0)[0]
    assert dr.tokens[0] == TEST_ST.sot
