"""Fused QKV on the port (norma_tpu_torch/model/load.py::fuse_qkv) against
the unfused params and against the JAX package's fused params
(tests/test_qkv_fusion.py's cases but test_fused_shardings_build, which
needs a device mesh), on the CPU at f32.

The fused form runs the three self-attention input projections as one
product; the math is the same dot products (K's bias slot is zeros), so
the port's unfused and fused outputs agree to f32 tolerance (rtol = atol
= 2e-5 on logits, 1e-5 on encoder features, 1e-5 on int8 logits) and
greedy transcripts exactly.  Each output is also held against JAX's on
the same inputs at test_torch_model.py's tier (2e-4 on encoder features,
5e-4 on logits: only the frameworks' summation order differs).  Fused
leaves, full precision and int8 alike, equal JAX's bit for bit.
"""

import numpy as np
import pytest
import torch

import norma_tpu.decode.engine as jengine_mod
import norma_tpu_torch.decode.engine as engine_mod
from helpers import TEST_LANG_IDS, TEST_ST, tiny_config
from norma_tpu.decode.engine import DecodeEngine as JEngine
import jax.numpy as jnp
from norma_tpu.model import fuse_qkv as jfuse
from norma_tpu.model import init_params as jinit
from norma_tpu.model import quant as jquant
from norma_tpu.model import whisper as jw
from norma_tpu_torch.decode.engine import DecodeEngine
from norma_tpu_torch.frontend.mel import prepare_audio
from norma_tpu_torch.model import fuse_qkv
from norma_tpu_torch.model.quant import quantize_decoder
from norma_tpu_torch.model.whisper import decoder_full, encode
from torch_port_helpers import n, port_cfg, port_params, port_st

JCFG = tiny_config()
CFG = port_cfg(JCFG)
JPARAMS = jinit(JCFG, seed=0)
PARAMS = port_params(JPARAMS)
FUSED = fuse_qkv(PARAMS)
JFUSED = jfuse(JPARAMS)
FEAT_TOL = dict(rtol=2e-4, atol=2e-4)  # port against JAX
LOGIT_TOL = dict(rtol=5e-4, atol=5e-4)


def _xa(seed, B):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal((B, CFG.max_source_positions, CFG.d_model)).astype(np.float32))


def _jax_decoder_full(jparams, toks, xa):
    return np.asarray(jw.decoder_full(jparams, JCFG, jnp.asarray(n(toks)), jnp.asarray(n(xa))))


def test_fuse_structure():
    layers = FUSED["decoder"]["layers"]
    assert "qkv_w" in layers and "q_w" not in layers
    L, D = CFG.decoder_layers, CFG.d_model
    assert layers["qkv_w"].shape == (L, D, 3, D)
    assert layers["qkv_b"].shape == (L, 3, D)
    assert torch.equal(layers["qkv_b"][:, 1], torch.zeros(L, D))  # k_proj has no bias
    again = fuse_qkv(FUSED)  # idempotent
    assert again["decoder"]["layers"] is not FUSED["decoder"]["layers"]
    assert "qkv_w" in again["decoder"]["layers"]
    jl = JFUSED
    for part in ("encoder", "decoder"):
        for k in ("qkv_w", "qkv_b"):
            np.testing.assert_array_equal(n(FUSED[part]["layers"][k]), n(jl[part]["layers"][k]), err_msg=k)


def test_encoder_parity():
    mel = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (2, CFG.num_mel_bins, 2 * CFG.max_source_positions)).astype(np.float32))
    raw, fused = n(encode(PARAMS, CFG, mel)), n(encode(FUSED, CFG, mel))
    np.testing.assert_allclose(raw, fused, rtol=1e-5, atol=1e-5)
    for jparams, got in ((JPARAMS, raw), (JFUSED, fused)):
        want = np.asarray(jw.encode(jparams, JCFG, jnp.asarray(n(mel))))
        np.testing.assert_allclose(got, want, **FEAT_TOL)


def test_decoder_parity():
    toks = torch.from_numpy(np.random.default_rng(1).integers(0, CFG.vocab_size, (2, 7)).astype(np.int32))
    xa = _xa(1, 2)
    raw, fused = n(decoder_full(PARAMS, CFG, toks, xa)), n(decoder_full(FUSED, CFG, toks, xa))
    np.testing.assert_allclose(raw, fused, rtol=2e-5, atol=2e-5)
    for jparams, got in ((JPARAMS, raw), (JFUSED, fused)):
        np.testing.assert_allclose(got, _jax_decoder_full(jparams, toks, xa), **LOGIT_TOL)


def test_transcribe_window_token_parity(monkeypatch):
    """Greedy windows through the unfused, the fused and JAX's fused
    engines: the same tokens."""
    monkeypatch.setattr(engine_mod, "LOGPROB_THRESHOLD", -100.0)
    monkeypatch.setattr(jengine_mod, "LOGPROB_THRESHOLD", -100.0)
    st = port_st(TEST_ST)
    e_raw = DecodeEngine(PARAMS, CFG, st, language_token_ids=TEST_LANG_IDS)
    e_fused = DecodeEngine(FUSED, CFG, st, language_token_ids=TEST_LANG_IDS)
    e_jax = JEngine(JFUSED, JCFG, TEST_ST, language_token_ids=TEST_LANG_IDS)
    lang = TEST_LANG_IDS[0]
    for seed in range(3):
        raw = (0.1 * np.random.default_rng(seed).standard_normal(9000)).astype(np.float32)
        audio = prepare_audio(raw, n_frames=2 * CFG.max_source_positions)[None]
        want = e_raw.transcribe_window(audio, [lang], seed=0)[0][0]
        got = e_fused.transcribe_window(audio, [lang], seed=0)[0][0]
        jgot = e_jax.transcribe_window(audio, [lang], seed=0)[0][0]
        assert got.tokens == want.tokens == jgot.tokens, f"seed {seed}"
        assert got.avg_logprob == pytest.approx(want.avg_logprob, abs=1e-4, nan_ok=True)


def test_quantize_commutes_with_fuse():
    """quantize_decoder(fuse_qkv(p)) == fuse_qkv(quantize_decoder(p)):
    per-out-channel int8 grids do not see the stacking.  The int8 fusion
    (codes stacked on axis 2, scales on axis 1, K's zero bias) equals
    JAX's fuse_qkv(quantize_decoder(p)) bit for bit."""
    qf = quantize_decoder(FUSED)
    fq = fuse_qkv(quantize_decoder(PARAMS))
    jfq = jfuse(jquant.quantize_decoder(JPARAMS))
    for part in ("encoder", "decoder"):
        keys = set(k for k, _ in fq[part]["layers"].items())
        assert set(k for k, _ in qf[part]["layers"].items()) == keys == set(jfq[part]["layers"]), part
    a, b, j = qf["decoder"]["layers"], fq["decoder"]["layers"], jfq["decoder"]["layers"]
    assert torch.equal(a["qkv_w_q"], b["qkv_w_q"])
    np.testing.assert_allclose(n(a["qkv_w_s"]), n(b["qkv_w_s"]), rtol=1e-6)
    for k in ("qkv_w_q", "qkv_w_s", "qkv_b"):
        assert b[k].dtype == {"qkv_w_q": torch.int8}.get(k, torch.float32), k
        assert tuple(b[k].shape) == j[k].shape, k
        np.testing.assert_array_equal(b[k].numpy(), np.asarray(j[k]), err_msg=k)


def test_quantized_fused_decode_runs():
    toks = torch.from_numpy(np.random.default_rng(2).integers(0, CFG.vocab_size, (1, 5)).astype(np.int32))
    xa = _xa(2, 1)
    a = n(decoder_full(quantize_decoder(FUSED), CFG, toks, xa))
    b = n(decoder_full(fuse_qkv(quantize_decoder(PARAMS)), CFG, toks, xa))
    np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)
    assert np.isfinite(a).all()
    want = _jax_decoder_full(jfuse(jquant.quantize_decoder(JPARAMS)), toks, xa)
    np.testing.assert_allclose(b, want, **LOGIT_TOL)
