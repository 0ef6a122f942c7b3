"""Port model (norma_tpu_torch.model) vs the JAX package on the same weights.

f32 on the CPU on both sides (JAX at "highest" matmul precision, set by
conftest).  Tolerances: rtol/atol 2e-4 on activations and caches, 5e-4 on
logits (tests/test_torch_parity.py's tier): only summation order differs.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import tiny_config
from torch_port_helpers import n, port_cfg, port_params, port_tree_numpy, t, to_numpy_tree

from norma_tpu.model import load as jload
from norma_tpu.model import whisper as jw
from norma_tpu_torch.model import load as pload
from norma_tpu_torch.model import whisper as pw

TOL = dict(rtol=2e-4, atol=2e-4)
LOGIT_TOL = dict(rtol=5e-4, atol=5e-4)

CFG = tiny_config()
PCFG = port_cfg(CFG)


@pytest.fixture(scope="module")
def params():
    jp = jload.init_params(CFG, seed=1)
    return jp, port_params(jp)


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def _assert_trees_equal(jtree, ptree):
    j = dict(_leaves(to_numpy_tree(jtree)))
    p = dict(_leaves(port_tree_numpy(ptree)))
    assert j.keys() == p.keys()
    for k in j:
        np.testing.assert_array_equal(p[k], j[k], err_msg=k)


@pytest.mark.parametrize(
    "cfg", [CFG, CFG.with_(num_mel_bins=128, d_model=32, encoder_layers=1, decoder_layers=3)],
    ids=["tiny", "mels128"],
)
def test_init_params_bit_equal(cfg):
    _assert_trees_equal(jload.init_params(cfg, seed=7), pload.init_params(port_cfg(cfg), seed=7))


def test_fuse_qkv_matches(params):
    jp, pp = params
    _assert_trees_equal(jload.fuse_qkv(jp), pload.fuse_qkv(pp))
    fused = pload.fuse_qkv(pload.fuse_qkv(pp))  # idempotent
    assert "qkv_w" in fused["decoder"]["layers"] and "q_w" not in fused["decoder"]["layers"]


def _hf_tensors():
    """Random tensors under HF whisper weight names for CFG."""
    rng = np.random.default_rng(0)
    D, F, L = CFG.d_model, 4 * CFG.d_model, CFG.decoder_layers
    r = lambda *s: rng.standard_normal(s).astype(np.float32)
    hf = {
        "model.encoder.conv1.weight": r(D, CFG.num_mel_bins, 3),
        "model.encoder.conv1.bias": r(D),
        "model.encoder.conv2.weight": r(D, D, 3),
        "model.encoder.conv2.bias": r(D),
        "model.encoder.embed_positions.weight": r(CFG.max_source_positions, D),
        "model.encoder.layer_norm.weight": r(D),
        "model.encoder.layer_norm.bias": r(D),
        "model.decoder.embed_tokens.weight": r(CFG.vocab_size, D),
        "model.decoder.embed_positions.weight": r(CFG.max_target_positions, D),
        "model.decoder.layer_norm.weight": r(D),
        "model.decoder.layer_norm.bias": r(D),
    }

    def attn(p):
        for nm in ("q", "k", "v", "out"):
            hf[f"{p}.{nm}_proj.weight"] = r(D, D)
            if nm != "k":
                hf[f"{p}.{nm}_proj.bias"] = r(D)

    def common(p):
        attn(f"{p}.self_attn")
        for ln in ("self_attn_layer_norm", "final_layer_norm"):
            hf[f"{p}.{ln}.weight"], hf[f"{p}.{ln}.bias"] = r(D), r(D)
        hf[f"{p}.fc1.weight"], hf[f"{p}.fc1.bias"] = r(F, D), r(F)
        hf[f"{p}.fc2.weight"], hf[f"{p}.fc2.bias"] = r(D, F), r(D)

    for i in range(CFG.encoder_layers):
        common(f"model.encoder.layers.{i}")
    for i in range(L):
        p = f"model.decoder.layers.{i}"
        common(p)
        attn(f"{p}.encoder_attn")
        hf[f"{p}.encoder_attn_layer_norm.weight"] = r(D)
        hf[f"{p}.encoder_attn_layer_norm.bias"] = r(D)
    return hf


def test_params_from_hf_tensors_matches():
    hf = _hf_tensors()
    _assert_trees_equal(
        jload.params_from_hf_tensors(hf, CFG), pload.params_from_hf_tensors(hf, PCFG)
    )


def test_read_and_load_safetensors_match(tmp_path):
    """A safetensors file (f32 plus a BF16 tensor) reads the same through
    both packages, and loads into the same params."""
    import ml_dtypes

    from norma_tpu.model.serialize import write_safetensors

    hf = _hf_tensors()
    path = str(tmp_path / "model.safetensors")
    write_safetensors(path, {**hf, "extra.bf16": hf["model.encoder.conv1.bias"].astype(ml_dtypes.bfloat16)})
    want, got = jload.read_safetensors(path), pload.read_safetensors(path)
    assert want.keys() == got.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    _assert_trees_equal(jload.load_safetensors(path, CFG), pload.load_safetensors(path, PCFG))


def _mel(B=2, seed=0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((B, CFG.num_mel_bins, 2 * CFG.max_source_positions)).astype(np.float32)


def _feats(B=2, seed=0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((B, CFG.max_source_positions, CFG.d_model)).astype(np.float32)


@pytest.mark.parametrize("fused", [False, True])
def test_encode(params, fused):
    jp, pp = params
    if fused:
        jp, pp = jload.fuse_qkv(jp), pload.fuse_qkv(pp)
    mel = _mel()
    want = jw.encode(jp, CFG, jnp.asarray(mel))
    got = pw.encode(pp, PCFG, t(mel))
    np.testing.assert_allclose(n(got), n(want), **TOL)


def test_cross_kv(params):
    jp, pp = params
    xa = _feats()
    for g, w in zip(pw.cross_kv(pp, PCFG, t(xa)), jw.cross_kv(jp, CFG, jnp.asarray(xa))):
        assert tuple(g.shape) == tuple(w.shape)
        np.testing.assert_allclose(n(g), n(w), **TOL)


def _prefill_both(params, B=2, P=3, seed=0):
    jp, pp = params
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, CFG.vocab_size, (B, P)).astype(np.int32)
    xa = _feats(B, seed)
    jxk, jxv = jw.cross_kv(jp, CFG, jnp.asarray(xa))
    pxk, pxv = pw.cross_kv(pp, PCFG, t(xa))
    jres = jw.decoder_prefill(jp, CFG, jnp.asarray(toks), jxk, jxv)
    pres = pw.decoder_prefill(pp, PCFG, t(toks), pxk, pxv)
    return (jxk, jxv, *jres), (pxk, pxv, *pres)


def test_decoder_prefill(params):
    (_, _, jl, jck, jcv), (_, _, pl, pck, pcv) = _prefill_both(params)
    np.testing.assert_allclose(n(pl), n(jl), **LOGIT_TOL)
    np.testing.assert_allclose(n(pck), n(jck), **TOL)
    np.testing.assert_allclose(n(pcv), n(jcv), **TOL)
    assert not n(pck)[:, :, 3:].any()  # rows past the prefix are zeros


@pytest.mark.parametrize("impl", ["xla", "kernel"])
def test_decoder_step(params, impl):
    jp, pp = params
    (jxk, jxv, _, jck, jcv), (pxk, pxv, _, pck, pcv) = _prefill_both(params)
    pcfg = dataclasses.replace(PCFG, self_kv_impl=impl)
    tok = np.asarray([7, 911], np.int32)
    for pos in (3, 4):  # two steps: the second reads the first's row
        jl, jck, jcv = jw.decoder_step(jp, CFG, jnp.asarray(tok), jnp.int32(pos), jck, jcv, jxk, jxv)
        pl, pck2, pcv2 = pw.decoder_step(pp, pcfg, t(tok), pos, pck, pcv, pxk, pxv)
        assert pck2 is pck and pcv2 is pcv  # written in place
        np.testing.assert_allclose(n(pl), n(jl), **LOGIT_TOL)
        np.testing.assert_allclose(n(pck), n(jck), **TOL)
        np.testing.assert_allclose(n(pcv), n(jcv), **TOL)
        tok = tok[::-1].copy()


def test_decoder_step_grouped_rungs(params):
    """n_rungs=2: rows r*B + b share stream b's cross-K/V."""
    jp, pp = params
    (jxk, jxv, _, jck, jcv), (pxk, pxv, _, pck, pcv) = _prefill_both(params)
    jck2, jcv2 = jnp.tile(jck, (1, 2, 1, 1)), jnp.tile(jcv, (1, 2, 1, 1))
    pck2, pcv2 = pck.repeat(1, 2, 1, 1), pcv.repeat(1, 2, 1, 1)
    tok = np.asarray([5, 6, 7, 8], np.int32)
    jl, jck2, _ = jw.decoder_step(jp, CFG, jnp.asarray(tok), jnp.int32(3), jck2, jcv2, jxk, jxv, n_rungs=2)
    pl, pck2, _ = pw.decoder_step(pp, PCFG, t(tok), 3, pck2, pcv2, pxk, pxv, n_rungs=2)
    np.testing.assert_allclose(n(pl), n(jl), **LOGIT_TOL)
    np.testing.assert_allclose(n(pck2), n(jck2), **TOL)


@pytest.mark.parametrize("impl", ["xla", "kernel"])
def test_cropped_cache_step(params, impl):
    """A bucket crop cache[:, :, :S] (a view in the port, a copy in JAX):
    same logits, and the port's step writes through to the full cache."""
    jp, pp = params
    (jxk, jxv, _, jck, jcv), (pxk, pxv, _, pck, pcv) = _prefill_both(params, seed=3)
    S = 16
    tok = np.asarray([11, 12], np.int32)
    jl, jck_s, _ = jw.decoder_step(
        jp, CFG, jnp.asarray(tok), jnp.int32(3), jck[:, :, :S], jcv[:, :, :S], jxk, jxv
    )
    pcfg = dataclasses.replace(PCFG, self_kv_impl=impl)
    pl, pck_s, _ = pw.decoder_step(pp, pcfg, t(tok), 3, pck[:, :, :S], pcv[:, :, :S], pxk, pxv)
    assert tuple(pck_s.shape[2:]) == (S, CFG.d_model)
    np.testing.assert_allclose(n(pl), n(jl), **LOGIT_TOL)
    np.testing.assert_allclose(n(pck)[:, :, :S], n(jck_s), **TOL)


def test_decoder_full(params):
    jp, pp = params
    rng = np.random.default_rng(5)
    toks = rng.integers(0, CFG.vocab_size, (2, 6)).astype(np.int32)
    xa = _feats(2, 5)
    want = jw.decoder_full(jp, CFG, jnp.asarray(toks), jnp.asarray(xa))
    got = pw.decoder_full(pp, PCFG, t(toks), t(xa))
    np.testing.assert_allclose(n(got), n(want), **LOGIT_TOL)


def test_step_chain_matches_decoder_full(params):
    """Incremental steps reproduce the full forward's last-position logits."""
    _, pp = params
    rng = np.random.default_rng(8)
    toks = rng.integers(0, CFG.vocab_size, (1, 6)).astype(np.int32)
    xa = _feats(1, 8)
    full = pw.decoder_full(pp, PCFG, t(toks), t(xa))
    xk, xv = pw.cross_kv(pp, PCFG, t(xa))
    _, ck, cv = pw.decoder_prefill(pp, PCFG, t(toks[:, :3]), xk, xv)
    for pos in range(3, 6):
        ll, ck, cv = pw.decoder_step(pp, PCFG, t(toks[:, pos]), pos, ck, cv, xk, xv)
        np.testing.assert_allclose(n(ll), n(full[:, pos]), **LOGIT_TOL)


TPU_KNOBS = dict(
    flash_attention=True, encoder_attn_impl="flash", encoder_attn_chunk=50, encoder_unroll=2,
    flash_block_q=128, flash_block_k=128, encoder_scores_bf16=True, encoder_q8_mode="w8a16",
    cross_kv_impl="kernel", cross_kv_chunk=100, cross_kv_kernel_hpc=2, self_kv_kernel_hpc=2,
    decoder_scan_unroll=2,
)


def test_tpu_only_knobs_are_ignored(params):
    """The TPU-only WhisperConfig fields are accepted and change nothing."""
    _, pp = params
    knobbed = PCFG.with_(**TPU_KNOBS)
    mel = t(_mel(1, 2))
    torch.testing.assert_close(pw.encode(pp, knobbed, mel), pw.encode(pp, PCFG, mel), rtol=0, atol=0)
    _, (pxk, pxv, _, pck, pcv) = _prefill_both(params, seed=2)
    tok = torch.tensor([3, 4])
    want, _, _ = pw.decoder_step(pp, PCFG, tok, 3, pck.clone(), pcv.clone(), pxk, pxv)
    got, _, _ = pw.decoder_step(pp, knobbed, tok, 3, pck.clone(), pcv.clone(), pxk, pxv)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_step_rejects_position_outside_cache(params):
    _, pp = params
    _, (pxk, pxv, _, pck, pcv) = _prefill_both(params)
    with pytest.raises(ValueError, match="outside"):
        pw.decoder_step(pp, PCFG, torch.tensor([1, 2]), 8, pck[:, :, :8], pcv[:, :, :8], pxk, pxv)
