"""The port's quant tiers (ops/quant_matmul.py, model/quant.py and the int8
dispatch in model/whisper.py) vs the JAX package, on the CPU.

  - codes and scales of quantize_decoder / quantize_encoder /
    quantize_activations are bit-equal to the JAX package's;
  - the plain w8a8 product equals JAX's q8a8_dense and the Pallas kernel
    in interpret mode exactly (exact int32 accumulation, same f32
    epilogue order);
  - int8-weight forwards (logits head, encode in both encoder_q8_mode
    arms, decoder_step) agree with JAX within stated tolerances;
  - three repaired faults: bf16 products accumulate in f32 and round once
    (dense, qkv_proj, the logits head); the weight carry keeps int8 codes
    and f32 scales; (the config-knob test is test_torch_model.py's).

f32 tolerances are summation order (2e-4, the model tests' tier) plus, for
w8a8, the odd activation code that sits on a rounding boundary in one
framework and not the other (one int8 step, <= 1/127 of a row's absmax).
"""

import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from helpers import tiny_config
from torch_port_helpers import n, port_cfg, port_params, port_tree_numpy, t, to_numpy_tree

from norma_tpu.model import load as jload
from norma_tpu.model import quant as jquant
from norma_tpu.model import whisper as jw
from norma_tpu.ops import quant_matmul as jq
from norma_tpu_torch.model import load as pload
from norma_tpu_torch.model import quant as pquant
from norma_tpu_torch.model import whisper as pw
from norma_tpu_torch.ops import quant_matmul as pq

CFG = tiny_config()
PCFG = port_cfg(CFG)
TOL = dict(rtol=2e-4, atol=2e-4)


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


def _quantize_both(params, fused, which):
    jp, pp = params
    if fused:
        jp, pp = jload.fuse_qkv(jp), pload.fuse_qkv(pp)
    jfn = {"decoder": jquant.quantize_decoder, "encoder": jquant.quantize_encoder}[which]
    pfn = {"decoder": pquant.quantize_decoder, "encoder": pquant.quantize_encoder}[which]
    return jfn(jp), pfn(pp)


@pytest.mark.parametrize("which", ["decoder", "encoder"])
@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_quantize_tree_bit_equal(params, fused, which):
    jq_tree, pq_tree = _quantize_both(params, fused, which)
    j = dict(_leaves(to_numpy_tree(jq_tree)))
    p = dict(_leaves(port_tree_numpy(pq_tree)))
    assert j.keys() == p.keys()
    for k in j:
        np.testing.assert_array_equal(p[k], j[k], err_msg=k)
    ptree = dict(_tensor_leaves(pq_tree))
    keys = pquant.DECODER_W8_KEYS if which == "decoder" else pquant.ENCODER_W8_KEYS
    quantized = [k for k in ptree if k.endswith("_q")]
    assert quantized and all(ptree[k].dtype == torch.int8 for k in quantized)
    assert all(ptree[k[:-2] + "_s"].dtype == torch.float32 for k in quantized)
    assert not any(k.rsplit(".", 1)[-1] in keys for k in ptree if f".layers." in k and which in k)


def _tensor_leaves(p, prefix=""):
    for k, v in p.items():
        if isinstance(v, torch.nn.Module):
            yield from _tensor_leaves(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def test_quantize_logits_head_bit_equal(params):
    jp, pp = params
    jh = jquant.quantize_logits_head(jp)["decoder"]["tok_emb_q8"]
    ph = pquant.quantize_logits_head(pp)["decoder"]["tok_emb_q8"]
    np.testing.assert_array_equal(n(ph["q"]), np.asarray(jh["q"]))
    np.testing.assert_array_equal(n(ph["s"]), np.asarray(jh["s"]))
    assert ph["q"].dtype == torch.int8 and ph["s"].dtype == torch.float32


def test_int4_logits_head_not_ported(params):
    with pytest.raises(NotImplementedError, match="queue 2 #7"):
        pquant.quantize_decoder(params[1], logits="int4")
    with pytest.raises(ValueError):
        pquant.quantize_decoder(params[1], logits="int2")


def _act_inputs():
    rng = np.random.default_rng(24)
    x = rng.standard_normal((2, 37, 64)).astype(np.float32)
    x[0, 0] = 0.0  # all-zero row: scale 1, codes 0
    x[1, 2, :5] = [127.5, -127.5, 0.5, -0.5, 1.5]  # half-way cases
    return x


def test_quantize_activations_bit_equal():
    x = _act_inputs()
    jx, js = jq.quantize_activations(jnp.asarray(x))
    px, ps = pq.quantize_activations(t(x))
    assert px.dtype == torch.int8 and ps.dtype == torch.float32
    np.testing.assert_array_equal(n(px), np.asarray(jx))
    np.testing.assert_array_equal(n(ps), np.asarray(js))
    assert np.isfinite(n(ps)).all() and not n(px)[0, 0].any()


def test_quantize_activations_subnormal_row():
    """An all-subnormal row keeps a finite (floored) scale and zero codes.
    (JAX on the CPU flushes subnormals to zero and reports scale 1 there;
    the product is 0 either way.)"""
    x = np.full((1, 8), 1e-40, np.float32)
    px, ps = pq.quantize_activations(t(x))
    assert np.isfinite(n(ps)).all() and n(ps)[0, 0] > 0 and not n(px).any()


def _q8a8_inputs(N=300, K=64):
    rng = np.random.default_rng(25)
    x = _act_inputs() if K == 64 else rng.standard_normal((2, 37, K)).astype(np.float32)
    w = rng.standard_normal((K, N)).astype(np.float32)
    b = rng.standard_normal(N).astype(np.float32)
    return x, w, b


@pytest.mark.parametrize("bias", [True, False])
def test_q8a8_dense_matches_jax_and_pallas(bias):
    """The plain w8a8 product (and the wrapper on CPU tensors) equals JAX's
    q8a8_dense and q8a8_dense_pallas(interpret=True) bit for bit."""
    x, w, b = _q8a8_inputs()
    wq, ws = jq.quantize_per_channel(w)
    xq, xs = jq.quantize_activations(jnp.asarray(x))
    jb = jnp.asarray(b) if bias else None
    want = np.asarray(jq.q8a8_dense(xq, xs, wq, ws, jb))
    pallas = np.asarray(
        jq.q8a8_dense_pallas(xq, xs, wq, ws, jb, block_m=32, block_n=128, interpret=True)
    )
    args = [t(np.asarray(a)) for a in (xq, xs, wq, ws)] + [t(b) if bias else None]
    for got in (pq.q8a8_dense_torch(*args), pq.q8a8_dense(*args)):
        assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
        np.testing.assert_array_equal(n(got), want)
        np.testing.assert_array_equal(n(got), pallas)
    before = pq.q8a8_dense.launches
    pq.q8a8_dense(*args)
    assert pq.q8a8_dense.launches == before  # CPU tensors launch no kernel


def test_q8a8_integer_accumulation_exact():
    """Unit scales expose the raw accumulation: exact even where an f32
    accumulation would round (|acc| > 2**24 needs K * 127**2 > 2**24)."""
    K, N = 2048, 16
    xq = torch.full((3, K), 127, dtype=torch.int8)
    wq = torch.full((K, N), 127, dtype=torch.int8)
    wq[0, 1] = -127
    one = torch.ones(3, 1), torch.ones(N)
    got = pq.q8a8_dense_torch(xq, one[0], wq, one[1])
    want = (xq.long() @ wq.long()).float()
    assert torch.equal(got, want)


def test_q8a8_qkv_matches_jax():
    rng = np.random.default_rng(26)
    x = rng.standard_normal((2, 9, 64)).astype(np.float32)
    w3 = rng.standard_normal((64, 3, 48)).astype(np.float32)
    b3 = rng.standard_normal((3, 48)).astype(np.float32)
    b3[1] = 0.0
    w3q = np.clip(np.round(w3 / (np.abs(w3).max(0) / 127.0)), -127, 127).astype(np.int8)
    w3s = (np.abs(w3).max(0) / 127.0).astype(np.float32)
    xq, xs = jq.quantize_activations(jnp.asarray(x))
    want = jq.q8a8_qkv(xq, xs, jnp.asarray(w3q), jnp.asarray(w3s), jnp.asarray(b3))
    got = pq.q8a8_qkv(t(np.asarray(xq)), t(np.asarray(xs)), t(w3q), t(w3s), t(b3))
    for g, w_ in zip(got, want):
        np.testing.assert_array_equal(n(g), np.asarray(w_))


def test_q8a8_rejects_bad_inputs():
    xq = torch.zeros((4, 32), dtype=torch.int8)
    with pytest.raises(TypeError):
        pq.q8a8_dense(xq.float(), torch.ones(4, 1), torch.zeros((32, 16), dtype=torch.int8), torch.ones(16))
    with pytest.raises(ValueError):
        pq.q8a8_dense(xq, torch.ones(4, 1), torch.zeros((16, 16), dtype=torch.int8), torch.ones(16))
    with pytest.raises(ValueError, match="device"):
        pq.q8a8_dense(xq.to("meta"), torch.ones(4, 1, device="meta"),
                      torch.zeros((32, 16), dtype=torch.int8, device="meta"), torch.ones(16, device="meta"))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_int8_logits_head_matches_w8_matmul(params, dtype):
    jp, pp = params
    jh = jquant.quantize_logits_head(jp)["decoder"]
    ph = pquant.quantize_logits_head(pp)["decoder"]
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 3, CFG.d_model)).astype(np.float32)
    if dtype == "bf16":
        x = x.astype(ml_dtypes.bfloat16).astype(np.float32)
    want = np.asarray(jw.logits_head(jh, jnp.asarray(x)))
    want2 = np.asarray(jq.w8_matmul_jnp(jnp.asarray(x.reshape(6, -1)), jh["tok_emb_q8"]["q"], jh["tok_emb_q8"]["s"]))
    xt = t(x, torch.bfloat16 if dtype == "bf16" else None)
    got = pw.logits_head(ph, xt)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(n(got), want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(n(got).reshape(6, -1), want2, rtol=1e-5, atol=1e-5)


def _mel(B=2, seed=0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((B, CFG.num_mel_bins, 2 * CFG.max_source_positions)).astype(np.float32)


@pytest.mark.parametrize("mode", ["w8a8", "w8a16", "w8a8_pallas"])
@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_encode_quantized_matches_jax(params, mode, fused):
    jqp, pqp = _quantize_both(params, fused, "encoder")
    mel = _mel()
    want = np.asarray(jw.encode(jqp, CFG.with_(encoder_q8_mode=mode), jnp.asarray(mel)))
    before = pq.q8a8_dense.launches
    got = n(pw.encode(pqp, PCFG.with_(encoder_q8_mode=mode), t(mel)))
    assert pq.q8a8_dense.launches == before
    # w8a8: an activation code on a rounding boundary may land one int8
    # step apart (<= 1/127 of the row's absmax) between the frameworks.
    tol = dict(rtol=2e-2, atol=2e-2) if mode != "w8a16" else TOL
    np.testing.assert_allclose(got, want, **tol)


def test_encode_w8a8_differs_from_w8a16(params):
    """The two modes really take different arithmetic (the int8 GEMM vs
    dequantize-then-matmul)."""
    _, pqp = _quantize_both(params, True, "encoder")
    mel = t(_mel(1, 3))
    a = pw.encode(pqp, PCFG.with_(encoder_q8_mode="w8a8"), mel)
    b = pw.encode(pqp, PCFG.with_(encoder_q8_mode="w8a16"), mel)
    assert not torch.equal(a, b)
    torch.testing.assert_close(a, b, rtol=0.1, atol=0.1)


def _decoder_inputs(B=2, P=3, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, CFG.vocab_size, (B, P)).astype(np.int32)
    xa = rng.standard_normal((B, CFG.max_source_positions, CFG.d_model)).astype(np.float32)
    return toks, xa


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_int8_decoder_step_matches_jax(params, fused):
    """quantize_decoder weights (w8a16 layers, int8 head): cross_kv,
    prefill and two decode steps against JAX."""
    jqp, pqp = _quantize_both(params, fused, "decoder")
    toks, xa = _decoder_inputs()
    jxk, jxv = jw.cross_kv(jqp, CFG, jnp.asarray(xa))
    pxk, pxv = pw.cross_kv(pqp, PCFG, t(xa))
    np.testing.assert_allclose(n(pxk), n(jxk), **TOL)
    np.testing.assert_allclose(n(pxv), n(jxv), **TOL)
    jl, jck, jcv = jw.decoder_prefill(jqp, CFG, jnp.asarray(toks), jxk, jxv)
    pl, pck, pcv = pw.decoder_prefill(pqp, PCFG, t(toks), pxk, pxv)
    np.testing.assert_allclose(n(pl), n(jl), rtol=5e-4, atol=5e-4)
    tok = np.asarray([7, 911], np.int32)
    for pos in (3, 4):
        jl, jck, jcv = jw.decoder_step(jqp, CFG, jnp.asarray(tok), jnp.int32(pos), jck, jcv, jxk, jxv)
        pl, pck, pcv = pw.decoder_step(pqp, PCFG, t(tok), pos, pck, pcv, pxk, pxv)
        np.testing.assert_allclose(n(pl), n(jl), rtol=5e-4, atol=5e-4)
        np.testing.assert_allclose(n(pck), n(jck), **TOL)
        tok = tok[::-1].copy()


# -- fault repairs ------------------------------------------------------------


def _bf16_pair(params):
    jp, _ = params
    jb = jax.tree.map(lambda a: a.astype(jnp.bfloat16), jp)
    return jb, port_params(jb, torch.bfloat16)


def _bf16(a):
    return np.asarray(a, np.float32).astype(ml_dtypes.bfloat16).astype(np.float32)


def test_bf16_logits_head_unrounded(params):
    """bf16 params: the logits head returns unrounded f32 logits, equal to
    JAX's f32-accumulated head far below bf16's step (~0.008 at |z| ~ 1);
    rounding them to bf16 would tie distinct logits."""
    jb, pb = _bf16_pair(params)
    x = _bf16(np.random.default_rng(4).standard_normal((4, CFG.d_model)))
    want = np.asarray(jw.logits_head(jb["decoder"], jnp.asarray(x, jnp.bfloat16)))
    got = pw.logits_head(pb["decoder"], t(x, torch.bfloat16))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(n(got), want, rtol=0, atol=1e-5)
    for g_row, w_row in zip(n(got), want):  # no ties made by a bf16 rounding
        assert len(np.unique(g_row)) == len(np.unique(w_row))


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_bf16_dense_and_qkv_round_once(params, fused):
    """bf16 dense / qkv_proj / ldense: f32 accumulation, f32 bias add, ONE
    rounding to bf16 -- equal to JAX's bf16 products but for the rare
    element whose f32 sum sits on a bf16 rounding boundary in one summation
    order.  (A bf16-rounded product plus a bias rounded again differs on
    several percent of the elements.)"""
    jb, pb = _bf16_pair(params)
    if fused:
        jb, pb = jload.fuse_qkv(jb), pload.fuse_qkv(pb)
    jlp = dict(jax.tree.map(lambda a: a[0], jb["decoder"]["layers"]))
    plp = pb["decoder"]["layers"].layer(0)
    rng = np.random.default_rng(7)
    for name in [k for k in plp if k.endswith("_b")]:  # init_params' biases are zeros
        b = _bf16(rng.standard_normal(tuple(plp[name].shape)))
        if name == "qkv_b":
            b[1] = 0.0  # whisper's k_proj has no bias
        jlp[name], plp[name] = jnp.asarray(b, jnp.bfloat16), t(b, torch.bfloat16)
    x = _bf16(rng.standard_normal((3, 7, CFG.d_model)))
    jx, px = jnp.asarray(x, jnp.bfloat16), t(x, torch.bfloat16)
    pairs = list(zip(pw.qkv_proj(plp, px), jw.qkv_proj(jlp, jx)))
    pairs.append((pw.dense(px, plp["o_w"], plp["o_b"]), jw.dense(jx, jlp["o_w"], jlp["o_b"])))
    pairs.append((pw.ldense(plp, "fc1_w", px, plp["fc1_b"]), jw.ldense(jlp, "fc1_w", jx, jlp["fc1_b"])))
    for got, want in pairs:
        assert got.dtype == torch.bfloat16
        g, w_ = n(got), np.asarray(want, np.float32)
        same = np.mean(g == w_)
        assert same > 0.995, same
        np.testing.assert_allclose(g, w_, rtol=2 ** -7, atol=1e-6)


def test_bf16_decoder_step_logits_match_jax(params):
    """bf16 decoder_step logits: f32 values off the bf16 grid, as JAX's
    are, and close to JAX's.  End to end the bound is hidden-state noise,
    not the head's precision: XLA's compiled bf16 program keeps some
    intermediates in f32 (its own jitted layer scan differs from its
    op-by-op layers by ~4e-3 in these logits), while the port rounds every
    op.  The head alone is held far below bf16's step in
    test_bf16_logits_head_unrounded."""
    jb, pb = _bf16_pair(params)
    toks, xa = _decoder_inputs(seed=6)
    xa = _bf16(xa)
    jxk, jxv = jw.cross_kv(jb, CFG, jnp.asarray(xa, jnp.bfloat16))
    pxk, pxv = pw.cross_kv(pb, PCFG, t(xa, torch.bfloat16))
    _, jck, jcv = jw.decoder_prefill(jb, CFG, jnp.asarray(toks), jxk, jxv)
    _, pck, pcv = pw.decoder_prefill(pb, PCFG, t(toks), pxk, pxv)
    tok = np.asarray([7, 911], np.int32)
    jl, _, _ = jw.decoder_step(jb, CFG, jnp.asarray(tok), jnp.int32(3), jck, jcv, jxk, jxv)
    pl, _, _ = pw.decoder_step(pb, PCFG, t(tok), 3, pck, pcv, pxk, pxv)
    assert pl.dtype == torch.float32
    got, want = n(pl), np.asarray(jl)
    on_grid = np.mean(_bf16(got) == got)
    assert on_grid < 0.05, on_grid  # rounded logits would all sit on the grid
    assert len(np.unique(got[0])) > 0.99 * CFG.vocab_size
    np.testing.assert_allclose(got, want, rtol=0, atol=0.02 * np.abs(want).max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_quantized_weight_carry_keeps_dtypes(params, dtype):
    """quantize_decoder(quantize_encoder(fuse_qkv(params))) crosses from
    JAX bit-equal: int8 codes stay int8, scales stay f32 in an f32 and a
    bf16 model, and the other weights take the model dtype."""
    jp, _ = params
    jtree = jquant.quantize_decoder(jquant.quantize_encoder(jload.fuse_qkv(jp)))
    pp = port_params(jtree, dtype)
    want = dict(_leaves(jax.tree.map(np.asarray, jtree)))
    got = dict(_tensor_leaves(pp))
    assert want.keys() == got.keys()
    for k, w in want.items():
        g = got[k]
        name = k.rsplit(".", 1)[-1]
        if w.dtype == np.int8:
            assert g.dtype == torch.int8, k
            np.testing.assert_array_equal(g.numpy(), w, err_msg=k)
        elif name.endswith("_s") or name == "s":
            assert g.dtype == torch.float32, k
            np.testing.assert_array_equal(g.numpy(), w, err_msg=k)
        else:
            assert g.dtype == dtype, k
            np.testing.assert_array_equal(n(g), n(torch.from_numpy(np.array(w)).to(dtype)), err_msg=k)
