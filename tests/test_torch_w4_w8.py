"""The port's w4a16 / w8a16 products and the int4 logits head vs the JAX
package, on the CPU (where each wrapper runs its plain version).

  - quantize_blockwise_int4 codes and scales are bit-equal to JAX's, and
    unpack_int4 round-trips them;
  - the plain w4 product matches w4_matmul_jnp (f32 summation order: 1e-5
    of max|y|) and w4_matmul_pallas in interpret mode at JAX's own kernel
    tolerance (tests/test_quant.py: the TPU kernel pre-scales in bf16);
  - the plain w8 products match w8_matmul_jnp and w8_matmul_pallas;
  - quantize_decoder(logits="int4") and the head tiers drop each other
    (fault: a leftover int4 head would win logits_head's dispatch);
  - the weight carry keeps the int4 head's codes int8 and scales bf16;
  - logits_head with q4 and an int4-head engine match JAX at f32;
  - the kernel launch plans cover the contraction and, for w8, read the
    codes once for up to 32 rows.
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
from norma_tpu.model import quant as jquant
from norma_tpu.model import whisper as jw
from norma_tpu.ops import quant_matmul as jq
from norma_tpu_torch.decode import DecodeEngine
from norma_tpu_torch.model import load as pload
from norma_tpu_torch.model import quant as pquant
from norma_tpu_torch.model import whisper as pw
from norma_tpu_torch.ops import quant_matmul as pq

CFG = tiny_config()
PCFG = port_cfg(CFG)


def _w(IN, OUT, seed):
    w = np.random.default_rng(seed).standard_normal((IN, OUT)).astype(np.float32) * 0.05
    w[:, 3] = 0.0  # an all-zero column: scale 1, codes 0
    return w


@pytest.mark.parametrize("block", [32, 64])
def test_quantize_blockwise_int4_bit_equal(block):
    w = _w(128, 300, block)
    jcodes, jscale = jq.quantize_blockwise_int4(w, block=block)
    codes, scale = pq.quantize_blockwise_int4(t(w), block=block)
    assert codes.dtype == torch.int8 and scale.dtype == torch.bfloat16
    assert tuple(codes.shape) == (64, 300) and tuple(scale.shape) == (128 // block, 300)
    np.testing.assert_array_equal(n(codes), np.asarray(jcodes))
    np.testing.assert_array_equal(n(scale), np.asarray(jscale, np.float32))
    unpacked = pq.unpack_int4(codes)
    np.testing.assert_array_equal(n(unpacked), np.asarray(jq.unpack_int4(jcodes)))
    assert int(unpacked.min()) >= -7 and int(unpacked.max()) <= 7
    # Repacking the unpacked codes gives the same bytes (the round trip).
    q = unpacked.to(torch.int32)
    repacked = ((q[:64] & 0xF) | ((q[64:] & 0xF) << 4)).to(torch.uint8).view(torch.int8)
    assert torch.equal(repacked, codes)


@pytest.mark.parametrize("x_dtype", ["f32", "bf16"])
@pytest.mark.parametrize("block", [32, 64])
def test_w4_matmul_matches_jax(block, x_dtype):
    w = _w(128, 700, 3)
    jcodes, jscale = jq.quantize_blockwise_int4(w, block=block)
    x = np.random.default_rng(4).standard_normal((6, 128)).astype(np.float32)
    xt = t(x, torch.bfloat16 if x_dtype == "bf16" else None)
    xj = jnp.asarray(n(xt))  # the same values (bf16 widened exactly)
    codes, scale = t(np.asarray(jcodes)), pq.quantize_blockwise_int4(t(w), block=block)[1]
    got = n(pq.w4_matmul(xt, codes, scale))
    assert np.array_equal(got, n(pq.w4_matmul_torch(xt, codes, scale)))
    want = np.asarray(jq.w4_matmul_jnp(xj, jcodes, jscale))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())
    kernel = np.asarray(jq.w4_matmul_pallas(xj, jcodes, jscale, block_out=256, interpret=True))
    np.testing.assert_allclose(got, kernel, rtol=2e-2, atol=0.15)
    before = pq.w4_matmul.launches
    pq.w4_matmul(xt, codes, scale)
    assert pq.w4_matmul.launches == before  # CPU tensors launch no kernel


@pytest.mark.parametrize("x_dtype", ["f32", "bf16"])
def test_w8_products_match_jax(x_dtype):
    """w8_matmul (bf16 x, the head's contract) against w8_matmul_jnp and
    w8_matmul_pallas (out = 700 pads to the kernel's block); w8_dense
    keeps x in its dtype (the decoder layers' ldense)."""
    w = _w(64, 700, 5)
    jcodes, jscale = jq.quantize_per_channel(w)
    x = np.random.default_rng(6).standard_normal((5, 64)).astype(np.float32)
    codes, scale = t(np.asarray(jcodes)), t(np.asarray(jscale))
    xt = t(x, torch.bfloat16 if x_dtype == "bf16" else None)
    want = np.asarray(jq.w8_matmul_jnp(jnp.asarray(x), jcodes, jscale))
    kernel = np.asarray(jq.w8_matmul_pallas(jnp.asarray(x), jcodes, jscale, block_out=256, interpret=True))
    for got in (pq.w8_matmul(xt, codes, scale), pq.w8_matmul_torch(xt, codes, scale)):
        assert got.dtype == torch.float32
        np.testing.assert_allclose(n(got), want, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(n(got), kernel, rtol=1e-5, atol=1e-5)
    dense = n(pq.w8_dense(xt.reshape(5, 1, 64), codes, scale))[:, 0]
    exact = (n(xt).astype(np.float64) @ np.asarray(jcodes, np.float64)) * np.asarray(jscale, np.float64)
    np.testing.assert_allclose(dense, exact, rtol=1e-5, atol=1e-5)
    before = pq.w8_matmul.launches
    pq.w8_dense(xt, codes, scale)
    assert pq.w8_matmul.launches == before


def test_wrappers_reject_bad_inputs():
    codes = torch.zeros((32, 16), dtype=torch.int8)
    with pytest.raises(TypeError):
        pq.w8_dense(torch.zeros(2, 32), codes.float(), torch.ones(16))
    with pytest.raises(ValueError):
        pq.w8_dense(torch.zeros(2, 31), codes, torch.ones(16))
    with pytest.raises(ValueError, match="device"):
        pq.w8_dense(torch.zeros(2, 32, device="meta"), codes.to("meta"), torch.ones(16, device="meta"))
    with pytest.raises(ValueError):
        pq.w4_matmul(torch.zeros(2, 64), codes, torch.ones((3, 16), dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="device"):
        pq.w4_matmul(torch.zeros(2, 64, device="meta"), codes.to("meta"),
                     torch.ones((1, 16), dtype=torch.bfloat16, device="meta"))


@pytest.mark.parametrize("M,N,K", [(1, 51866, 1280), (6, 3840, 1280), (8, 1280, 5120), (48, 51866, 1280),
                                   (200, 5120, 1280), (12000, 1280, 5120), (3, 700, 64), (16, 1280, 1280)])
def test_w8_plan_covers_the_contraction(M, N, K):
    plan = pq.w8_plan(M, N, K)
    rows = 8 * plan["rt"]
    assert plan["rt"] in (1, 2, 4) and plan["row_blocks"] * rows >= M > (plan["row_blocks"] - 1) * rows
    assert plan["tiles"] * 128 >= N > (plan["tiles"] - 1) * 128
    c = plan["cluster"]
    nst = -(-K // 32)  # stages of 32 rows, shared evenly by the cluster's 4 * c warps
    assert c in (1, 2, 4, 8) and (c == 1 or 4 * c <= nst)  # every warp has a stage
    if c < 8 and 8 * c <= nst:  # it stopped growing because twice the blocks pass one per SM
        assert plan["row_blocks"] * plan["tiles"] * 2 * c > 132
    if (M, N, K) in ((6, 3840, 1280), (16, 1280, 1280), (1, 51866, 1280)):
        assert c == {3840: 4, 1280: 8, 51866: 1}[N]  # the fastest sizes on the H100 (PERF.md)
    if M <= 32:
        assert plan["row_blocks"] == 1  # every code byte read once for all rows


@pytest.mark.parametrize("K,block", [(1280, 64), (1280, 32), (256, 64), (5120, 64)])
def test_w4_plan_one_warp_per_packed_block(K, block):
    splits, warps = pq.w4_plan(K, block)
    assert splits * warps == K // 2 // block and 1 <= warps <= 8
    assert 2 * 2 * warps * block <= 8192  # both halves of 2 x rows fit the x tile


@pytest.fixture(scope="module")
def params():
    jp = jload.init_params(CFG, seed=2)
    return jp, port_params(jp)


def test_quantize_decoder_int4_head(params):
    """logits="int4" leaves an int4 head and no int8 one, like JAX's, with
    the same codes and scales."""
    jp, pp = params
    jt = jquant.quantize_decoder(jp, logits="int4")["decoder"]
    pt = pquant.quantize_decoder(pp, logits="int4")["decoder"]
    assert "tok_emb_q4" in pt and "tok_emb_q8" not in pt
    np.testing.assert_array_equal(n(pt["tok_emb_q4"]["q"]), np.asarray(jt["tok_emb_q4"]["q"]))
    np.testing.assert_array_equal(n(pt["tok_emb_q4"]["s"]), np.asarray(jt["tok_emb_q4"]["s"], np.float32))
    assert pt["tok_emb_q4"]["s"].dtype == torch.bfloat16


def test_head_codes_are_contiguous(params):
    """Fault: the heads quantize the transposed embedding view; their codes
    and scales must come out in the layout the kernels read, or the kernels
    (which refuse other strides) cannot take them: the int4 head
    contiguous, the int8 head's code rows 16-byte aligned (unit column
    stride, a row pitch of round_up(V, 16)) with the same values."""
    _, pp = params
    head = pquant.quantize_logits_head_int4(pp)["decoder"]["tok_emb_q4"]
    assert head["q"].is_contiguous() and head["s"].is_contiguous()
    head = pquant.quantize_logits_head(pp)["decoder"]["tok_emb_q8"]
    D, V = head["q"].shape
    assert head["q"].stride() == (-(-V // 16) * 16, 1) and head["s"].is_contiguous()
    q, s = pq.quantize_per_channel(pp["decoder"]["tok_emb"].t())
    assert torch.equal(head["q"], q) and torch.equal(head["s"], s)
    assert pq.pitched_codes(head["q"]) is head["q"]


def test_head_tiers_drop_each_other(params):
    """Fault: quantize_logits_head on params with an int4 head must drop it
    (logits_head dispatches tok_emb_q4 first, so a leftover one would
    silently override the int8 request); and the int4 tier drops q8."""
    _, pp = params
    q4 = pquant.quantize_logits_head_int4(pp)
    q8 = pquant.quantize_logits_head(q4)["decoder"]
    assert "tok_emb_q8" in q8 and "tok_emb_q4" not in q8
    back = pquant.quantize_logits_head_int4(pquant.quantize_logits_head(pp))["decoder"]
    assert "tok_emb_q4" in back and "tok_emb_q8" not in back
    x = t(np.random.default_rng(8).standard_normal((2, CFG.d_model)).astype(np.float32))
    np.testing.assert_array_equal(n(pw.logits_head(q8, x)), n(pw.logits_head(pquant.quantize_logits_head(pp)["decoder"], x)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_int4_head_carry_keeps_dtypes(params, dtype):
    """Fault: the carry keeps the int4 head's codes int8 and its scales
    bf16 (the JAX grid), bit-equal, in an f32 and a bf16 model; the int8
    layers' scales stay f32."""
    jp, _ = params
    jtree = jquant.quantize_decoder(jload.fuse_qkv(jp), logits="int4")
    pp = port_params(jtree, dtype)
    head = pp["decoder"]["tok_emb_q4"]
    assert head["q"].dtype == torch.int8 and head["s"].dtype == torch.bfloat16
    np.testing.assert_array_equal(head["q"].numpy(), np.asarray(jtree["decoder"]["tok_emb_q4"]["q"]))
    np.testing.assert_array_equal(n(head["s"]), np.asarray(jtree["decoder"]["tok_emb_q4"]["s"], np.float32))
    assert pp["decoder"]["layers"]["fc1_w_s"].dtype == torch.float32
    assert pp["decoder"]["tok_emb"].dtype == dtype
    # ml_dtypes' bfloat16 arrays (np.asarray of a JAX bf16 leaf) carry too.
    raw = pload.params_from_numpy({"decoder": {"tok_emb_q4": {
        "q": np.asarray(jtree["decoder"]["tok_emb_q4"]["q"]), "s": np.asarray(jtree["decoder"]["tok_emb_q4"]["s"])}}})
    assert torch.equal(raw["decoder"]["tok_emb_q4"]["s"], head["s"])


def test_logits_head_q4_matches_jax(params):
    jp, _ = params
    jh = jquant.quantize_logits_head_int4(jp)["decoder"]
    ph = port_params(jquant.quantize_logits_head_int4(jp))["decoder"]
    x = np.random.default_rng(9).standard_normal((2, 3, CFG.d_model)).astype(np.float32)
    want = np.asarray(jw.logits_head(jh, jnp.asarray(x)))
    got = pw.logits_head(ph, t(x))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(n(got), want, rtol=0, atol=1e-5 * np.abs(want).max())


def test_int4_head_engine_matches_jax():
    """An engine with int8 layers and the int4 head gives JAX's greedy
    tokens on both ladder arms (f32, texty weights)."""
    cfg = texty_config()
    jp = jquant.quantize_decoder(confident_params(cfg), logits="int4")
    je = JaxEngine(jp, cfg, TEST_ST, language_token_ids=TEST_LANG_IDS)
    pe = DecodeEngine(port_params(jp), port_cfg(cfg), port_st(TEST_ST), language_token_ids=TEST_LANG_IDS)
    rng = np.random.default_rng(10)
    n_frames = 2 * cfg.max_source_positions
    for B in (1, 4):
        audio = np.stack([prepare_audio((0.1 * rng.standard_normal(12_000)).astype(np.float32), n_frames=n_frames)
                          for _ in range(B)])
        jdrs, _ = je.transcribe_window(audio, [TEST_LANG_IDS[0]] * B, seed=0)
        pdrs, _ = pe.transcribe_window(audio, [TEST_LANG_IDS[0]] * B, seed=0)
        for jd, pd in zip(jdrs, pdrs):
            assert jd is not None and pd is not None
            assert pd.tokens == jd.tokens and len(pd.tokens) > 10
