"""The encoder's two Hopper kernels around their launches, on the CPU.

The wgmma flash attention (csrc/flash_encoder.cu) and the s8 wgmma GEMM
(csrc/q8a8.cu) run only on the card; what surrounds them is Python the CPU
reaches:

  - the K-major weight prep (model/quant.py::prep_encoder_q8_kernel): the
    same values as quantize_encoder's codes in a new tree (the caller's
    params untouched), one copy, the fused QKV's
    [in, 3*out] reshape a view with strides (1, in), and encode on the
    prepped params still matching the JAX package's encode;
  - the layout check the card path runs before a launch (codes that are
    not K-major are copied K-major for the call);
  - the bf16 epilogue (``out_dtype``): one rounding of the f32 result;
  - the kernels' plan functions at Whisper's widths and batch sizes, and
    the bf16 flash kernel's TMA operand check.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import tiny_config
from torch_port_helpers import n, port_cfg, port_params, t

from norma_tpu.model import load as jload
from norma_tpu.model import quant as jquant
from norma_tpu.model import whisper as jw
from norma_tpu_torch.model import load as pload
from norma_tpu_torch.model import quant as pquant
from norma_tpu_torch.model import whisper as pw
from norma_tpu_torch.ops import flash_encoder as fe
from norma_tpu_torch.ops import quant_matmul as pq

CFG = tiny_config()
PCFG = port_cfg(CFG)
SMEM_LIMIT = 232448  # bytes of shared memory one H100 block can use
WHISPER_WIDTHS = (384, 512, 768, 1024, 1280)  # tiny .. large d_model


@pytest.fixture(scope="module")
def params():
    jp = jload.init_params(CFG, seed=5)
    return jp, port_params(jp)


def _quantized(params, fused):
    jp, pp = params
    if fused:
        jp, pp = jload.fuse_qkv(jp), pload.fuse_qkv(pp)
    return jquant.quantize_encoder(jp), pquant.quantize_encoder(pp)


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_prep_keeps_codes_and_makes_them_kmajor(params, fused):
    _, pqp = _quantized(params, fused)
    layers = pqp["encoder"]["layers"]
    keys = [k + "_q" for k in pquant.ENCODER_W8_KEYS if k + "_q" in layers]
    before = {k: layers[k].clone() for k in keys}
    assert all(layers[k].is_contiguous() for k in keys)
    prepped = pquant.prep_encoder_q8_kernel(pqp)["encoder"]["layers"]
    assert len(keys) == (4 if fused else 6)
    for k in keys:
        assert layers[k].is_contiguous(), k  # the caller's stacks are untouched
        w = prepped[k]
        assert w.shape == before[k].shape and w.dtype == torch.int8
        assert torch.equal(w, before[k]), k
        assert w.stride(1) == 1, k  # the contraction axis is innermost
        for i in range(CFG.encoder_layers):
            wi = prepped.layer(i)[k]
            w2 = wi.reshape(wi.shape[0], -1)
            assert pq.is_kmajor(w2), (k, i, w2.stride())


def test_prepped_fused_qkv_reshape_copies_nothing(params):
    _, pqp = _quantized(params, True)
    pqp = pquant.prep_encoder_q8_kernel(pqp)
    w = pqp["encoder"]["layers"].layer(1)["qkv_w_q"]  # [in, 3, out]
    K, three, O = w.shape
    assert w.stride() == (1, O * K, K)
    flat = w.reshape(K, three * O)  # what q8a8_qkv hands the kernel
    assert flat.data_ptr() == w.data_ptr()
    assert flat.stride() == (1, K)
    assert pq.is_kmajor(flat)


def test_prep_is_one_copy_and_idempotent(params):
    _, pqp = _quantized(params, True)
    prepped = pquant.prep_encoder_q8_kernel(pqp)
    layers = prepped["encoder"]["layers"]
    ptrs = {k: layers[k].data_ptr() for k, _ in layers.items() if k.endswith("_q")}
    int8_bytes = sum(v.numel() for k, v in layers.items() if k.endswith("_q"))
    again = pquant.prep_encoder_q8_kernel(prepped)["encoder"]["layers"]
    assert {k: again[k].data_ptr() for k in ptrs} == ptrs
    # Each stack owns exactly its own bytes: no second copy hangs on.
    assert sum(layers[k].untyped_storage().nbytes() for k in ptrs) == int8_bytes


@pytest.mark.parametrize("mode", ["w8a8", "w8a8_pallas"])
@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_encode_prepped_matches_jax(params, mode, fused):
    """f32, jax_default_matmul_precision "highest" (tests/conftest.py), the
    tolerance of test_torch_quant.py::test_encode_quantized_matches_jax."""
    jqp, pqp = _quantized(params, fused)
    mel = np.random.default_rng(0).standard_normal(
        (2, CFG.num_mel_bins, 2 * CFG.max_source_positions)).astype(np.float32)
    plain = pw.encode(pqp, PCFG.with_(encoder_q8_mode=mode), t(mel))
    got = pw.encode(pquant.prep_encoder_q8_kernel(pqp), PCFG.with_(encoder_q8_mode=mode), t(mel))
    want = np.asarray(jw.encode(jqp, CFG.with_(encoder_q8_mode=mode), jnp.asarray(mel)))
    np.testing.assert_allclose(n(got), want, rtol=2e-2, atol=2e-2)
    assert torch.equal(got, plain)  # the layout changes no value


def test_kernel_weight_check_refuses_kn_contiguous():
    """The layout check the q8a8 wrapper runs before a launch: [K, N]-
    contiguous codes (and a strided view) are not K-major, so the card's
    wrapper copies them K-major for the call; kmajor_codes' copy is."""
    K, N = 256, 384
    w = torch.randint(-127, 128, (K, N), dtype=torch.int8)
    assert not pq.is_kmajor(w)
    wk = pq.kmajor_codes(w)
    assert torch.equal(wk, w) and wk.stride() == (1, K) and pq.is_kmajor(wk)
    assert not pq.is_kmajor(wk[:, ::2])


@pytest.mark.parametrize("bias", [False, True])
def test_q8a8_bf16_out_is_one_rounding(bias):
    rng = np.random.default_rng(1)
    M, K, N = 37, 128, 256
    xq = t(rng.integers(-127, 128, (M, K)).astype(np.int8))
    wq = pq.kmajor_codes(t(rng.integers(-127, 128, (K, N)).astype(np.int8)))
    xs = t(rng.uniform(0.001, 0.02, (M, 1)).astype(np.float32))
    ws = t(rng.uniform(0.001, 0.02, (N,)).astype(np.float32))
    b = t(rng.standard_normal(N).astype(np.float32)) if bias else None
    f32 = pq.q8a8_dense_torch(xq, xs, wq, ws, b)
    for fn in (pq.q8a8_dense_torch, pq.q8a8_dense):
        got = fn(xq, xs, wq, ws, b, out_dtype=torch.bfloat16)
        assert got.dtype == torch.bfloat16
        assert torch.equal(got, f32.to(torch.bfloat16))
    with pytest.raises(TypeError):
        pq.q8a8_dense(xq, xs, wq, ws, b, out_dtype=torch.float16)


def test_q8a8_qkv_bf16_slices_of_one_result():
    rng = np.random.default_rng(2)
    M, K, O = 20, 128, 128
    xq = t(rng.integers(-127, 128, (M, K)).astype(np.int8))
    xs = t(rng.uniform(0.001, 0.02, (M, 1)).astype(np.float32))
    w = pq.kmajor_codes(t(rng.integers(-127, 128, (1, K, 3, O)).astype(np.int8)), axis=1)[0]
    ws = t(rng.uniform(0.001, 0.02, (3, O)).astype(np.float32))
    b = t(rng.standard_normal((3, O)).astype(np.float32))
    q, k, v = pq.q8a8_qkv(xq, xs, w, ws, b, out_dtype=torch.bfloat16)
    f = pq.q8a8_qkv(xq, xs, w, ws, b)
    for got, want in zip((q, k, v), f):
        assert got.dtype == torch.bfloat16 and torch.equal(got, want.to(torch.bfloat16))
    assert q.stride() == (3 * O, 1) and k.data_ptr() == q.data_ptr() + 2 * O


@pytest.mark.parametrize("B", [1, 8])
@pytest.mark.parametrize("D", WHISPER_WIDTHS)
def test_q8a8_plan_valid_at_whisper_widths(D, B):
    M = B * 1500
    for K, N in ((D, 3 * D), (D, D), (D, 4 * D), (4 * D, D)):
        plan = pq.q8a8_plan(M, N, K)
        assert plan["bn"] in (64, 128) and plan["bm"] == 128 and plan["stages"] >= 2
        gx, gy = plan["grid"]
        assert gx * plan["bn"] == N and (gy - 1) * plan["bm"] < M <= gy * plan["bm"]
        assert plan["smem_bytes"] <= SMEM_LIMIT
        assert plan["threads"] == 288  # two consumer warpgroups + a producer warp
        if plan["bn"] == 64:  # narrower tiles only where 128-wide gave < 2 waves
            assert gy * (N // 128) < 2 * 132


def test_q8a8_plan_picks_narrow_tiles_at_b1():
    assert pq.q8a8_plan(1500, 1280, 1280)["bn"] == 64  # 120 tiles of 128 -> 240 of 64
    assert pq.q8a8_plan(12000, 1280, 1280)["bn"] == 128
    with pytest.raises(ValueError):
        pq.q8a8_plan(1500, 1280, 1000)
    with pytest.raises(ValueError):
        pq.q8a8_plan(1500, 300, 1280)


@pytest.mark.parametrize("B", [1, 8])
@pytest.mark.parametrize("D", WHISPER_WIDTHS)
def test_flash_plan_valid_at_whisper_widths(D, B):
    H, T = D // 64, 1500
    bf = fe.flash_plan(B, T, H, torch.bfloat16)
    assert bf["kernel"] == "wgmma" and bf["threads"] == 288 and bf["stages"] >= 2
    assert bf["grid"] == (12, H, B) and bf["grid"][0] * bf["block_q"] >= T
    assert bf["smem_bytes"] <= SMEM_LIMIT
    f32 = fe.flash_plan(B, T, H, torch.float32)
    assert f32["kernel"] == "cuda_cores" and f32["grid"] == (24, H, B)
    assert f32["smem_bytes"] <= SMEM_LIMIT
    with pytest.raises(TypeError):
        fe.flash_plan(B, T, H, torch.float16)


def test_flash_tma_operand_check():
    B, T, D = 2, 37, 128
    qkv = torch.zeros((B, T, 3, D), dtype=torch.bfloat16)
    for x in (qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2], torch.zeros((1, T, D), dtype=torch.bfloat16)):
        fe.check_tma_operand(x, "q")
    flat = torch.zeros(B * T * D + 1, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="16-byte"):
        fe.check_tma_operand(flat[1:].view(B, T, D), "q")  # pointer off by 2 bytes
    odd = torch.zeros((B, T, D + 4), dtype=torch.bfloat16)[..., :D]
    with pytest.raises(ValueError, match="16-byte"):
        fe.check_tma_operand(odd, "k")  # row stride 264 bytes
