"""The port's flash encoder attention (ops/flash_encoder.py) on the CPU.

The stock Pallas TPU flash-attention kernel the JAX package wraps cannot
run on the CPU, so its twin -- ``norma_tpu/model/whisper.py::attention``,
the exact form the kernel replaces -- is the oracle: the plain version
behind the port's wrapper agrees with it in f32 to 2e-5 (the q/k scaling
split and summation order differ).  Then encode with
``encoder_attn_impl="jax_flash"`` (and the other selectors) against the
plain encode and against JAX's encode.
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
from norma_tpu_torch.model import whisper as pw
from norma_tpu_torch.ops import flash_encoder as fe

FTOL = dict(rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("T", [37, 150, 1499])
@pytest.mark.parametrize("H", [2, 4])
def test_flash_plain_matches_jax_attention(T, H):
    rng = np.random.default_rng(T + H)
    B, D = (1, 64) if T > 1000 else (2, 64)
    q, k, v = (rng.standard_normal((B, T, D)).astype(np.float32) for _ in range(3))
    want = np.asarray(jw.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), H))
    before = fe.flash_self_attention.launches
    got = fe.flash_self_attention(t(q), t(k), t(v), H)
    assert fe.flash_self_attention.launches == before  # CPU: no kernel
    assert got.dtype == torch.float32 and got.is_contiguous()
    np.testing.assert_allclose(n(got), want, **FTOL)


def test_flash_reads_fused_qkv_slices_in_place():
    """q/k/v as strided slices of one [B, T, 3, D] tensor, as the fused
    QKV projection produces them."""
    rng = np.random.default_rng(2)
    qkv = t(rng.standard_normal((2, 37, 3, 64)).astype(np.float32))
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    assert q.stride(1) == 3 * 64
    got = fe.flash_self_attention(q, k, v, 2)
    want = fe.flash_attention_torch(q.contiguous(), k.contiguous(), v.contiguous(), 2)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_flash_bf16_rounds_p_to_the_input_dtype():
    """bf16 inputs: f32 logits and softmax, p rounded to bf16 for PV, f32
    accumulation (the stock kernel's rounding points): within bf16 output
    rounding of the f32 computation over the same bf16 values."""
    rng = np.random.default_rng(3)
    q, k, v = (t(rng.standard_normal((1, 37, 64)).astype(np.float32), torch.bfloat16) for _ in range(3))
    got = fe.flash_self_attention(q, k, v, 2)
    assert got.dtype == torch.bfloat16
    ref = fe.flash_attention_torch(q.float(), k.float(), v.float(), 2)
    torch.testing.assert_close(got.float(), ref, rtol=2e-2, atol=2e-2)


def test_flash_rejects_bad_inputs():
    x = torch.zeros(1, 8, 64)
    with pytest.raises(ValueError):
        fe.flash_self_attention(x, x[:, :4], x, 2)
    with pytest.raises(TypeError):
        fe.flash_self_attention(x, x.double(), x, 2)
    with pytest.raises(ValueError, match="divisible"):
        fe.flash_self_attention(x, x, x, 3)
    m = x.to("meta")
    with pytest.raises(ValueError, match="device"):
        fe.flash_self_attention(m, m, m, 2)


CFG = tiny_config()
PCFG = port_cfg(CFG)


@pytest.fixture(scope="module")
def params():
    jp = jload.fuse_qkv(jload.init_params(CFG, seed=2))
    return jp, port_params(jp)


def _mel(B=2, seed=0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((B, CFG.num_mel_bins, 2 * CFG.max_source_positions)).astype(np.float32)


@pytest.mark.parametrize(
    "knobs",
    [dict(encoder_attn_impl="jax_flash"), dict(encoder_attn_impl="flash"), dict(flash_attention=True)],
    ids=["jax_flash", "flash", "flash_attention"],
)
def test_encode_flash_matches_plain_and_jax(params, knobs, monkeypatch):
    jp, pp = params
    mel = _mel()
    calls = []
    orig = pw.flash_self_attention
    monkeypatch.setattr(pw, "flash_self_attention", lambda *a: calls.append(1) or orig(*a))
    got = n(pw.encode(pp, PCFG.with_(**knobs), t(mel)))
    assert len(calls) == CFG.encoder_layers  # every layer took the flash path
    plain = n(pw.encode(pp, PCFG, t(mel)))
    want = np.asarray(jw.encode(jp, CFG, jnp.asarray(mel)))  # JAX runs "xla" off the TPU
    np.testing.assert_allclose(got, plain, **FTOL)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("impl", ["xla", "auto", "chunked"])
def test_encode_plain_impls_take_plain_attention(params, impl, monkeypatch):
    _, pp = params
    monkeypatch.setattr(pw, "flash_self_attention", lambda *a: pytest.fail("flash kernel called"))
    pw.encode(pp, PCFG.with_(encoder_attn_impl=impl), t(_mel(1)))


def test_encode_flash_with_w8a8(params):
    """The serving encoder: flash attention over w8a8 projections, against
    JAX's w8a8 encode (plain attention off the TPU).  The attention's f32
    rounding differs, so activation codes on a rounding boundary flip
    (one int8 step) and the difference carries through the later layers:
    2e-2 at unit-scale features."""
    jp, pp = params
    jq = jquant.quantize_encoder(jp)
    pq = port_params(jq)
    mel = _mel(1, 4)
    want = np.asarray(jw.encode(jq, CFG.with_(encoder_q8_mode="w8a8"), jnp.asarray(mel)))
    got = n(pw.encode(pq, PCFG.with_(encoder_attn_impl="jax_flash", encoder_q8_mode="w8a8"), t(mel)))
    np.testing.assert_allclose(got, want, rtol=2e-2, atol=2e-2)
