"""Port self-attention decode (plain version) vs the JAX Pallas kernel run
in interpret mode, on the same inputs.

Tolerances: 1e-5 in f32 (summation order only); 2e-2 in bf16 (both sides
round q and the softmax weights to bf16, at different points of their
reductions).  The written cache row must be bit-equal, every other row
untouched.  The CUDA kernel is held against this plain version on the card
by chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import n, t

from norma_tpu.ops.self_decode import self_attention_decode as jax_self_decode
from norma_tpu_torch.ops import self_decode as sd

H = 4  # dh = 64, the whisper head size


def _mk(seed, L=3, B=4, T=32, D=256):
    rng = np.random.default_rng(seed)
    r = lambda *s: (rng.standard_normal(s) * 0.5).astype(np.float32)
    return r(L, B, T, D), r(L, B, T, D), r(B, 1, D), r(B, 1, D), r(B, 1, D)


def _jax(q, kn, vn, ck, cv, li, pos, dtype):
    jd = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    a, ck2, cv2 = jax_self_decode(
        jnp.asarray(q, jd), jnp.asarray(kn, jd), jnp.asarray(vn, jd),
        jnp.asarray(ck, jd), jnp.asarray(cv, jd), jnp.int32(li), jnp.int32(pos), H,
        interpret=True,
    )
    return n(a), n(ck2), n(cv2)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 2e-2)], ids=["f32", "bf16"])
@pytest.mark.parametrize("pos", [0, 7, 31])
def test_plain_matches_jax_kernel(dtype, tol, pos):
    ck, cv, q, kn, vn = _mk(pos)
    ja, jck, jcv = _jax(q, kn, vn, ck, cv, 1, pos, dtype)
    pck, pcv = t(ck, dtype), t(cv, dtype)
    before_k, before_v = pck.clone(), pcv.clone()
    a, ck2, cv2 = sd.self_attention_decode(t(q, dtype), t(kn, dtype), t(vn, dtype), pck, pcv, 1, pos, H)
    assert ck2 is pck and cv2 is pcv and a.dtype == dtype
    np.testing.assert_allclose(n(a), ja, atol=tol, rtol=tol)
    # The written row is bit-equal to JAX's, and nothing else moved.
    np.testing.assert_array_equal(n(pck), jck)
    np.testing.assert_array_equal(n(pcv), jcv)
    before_k[1, :, pos], before_v[1, :, pos] = pck[1, :, pos], pcv[1, :, pos]
    assert torch.equal(pck, before_k) and torch.equal(pcv, before_v)


def test_stale_rows_beyond_pos_are_never_read():
    ck, cv, q, kn, vn = _mk(3)
    pos = 4
    clean = sd.self_attention_decode(t(q), t(kn), t(vn), t(ck), t(cv), 0, pos, H)[0]
    ck[0, :, pos + 1:] = 50.0  # huge stale logits if read
    cv[0, :, pos + 1:] = np.nan
    dirty = sd.self_attention_decode(t(q), t(kn), t(vn), t(ck), t(cv), 0, pos, H)[0]
    assert torch.equal(clean, dirty)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_bucket_view_matches_cropped_copy(dtype):
    """A crop cache[:, :, :S] of one allocation (non-contiguous in L and B)
    gives the JAX kernel's result on the cropped copy, and the row lands
    in the full allocation."""
    ck, cv, q, kn, vn = _mk(5, T=48)
    S, pos, li = 16, 9, 2
    ja, jck, _ = _jax(q, kn, vn, ck[:, :, :S], cv[:, :, :S], li, pos, dtype)
    full_k, full_v = t(ck, dtype), t(cv, dtype)
    view_k, view_v = full_k[:, :, :S], full_v[:, :, :S]
    assert not view_k.is_contiguous()
    a, _, _ = sd.self_attention_decode(t(q, dtype), t(kn, dtype), t(vn, dtype), view_k, view_v, li, pos, H)
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    np.testing.assert_allclose(n(a), ja, atol=tol, rtol=tol)
    np.testing.assert_array_equal(n(full_k)[:, :, :S], jck)
    np.testing.assert_array_equal(n(full_k)[:, :, S:], n(t(ck, dtype))[:, :, S:])


def test_strided_qkv_rows():
    """q/k/v sliced out of a fused [B, 1, 3, D] projection are taken as views."""
    ck, cv, q, kn, vn = _mk(6)
    fused = t(np.stack([q, kn, vn], axis=2))  # [B, 1, 3, D]
    qv, kv, vv = fused[..., 0, :], fused[..., 1, :], fused[..., 2, :]
    assert not qv.is_contiguous()
    a1 = sd.self_attention_decode(qv, kv, vv, t(ck), t(cv), 0, 5, H)[0]
    a2 = sd.self_attention_decode(t(q), t(kn), t(vn), t(ck), t(cv), 0, 5, H)[0]
    assert torch.equal(a1, a2)


def test_wrapper_rejects_bad_inputs():
    ck, cv, q, kn, vn = _mk(7)
    args = lambda **kw: {**dict(q=t(q), k_new=t(kn), v_new=t(vn), cache_k=t(ck), cache_v=t(cv),
                                li=0, pos=3, n_heads=H), **kw}
    with pytest.raises(TypeError, match="dtype"):
        sd.self_attention_decode(**args(q=t(q, torch.float16)))
    with pytest.raises(TypeError, match="dtype"):
        sd.self_attention_decode(**args(cache_k=t(ck, torch.bfloat16)))
    with pytest.raises(ValueError, match="position"):
        sd.self_attention_decode(**args(pos=32))
    with pytest.raises(ValueError, match="layer"):
        sd.self_attention_decode(**args(li=3))
    with pytest.raises(ValueError, match=r"\[4, 1, 256\]"):
        sd.self_attention_decode(**args(q=t(q)[:2]))
    with pytest.raises(ValueError, match="contiguous"):
        sd.self_attention_decode(**args(cache_k=t(ck).transpose(2, 3).contiguous().transpose(2, 3)))
    with pytest.raises(ValueError, match="device"):
        sd.self_attention_decode(**args(cache_k=t(ck).to("meta"), cache_v=t(cv).to("meta"),
                                        q=t(q).to("meta"), k_new=t(kn).to("meta"), v_new=t(vn).to("meta")))
    assert sd.self_attention_decode.launches == 0  # the CPU path launches nothing
