"""The port's quantized cross-attention (ops/paged_cross.py and the
quantized paths of model/whisper.py) vs the JAX package, on the CPU.

The plain version behind the kernel wrapper is held against the TPU
kernels themselves, run in Pallas interpret mode
(``cross_attention_q8_kernel_stacked`` / ``cross_attention_q8_kernel``),
int8 and int4, at G in {1, 3} and B in {1, 4}: the same codes and scales
go through both (the JAX quantizers' output, converted), each side building
its own kernel layout.  Tolerance 1e-6: both round q' and p to bf16 at the
same points, so only f32 summation order differs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import tiny_config
from torch_port_helpers import n, port_cfg, port_params, t

from norma_tpu.model import load as jload
from norma_tpu.model import whisper as jw
from norma_tpu.ops import paged_cross as jpc
from norma_tpu_torch.model import whisper as pw
from norma_tpu_torch.ops import paged_cross as pc

L, Ta, D, H = 3, 16, 32, 4
KTOL = dict(rtol=1e-6, atol=1e-6)


def _xkv(B, seed, int4):
    rng = np.random.default_rng(seed)
    xk = jnp.asarray(rng.standard_normal((L, B, Ta, D)), jnp.float32)
    xv = jnp.asarray(rng.standard_normal((L, B, Ta, D)), jnp.float32)
    jkq, jvq = (jw.quantize_cross_kv4 if int4 else jw.quantize_cross_kv)(xk, xv)
    pkq, pvq = ({k: t(np.asarray(v)) for k, v in d.items()} for d in (jkq, jvq))
    if int4:
        return jpc.prep_cross_kv_kernel4(jkq, jvq, H), pc.prep_cross_kv_kernel4(pkq, pvq, H), (xk, xv)
    return jpc.prep_cross_kv_kernel(jkq, jvq, H), pc.prep_cross_kv_kernel(pkq, pvq, H), (xk, xv)


@pytest.mark.parametrize("int4", [False, True], ids=["int8", "int4"])
@pytest.mark.parametrize("B", [1, 4])
@pytest.mark.parametrize("G", [1, 3])
def test_stacked_matches_pallas_interpret(G, B, int4):
    (jkp, jvp), (pkp, pvp), _ = _xkv(B, 10 * G + B, int4)
    q = np.random.default_rng(G + B).standard_normal((G * B, 1, D)).astype(np.float32)
    before = pc.cross_attention_q8_kernel_stacked.launches
    for li in range(L):
        want = np.asarray(jpc.cross_attention_q8_kernel_stacked(
            jnp.asarray(q), jkp, jvp, jnp.int32(li), H, n_groups=G, interpret=True))
        got = pc.cross_attention_q8_kernel_stacked(t(q), pkp, pvp, li, H, G)
        assert got.dtype == torch.float32 and tuple(got.shape) == (G * B, 1, D)
        np.testing.assert_allclose(n(got), want, **KTOL)
        np.testing.assert_allclose(n(pc.cross_attention_decode_torch(t(q), pkp, pvp, li, H, G)), want, **KTOL)
    assert pc.cross_attention_q8_kernel_stacked.launches == before  # CPU: no kernel


@pytest.mark.parametrize("B", [1, 4])
@pytest.mark.parametrize("G", [1, 3])
def test_per_layer_matches_pallas_interpret(G, B):
    (jkp, jvp), (pkp, pvp), _ = _xkv(B, 7 * G + B, False)
    q = np.random.default_rng(3 * G + B).standard_normal((G * B, 1, D)).astype(np.float32)
    for li in range(L):
        jk1 = {k: v[li] for k, v in jkp.items()}
        jv1 = {k: v[li] for k, v in jvp.items()}
        want = np.asarray(jpc.cross_attention_q8_kernel(jnp.asarray(q), jk1, jv1, H, n_groups=G, interpret=True))
        pk1 = {k: v[li] for k, v in pkp.items()}
        pv1 = {k: v[li] for k, v in pvp.items()}
        got = pc.cross_attention_q8_kernel(t(q), pk1, pv1, H, G)
        np.testing.assert_allclose(n(got), want, **KTOL)


def test_int4_pack_round_trip_and_layout():
    _, (pkp, _), (xk, xv) = _xkv(2, 5, True)
    codes = pkp["codes4"]
    assert codes.dtype == torch.int8 and tuple(codes.shape) == (L, 2, H, Ta // 2, D // H)
    kq, _ = jw.quantize_cross_kv4(xk, xv)
    ref = t(np.asarray(kq["q"])).reshape(L, 2, Ta, H, D // H).permute(0, 1, 3, 2, 4)
    assert torch.equal(pc.unpack_int4(codes), ref)
    assert int(ref.abs().max()) <= 7


def test_attention_cross_q8_matches_jax():
    """The plain per-channel form (cross_kv_impl "einsum"), grouped."""
    rng = np.random.default_rng(9)
    B, G = 2, 3
    xk = jnp.asarray(rng.standard_normal((1, B, Ta, D)), jnp.float32)
    xv = jnp.asarray(rng.standard_normal((1, B, Ta, D)), jnp.float32)
    kq, vq = jw.quantize_cross_kv(xk, xv)
    pkq, pvq = pw.quantize_cross_kv(t(np.asarray(xk)), t(np.asarray(xv)))
    for a, b in ((pkq, kq), (pvq, vq)):  # the quantizer is bit-equal too
        np.testing.assert_array_equal(n(a["q"]), np.asarray(b["q"]))
        np.testing.assert_array_equal(n(a["s"]), np.asarray(b["s"]))
    q = rng.standard_normal((G * B, 1, D)).astype(np.float32)
    j1 = {k: v[0] for k, v in kq.items()}
    jv1 = {k: v[0] for k, v in vq.items()}
    want = np.asarray(jw.attention_cross_q8(jnp.asarray(q), j1, jv1, H, G))
    got = pw.attention_cross_q8(t(q), {k: v[0] for k, v in pkq.items()}, {k: v[0] for k, v in pvq.items()}, H, G)
    np.testing.assert_allclose(n(got), want, rtol=1e-5, atol=1e-6)


def test_kernel_wrapper_rejects_bad_inputs():
    _, (pkp, pvp), _ = _xkv(2, 1, False)
    with pytest.raises(ValueError, match="single-query"):
        pc.cross_attention_q8_kernel_stacked(torch.zeros(2, 2, D), pkp, pvp, 0, H)
    with pytest.raises(ValueError, match="layer"):
        pc.cross_attention_q8_kernel_stacked(torch.zeros(2, 1, D), pkp, pvp, L, H)
    with pytest.raises(ValueError, match="heads"):
        pc.cross_attention_q8_kernel_stacked(torch.zeros(2, 1, D), pkp, pvp, 0, H * 2)
    meta = {k: v.to("meta") for k, v in pkp.items()}
    with pytest.raises(ValueError, match="device"):
        pc.cross_attention_q8_kernel_stacked(
            torch.zeros(2, 1, D, device="meta"), meta, {k: v.to("meta") for k, v in pvp.items()}, 0, H
        )


CFG = tiny_config()
PCFG = port_cfg(CFG)


@pytest.fixture(scope="module")
def model_params():
    jp = jload.fuse_qkv(jload.init_params(CFG, seed=4))
    return jp, port_params(jp)


@pytest.mark.parametrize("n_rungs", [1, 3])
@pytest.mark.parametrize("int4", [False, True], ids=["int8", "int4"])
def test_decoder_step_over_kernel_layout_matches_jax(model_params, n_rungs, int4):
    """decoder_step over the kernel layout (stacked, layer by index) vs
    JAX decoder_step over prep_cross_kv_kernel* output (interpret mode):
    two steps, logits and caches."""
    jp, pp = model_params
    rng = np.random.default_rng(11 + n_rungs)
    B = 2
    toks = rng.integers(0, CFG.vocab_size, (B, 3)).astype(np.int32)
    xa = rng.standard_normal((B, CFG.max_source_positions, CFG.d_model)).astype(np.float32)
    jxk, jxv = jw.cross_kv(jp, CFG, jnp.asarray(xa))
    pxk, pxv = pw.cross_kv(pp, PCFG, t(xa))
    _, jck, jcv = jw.decoder_prefill(jp, CFG, jnp.asarray(toks), jxk, jxv)
    _, pck, pcv = pw.decoder_prefill(pp, PCFG, t(toks), pxk, pxv)
    if int4:
        jk, jv = jpc.prep_cross_kv_kernel4(*jw.quantize_cross_kv4(jxk, jxv), CFG.decoder_attention_heads)
        pk, pv = pc.prep_cross_kv_kernel4(*pw.quantize_cross_kv4(pxk, pxv), CFG.decoder_attention_heads)
    else:
        jk, jv = jpc.prep_cross_kv_kernel(*jw.quantize_cross_kv(jxk, jxv), CFG.decoder_attention_heads)
        pk, pv = pc.prep_cross_kv_kernel(*pw.quantize_cross_kv(pxk, pxv), CFG.decoder_attention_heads)
    if n_rungs > 1:
        jck, jcv = jnp.tile(jck, (1, n_rungs, 1, 1)), jnp.tile(jcv, (1, n_rungs, 1, 1))
        pck, pcv = pck.repeat(1, n_rungs, 1, 1), pcv.repeat(1, n_rungs, 1, 1)
    kcfg, pkcfg = CFG.with_(cross_kv_impl="kernel"), PCFG.with_(cross_kv_impl="kernel")
    tok = rng.integers(0, 900, (B * n_rungs,)).astype(np.int32)
    for pos in (3, 4):
        jl, jck, jcv = jw.decoder_step(jp, kcfg, jnp.asarray(tok), jnp.int32(pos), jck, jcv, jk, jv, n_rungs=n_rungs)
        pl, pck, pcv = pw.decoder_step(pp, pkcfg, t(tok), pos, pck, pcv, pk, pv, n_rungs=n_rungs)
        np.testing.assert_allclose(n(pl), np.asarray(jl), rtol=5e-4, atol=5e-4)
        np.testing.assert_allclose(n(pck), np.asarray(jck), rtol=2e-4, atol=2e-4)
        tok = tok[::-1].copy()


@pytest.mark.parametrize("impl", ["einsum", "chunked", "a8"])
def test_plain_impls_run_attention_cross_q8(model_params, impl):
    """The per-channel dict (any non-kernel cross_kv_impl) runs the plain
    attention_cross_q8 -- equal to JAX's "einsum" form."""
    jp, pp = model_params
    rng = np.random.default_rng(21)
    toks = rng.integers(0, CFG.vocab_size, (2, 3)).astype(np.int32)
    xa = rng.standard_normal((2, CFG.max_source_positions, CFG.d_model)).astype(np.float32)
    jxk, jxv = jw.cross_kv(jp, CFG, jnp.asarray(xa))
    pxk, pxv = pw.cross_kv(pp, PCFG, t(xa))
    _, jck, jcv = jw.decoder_prefill(jp, CFG, jnp.asarray(toks), jxk, jxv)
    _, pck, pcv = pw.decoder_prefill(pp, PCFG, t(toks), pxk, pxv)
    jk, jv = jw.quantize_cross_kv(jxk, jxv)
    pk, pv = pw.quantize_cross_kv(pxk, pxv)
    tok = np.asarray([5, 6], np.int32)
    jl, _, _ = jw.decoder_step(jp, CFG, jnp.asarray(tok), jnp.int32(3), jck, jcv, jk, jv)
    pl, _, _ = pw.decoder_step(pp, PCFG.with_(cross_kv_impl=impl), t(tok), 3, pck, pcv, pk, pv)
    np.testing.assert_allclose(n(pl), np.asarray(jl), rtol=5e-4, atol=5e-4)
    with pytest.raises(ValueError, match="cross_kv_impl"):
        pw.decoder_step(pp, PCFG.with_(cross_kv_impl="paged"), t(tok), 3, pck, pcv, pk, pv)


# The kernel's launch shape (ops/paged_cross.py::cross_decode_plan) and its
# key split (cross_decode_ranges, the kernel's own integer formula).
def _covers(ranges, n):
    """The ranges, in rank order, tile 0..n-1: contiguous, exactly once."""
    return ranges[0][0] == 0 and ranges[-1][1] == n and all(
        a[1] == b[0] and a[0] <= a[1] for a, b in zip(ranges, ranges[1:]))


@pytest.mark.parametrize("int4", [False, True], ids=["int8", "int4"])
def test_cross_decode_ranges_cover_the_keys(int4):
    for Ta in range(2 if int4 else 1, 1601, 2 if int4 else 1):
        for C in (1, 2, 4, 8, 16):
            ranges = pc.cross_decode_ranges(Ta, C, int4)
            assert _covers(ranges, Ta), (Ta, C, ranges)
            if int4:  # a CTA takes whole stored rows: key pairs 2r, 2r + 1
                assert all(lo % 2 == 0 and hi % 2 == 0 for lo, hi in ranges)
        plan = pc.cross_decode_plan(1, 20, 6, Ta, int4)
        stored = [(hi - lo) // (2 if int4 else 1) for lo, hi in pc.cross_decode_ranges(Ta, plan["cluster"], int4)]
        assert max(stored) <= plan["share"]


@pytest.mark.parametrize("int4", [False, True], ids=["int8", "int4"])
def test_cross_decode_plan_limits(int4):
    for B in (1, 2, 6, 8, 16, 48):
        for G in range(1, 9):
            for Ta in (2, 16, 38, 200, 1500, 3000):
                p = pc.cross_decode_plan(B, 20, G, Ta, int4)
                C, share = p["cluster"], p["share"]
                assert C in (1, 2, 4, 8, 16) and p["nonportable"] == (C > 8)
                assert share * C >= (Ta // 2 if int4 else Ta)
                assert p["pitch"] >= -(-share // 16) * 16 * (2 if int4 else 1)  # whole 16-key tiles
                assert p["smem_bytes"] == 4 * G * p["pitch"]
                assert p["smem_bytes"] + 28672 <= 232448  # 227 KB with the static arrays
                assert p["grid"] == (C, 20, B)


# Pinned at the path's shapes (Ta 1500, H 20): (B, G, int4) -> (cluster,
# stored rows per CTA), the plan's values, chosen by the cluster sweep of
# chip_smoke.py phase 6: 2 CTAs per (stream, head) at 8 streams (int8 and
# int4), 8 at one stream for int8 and 4 for int4 (at least 128 rows each).
CROSS_PLAN_PINS = {
    (B, G, int4): {1: (8, 188) if not int4 else (4, 188), 6: (4, 375) if not int4 else (4, 188),
                   8: (2, 750) if not int4 else (2, 375), 48: (1, 1500) if not int4 else (1, 750)}[B]
    for B in (1, 6, 8, 48) for G in (1, 6) for int4 in (False, True)
}


@pytest.mark.parametrize("B,G,int4", sorted(CROSS_PLAN_PINS))
def test_cross_decode_plan_at_the_path_shapes(B, G, int4):
    p = pc.cross_decode_plan(B, 20, G, 1500, int4)
    assert (p["cluster"], p["share"]) == CROSS_PLAN_PINS[(B, G, int4)]


def test_cross_decode_plan_rejects_shapes_past_the_kernel():
    with pytest.raises(ValueError, match="groups"):
        pc.cross_decode_plan(1, 20, 9, 1500, False)
    with pytest.raises(ValueError, match="groups"):
        pc.cross_decode_plan(1, 20, 0, 1500, False)
    with pytest.raises(ValueError, match="even"):
        pc.cross_decode_plan(1, 20, 1, 1499, True)
    with pytest.raises(ValueError, match="more than 16"):
        pc.cross_decode_plan(1, 20, 8, 200000, False)
