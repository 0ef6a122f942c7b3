"""bf16 tensor parallelism's rounding against the JAX package's, by depth.

The speculative verify chunk's logits at tp=2 sit away from tp=1's in
bf16: summing a row-parallel product's two partials rounds differently
from one whole product, and the difference grows with depth.  This holds
the port's tp=2 - tp=1 gap to the JAX package's at the same mesh shape,
tiers and depth: the int8 decoder and head with fused QKV (phase 20's
serving tiers, int8 in place of its int4 head), bf16 everywhere else, a
final LayerNorm gain that spreads the logits about as phase 20's do (12),
decoder depths 4, 8, 16 and 32 at d_model 128 (4 heads).  JAX runs GSPMD
over two of the forced CPU devices (tests/conftest.py); the port runs its
ranks' layer generators in lockstep through a ``LocalGroup``.  The port's
gap must not exceed the JAX package's by more than a bf16 ulp of the
logits' spread: a wrong shard or reduction order would move the logits by
their spread.

``python tests/test_torch_tp_bf16_gap.py`` prints both gaps by depth.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

_TESTS = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [_TESTS, os.path.dirname(_TESTS)]  # run as a script too

from helpers import tiny_config  # noqa: E402
from torch_port_helpers import port_cfg, port_params, t  # noqa: E402

from norma_tpu.model import fuse_qkv as jax_fuse_qkv  # noqa: E402
from norma_tpu.model import init_params as jax_init  # noqa: E402
from norma_tpu.model import whisper as jw  # noqa: E402
from norma_tpu.model.quant import quantize_decoder as jax_quantize_decoder  # noqa: E402
from norma_tpu.parallel import make_mesh as jax_make_mesh  # noqa: E402
from norma_tpu.parallel import shard_params as jax_shard_params  # noqa: E402
from norma_tpu_torch.model import whisper as pw  # noqa: E402
from norma_tpu_torch.parallel import make_mesh, shard_params  # noqa: E402
from norma_tpu_torch.parallel.collectives import LocalGroup, Rank, lockstep  # noqa: E402

D, HEADS, SPREAD, K = 128, 4, 12.0, 4
DEPTHS = (4, 8, 16, 32)


def _bf16_tree(tree):
    return jax.tree.map(lambda a: a.astype(jnp.bfloat16) if jnp.issubdtype(a.dtype, jnp.floating) else a, tree)


def _setup(depth):
    jcfg = tiny_config(d_model=D, encoder_attention_heads=HEADS, decoder_attention_heads=HEADS,
                       decoder_layers=depth, encoder_layers=1)
    jp = jax_init(jcfg, seed=31)
    jp["decoder"]["ln_g"] = jp["decoder"]["ln_g"] * (SPREAD / (0.02 * D ** 0.5))
    return jcfg, _bf16_tree(jax_quantize_decoder(jax_fuse_qkv(jp)))


def _inputs(jcfg, jp):
    """Cross-K/V of random features and the prefill of [sot, lang] with K+1
    rows of slack, then the chunk's tokens and positions (numpy/JAX)."""
    rng = np.random.default_rng(7)
    B = 2
    feats = jnp.asarray(rng.standard_normal((B, jcfg.max_source_positions, D)).astype(np.float32)).astype(jnp.bfloat16)
    xk, xv = jw.cross_kv(jp, jcfg, feats)
    _, ck, cv = jw.decoder_prefill(jp, jcfg, jnp.asarray([[901, 902], [901, 903]], jnp.int32), xk, xv)
    pad = lambda c: jnp.pad(c, ((0, 0), (0, 0), (0, K + 1), (0, 0)))  # noqa: E731
    toks = np.asarray([[905] + [400 + 7 * i for i in range(K)], [905] + [401 + 5 * i for i in range(K)]], np.int32)
    pos = np.asarray([2, 2], np.int32)
    return toks, pos, pad(ck), pad(cv), xk, xv


def jax_gap(jcfg, jp, ins):
    toks, pos, ck, cv, xk, xv = ins
    chunk = jax.jit(jw.decoder_chunk, static_argnums=1)
    one = chunk(jp, jcfg, jnp.asarray(toks), jnp.asarray(pos), ck, cv, xk, xv)[0]
    two = chunk(jax_shard_params(jp, jax_make_mesh(dp=1, tp=2)), jcfg, jnp.asarray(toks), jnp.asarray(pos),
                ck, cv, xk, xv)[0]
    one, two = np.asarray(one, np.float32), np.asarray(two, np.float32)
    return float(np.abs(two - one).max()), float(np.abs(one).max())


def _cols(x, r, d):
    return x[..., r * d:(r + 1) * d].contiguous()


def port_gap(jcfg, jp, ins):
    cfg = port_cfg(jcfg)
    params = port_params(jp, dtype=torch.bfloat16)
    toks, pos, ck, cv, xk, xv = (t(np.asarray(a.astype(jnp.float32)) if hasattr(a, "dtype") and a.dtype == jnp.bfloat16
                                   else np.asarray(a)) for a in ins)
    ck, cv, xk, xv = (a.to(torch.bfloat16) for a in (ck, cv, xk, xv))
    toks, pos = toks.to(torch.int32), pos.to(torch.int64)
    one = pw.decoder_chunk(params, cfg, toks, pos, ck.clone(), cv.clone(), xk, xv)[0].float()
    shards = shard_params(params, make_mesh(dp=1, tp=2, devices=["cpu"] * 2)).ranks(0)
    d = D // 2
    gens = [pw._decoder_chunk(shards[r], cfg, toks, pos, _cols(ck, r, d), _cols(cv, r, d), _cols(xk, r, d),
                              _cols(xv, r, d), tp=Rank(r, 2)) for r in range(2)]
    two = lockstep(LocalGroup(["cpu"] * 2), gens)[0][0].float()
    return float((two - one).abs().max()), float(one.abs().max())


def gaps(depth):
    """(the port's gap, JAX's gap, the port's max |logit|) at ``depth``."""
    jcfg, jp = _setup(depth)
    ins = _inputs(jcfg, jp)
    p, scale = port_gap(jcfg, jp, ins)
    j, _ = jax_gap(jcfg, jp, ins)
    return p, j, scale


@pytest.mark.parametrize("depth", DEPTHS)
def test_port_tp2_bf16_gap_within_jax(depth):
    p, j, scale = gaps(depth)
    ulp = scale * 2.0 ** -8  # one bf16 ulp at the logits' largest magnitude
    assert np.isfinite(p) and np.isfinite(j) and scale > 1.0
    assert p <= j + ulp, f"depth {depth}: port tp=2 gap {p} over JAX's {j} (+ {ulp})"


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    for depth in DEPTHS:
        p, j, scale = gaps(depth)
        print(f"depth {depth}: port tp=2 - tp=1 max |d logits| {p:.4f}; JAX {j:.4f}; max |logit| {scale:.2f}",
              flush=True)
