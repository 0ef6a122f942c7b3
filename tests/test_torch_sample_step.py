"""Port grammar + sampling step (plain version) vs the JAX twin and the
JAX Pallas kernel (interpret mode, greedy_only), on the same inputs.

Greedy: ``nxt`` and ``deadlock`` exact, ``prob`` within 1e-6 (the same
softmax formula in f32).  t>0: the draw comes from another generator, so
the checks are the mask support and a chi-square test of the law against
softmax(masked / t).  The CUDA kernel is held against this plain version on
the card by chip_smoke.py (with the kernel's own Philox uniforms fed in).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from helpers import TEST_ST, tiny_config
from torch_port_helpers import n, t

from norma_tpu.decode.masks import build_masks
from norma_tpu.ops.sample_step import sample_step_jnp, sample_step_pallas
from norma_tpu_torch.ops import sample_step as ss

CFG = tiny_config()
ST = TEST_ST
V = CFG.vocab_size
MASKS = build_masks(V, CFG.suppress_tokens, ST)
M4 = (MASKS.suppress, MASKS.non_timestamps, MASKS.timestamps, MASKS.first_token)

CASES = [
    # (p1, p2, last_ts, step): first token, text-after-ts pair rule,
    # ts-after-special, sum-vs-max rule, past-ts monotonicity, deadlock.
    (ST.task, ST.sot, 0, 0),
    (ST.zero_sec + 1, ST.eot + 5, 0, 1),
    (ST.zero_sec + 2, ST.sot, 0, 2),
    (100, 101, 0, 3),
    (100, ST.zero_sec + 3, ST.zero_sec + 3, 4),
    (V - 1, 100, V - 1, 5),  # grammar deadlock: every entry -inf
]


def _port(ll, p1, p2, lts, step, temp, **kw):
    B = ll.shape[0]
    i32 = lambda x: torch.as_tensor(np.broadcast_to(np.asarray(x, np.int32), (B,)).copy())
    return ss.sample_step(
        t(ll), *(t(m) for m in M4), i32(p1), i32(p2), i32(lts),
        t(np.asarray(step, np.int32)) if np.ndim(step) else int(step),
        torch.full((B,), float(temp)), eot=ST.eot, no_timestamps=ST.no_timestamps, **kw,
    )


def _jax(fn, ll, p1, p2, lts, step, temp, **kw):
    B = ll.shape[0]
    i32 = lambda x: jnp.broadcast_to(jnp.asarray(x, jnp.int32), (B,))
    return fn(
        jnp.asarray(ll), *(jnp.asarray(m) for m in M4), i32(p1), i32(p2), i32(lts),
        jnp.asarray(step, jnp.int32), jnp.full((B,), temp, jnp.float32),
        eot=ST.eot, no_timestamps=ST.no_timestamps, **kw,
    )


def _assert_same(port, ref):
    np.testing.assert_array_equal(n(port[0]), n(ref[0]))
    np.testing.assert_allclose(n(port[1]), n(ref[1]), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(n(port[2]), n(ref[2]))


@pytest.mark.parametrize("case", range(len(CASES)))
def test_greedy_matches_jnp_and_pallas(case):
    p1, p2, lts, step = CASES[case]
    rng = np.random.default_rng(case)
    ll = rng.normal(0, 2, (3, V)).astype(np.float32)
    port = _port(ll, p1, p2, lts, step, 0.0)
    _assert_same(port, _jax(sample_step_jnp, ll, p1, p2, lts, step, 0.0, key=jax.random.PRNGKey(0)))
    _assert_same(port, _jax(
        sample_step_pallas, ll, p1, p2, lts, step, 0.0,
        seed2=jnp.asarray([1, 2], jnp.uint32), greedy_only=True, interpret=True,
    ))
    _assert_same(_port(ll, p1, p2, lts, step, 0.0, greedy_only=True), port)


def test_per_row_steps():
    """step [B]: row 0 at the first-token grammar, rows 1-2 past it."""
    rng = np.random.default_rng(11)
    ll = rng.normal(0, 2, (3, V)).astype(np.float32)
    steps = np.asarray([0, 3, 7], np.int32)
    p1, p2, lts = [ST.task, 100, ST.zero_sec + 2], [ST.sot, 101, ST.sot], [0, 0, 0]
    port = _port(ll, p1, p2, lts, steps, 0.0)
    _assert_same(port, _jax(sample_step_jnp, ll, p1, p2, lts, steps, 0.0, key=jax.random.PRNGKey(0)))
    assert ST.zero_sec <= int(port[0][0]) <= ST.one_sec


def test_nan_and_all_masked_rows():
    rng = np.random.default_rng(4)
    ll = rng.normal(0, 2, (3, V)).astype(np.float32)
    ll[0] = np.nan  # NaN logits
    ll[1, 17] = np.nan  # one NaN poisons the row's softmax
    for temp in (0.0, 0.6):
        port = _port(ll, 100, 101, 0, 3, temp)
        ref = _jax(sample_step_jnp, ll, 100, 101, 0, 3, temp, key=jax.random.PRNGKey(0))
        np.testing.assert_array_equal(n(port[2]), n(ref[2]))
        assert n(port[2]).tolist() == [True, True, False]
        want0 = V - 1 if temp == 0 else ST.eot  # deadlock: greedy V-1, t>0 EOT
        assert int(port[0][0]) == int(port[0][1]) == want0
        if temp == 0:
            _assert_same(port, ref)
    # Every entry masked (the deadlock case): same rules.
    p1, p2, lts, step = CASES[-1]
    for temp, want in ((0.0, V - 1), (0.4, ST.eot)):
        nxt, prob, dead = _port(ll[2:], p1, p2, lts, step, temp)
        assert bool(dead[0]) and int(nxt[0]) == want and float(prob[0]) == -np.inf


def test_sampling_respects_mask_support():
    rng = np.random.default_rng(7)
    ll = rng.normal(0, 2, (512, V)).astype(np.float32)
    gen = torch.Generator().manual_seed(0)
    nxt, prob, _ = _port(ll, ST.task, ST.sot, 0, 0, 0.8, generator=gen)  # ts-only support
    allowed = np.where(np.isfinite(MASKS.first_token))[0]
    assert np.isin(n(nxt), allowed).all() and (n(prob) > 0).all()
    nxt, _, _ = _port(ll, 100, 101, 0, 3, 1.0, generator=gen)
    assert np.isfinite(MASKS.suppress[n(nxt)]).all()


def _masked_text_case(row):
    """numpy masked probabilities for the text-after-text grammar case
    (p1=100, p2=101, last_ts=0, step>0): base + (non_ts mask if the
    timestamp mass wins, else nothing)."""
    e = np.exp(row - row.max())
    base = e / e.sum() + MASKS.suppress
    force_ts = base[ST.no_timestamps + 1:].sum() >= base[:ST.no_timestamps].max()
    return base + (MASKS.non_timestamps if force_ts else 0.0)


def test_sampling_law_chi_square():
    """Draws follow softmax(masked / t): chi-square over the tokens with
    expected count >= 5 (the rest pooled)."""
    rng = np.random.default_rng(2)
    row = rng.normal(0, 1, V).astype(np.float32)
    row[:40] += 6.0  # a few dozen likely text tokens
    N, temp = 20000, 0.7
    nxt, _, _ = _port(np.tile(row, (N, 1)), 100, 101, 0, 3, temp,
                      generator=torch.Generator().manual_seed(1))
    logits = _masked_text_case(row).astype(np.float64) / temp
    p = np.exp(logits - logits[np.isfinite(logits)].max())
    p /= p.sum()
    counts = np.bincount(n(nxt), minlength=V)
    assert counts[p == 0].sum() == 0  # nothing outside the support
    big = p * N >= 5
    f_obs = np.append(counts[big], counts[~big].sum())
    f_exp = np.append(p[big] * N, p[~big].sum() * N)
    keep = f_exp > 0
    assert stats.chisquare(f_obs[keep], f_exp[keep]).pvalue > 1e-3


def test_given_uniforms_fix_the_draw():
    """With ``u`` given, the draw is the first argmax of
    masked / t - log(-log(u)) (how chip_smoke.py replays the kernel's draw)."""
    rng = np.random.default_rng(9)
    B, temp = 4, 0.5
    ll = rng.normal(0, 2, (B, V)).astype(np.float32)
    u = rng.uniform(size=(B, V)).astype(np.float32)
    rows = (torch.full((B,), x, dtype=torch.int32) for x in (100, 101, 0))
    nxt, _, _ = ss.sample_step_torch(
        t(ll), *(t(m) for m in M4), *rows, 3, torch.full((B,), temp),
        eot=ST.eot, no_timestamps=ST.no_timestamps, u=t(u),
    )
    for b in range(B):
        z = _masked_text_case(ll[b]) / np.float32(temp) - np.log(-np.log(u[b]))
        assert int(nxt[b]) == int(np.argmax(z)), b


def test_wrapper_rejects_bad_inputs():
    ll = np.zeros((2, V), np.float32)
    with pytest.raises(ValueError, match="int32"):
        ss.sample_step(
            t(ll), *(t(m) for m in M4), torch.zeros(2, dtype=torch.int64), torch.zeros(2, dtype=torch.int32),
            torch.zeros(2, dtype=torch.int32), 0, torch.zeros(2), eot=ST.eot, no_timestamps=ST.no_timestamps,
        )
    with pytest.raises(ValueError, match="logits"):
        _port(ll.astype(np.float64), 100, 101, 0, 3, 0.0)
    with pytest.raises(ValueError, match="masks"):
        ss.sample_step(
            t(ll), t(M4[0][:-1]), *(t(m) for m in M4[1:]), *(torch.zeros(2, dtype=torch.int32),) * 3,
            0, torch.zeros(2), eot=ST.eot, no_timestamps=ST.no_timestamps,
        )
    assert ss.sample_step.launches == 0  # the CPU path launches nothing


@pytest.mark.parametrize("B,V", [(1, 51866), (6, 51866), (8, 51866), (16, 51866), (48, 51866), (200, 51866),
                                 (3, 51869), (6, V), (8, 7), (1, 300000)])
def test_sample_step_plan(B, V):
    """The kernel's clusters: slices of a multiple of 4 ids (no Philox
    group straddles two CTAs) that split the row with every CTA holding
    some of it, B x cluster within the H100's 132 SMs where a row fits one
    CTA's shared memory, the cluster as large as that allows, and each
    slice within the shared memory."""
    plan = ss.sample_step_plan(B, V)
    C, L = plan["cluster"], plan["slice"]
    assert C in (1, 2, 4, 8, 16) and L % 4 == 0
    assert (C - 1) * L < V <= C * L  # every CTA has work, the slices cover the row
    assert plan["smem_bytes"] == 4 * L <= 229376 and plan["grid"] == (C, B)
    if 4 * -(-V // 4) <= 229376:  # a row fits one CTA
        assert B * C <= 132 or C == 1
        L2 = 4 * -(-(-(-V // (2 * C))) // 4)
        assert C == 16 or B * 2 * C > 132 or (2 * C - 1) * L2 >= V  # it grew as far as it could
    if V == 51866:
        assert C == {1: 16, 6: 16, 8: 16, 16: 8, 48: 2, 200: 1}[B]


def test_sample_step_plan_rejects_rows_past_the_clusters():
    with pytest.raises(ValueError, match="slices"):
        ss.sample_step_plan(1, 16 * 229376 // 4 + 4)
