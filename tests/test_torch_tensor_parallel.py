"""Tensor parallelism in the port (norma_tpu_torch.parallel, the tp parts
of tests/test_parallel.py), on the CPU over virtual devices: the ranks of a
tp group live in one process (a LocalGroup) and run the kernel wrappers on
their shards (the plain versions on CPU tensors).

  - f32 greedy tokens at (dp, tp) = (1, 2), (2, 2), (1, 4) equal the JAX
    package's sharded engine (GSPMD over its forced CPU devices) and the
    port's tp=1 engine; ``no_speech_prob`` within 1e-5 and the prefill's
    logits within 1e-4;
  - the int8-quantized decode and detection at (2, 2);
  - the engine calls each kernel wrapper on each rank's shard;
  - the w8a8 encoder takes each split row's amax over the ranks (a
    per-shard amax gives another result);
  - the int8 self-KV cache at tp=2 (whole-row scales) against JAX;
  - the int8 head's vocabulary ragged over tp=4;
  - the collectives a decode step makes, and the refusals.

Tolerance: tokens equal; probabilities within 1e-5, logits within 1e-4
(f32, JAX matmul precision "highest").
"""

import numpy as np
import pytest
import torch

from helpers import TEST_LANG_IDS, TEST_ST, random_feats, tiny_config
from torch_port_helpers import port_cfg, port_params, port_st

from norma_tpu.decode import DecodeEngine as JaxEngine
from norma_tpu.model import init_params as jax_init
from norma_tpu.model.quant import quantize_decoder as jax_quantize_decoder
from norma_tpu.parallel import make_mesh as jax_make_mesh
from norma_tpu.parallel import shard_batch as jax_shard_batch
from norma_tpu.parallel import shard_params as jax_shard_params
from norma_tpu_torch.decode import DecodeEngine
from norma_tpu_torch.errors import NormaError
from norma_tpu_torch.model import fuse_qkv, init_params
from norma_tpu_torch.model import whisper as pw
from norma_tpu_torch.model.quant import quantize_decoder, quantize_encoder
from norma_tpu_torch.parallel import make_mesh, shard_batch, shard_params
from norma_tpu_torch.parallel.collectives import LocalGroup, RankList, TPParams, first

CFG = tiny_config(d_model=64, encoder_attention_heads=4, decoder_attention_heads=4)
PCFG = port_cfg(CFG)
ST = port_st(TEST_ST)
LANG = TEST_LANG_IDS[0]


@pytest.fixture(scope="module")
def jparams():
    return jax_init(CFG, seed=0)


@pytest.fixture(scope="module")
def params(jparams):
    return port_params(jparams)


def _cpu_mesh(dp, tp):
    return make_mesh(dp=dp, tp=tp, devices=["cpu"] * (dp * tp))


def _tokens(results):
    return [r.tokens for r in results]


def _logits(state):
    """The prefill's next-token logits of a dp engine's state, all rows."""
    return np.concatenate([first(s["next_logits"]).numpy() for _, s in state["parts"]])


def _jax_decode(jp, feats, dp, tp, **kw):
    jmesh = jax_make_mesh(dp=dp, tp=tp)
    eng = JaxEngine(jax_shard_params(jp, jmesh), CFG, TEST_ST, language_token_ids=TEST_LANG_IDS, **kw)
    state = eng.prefill(jax_shard_batch(feats, jmesh), LANG)
    return eng.run_loop(state, 0.0, seed=0), np.asarray(state["next_logits"])


@pytest.mark.parametrize("dp,tp", [(1, 2), (2, 2), (1, 4)])
def test_tp_decode_matches_jax_and_tp1(jparams, params, dp, tp):
    feats = random_feats(CFG, B=4, T=16, seed=7)
    ref = DecodeEngine(params, PCFG, ST, language_token_ids=TEST_LANG_IDS)
    ref_state = ref.prefill(feats, LANG)
    want = ref.run_loop(ref_state, 0.0, seed=0)

    mesh = _cpu_mesh(dp, tp)
    eng = DecodeEngine(shard_params(params, mesh), PCFG, ST, language_token_ids=TEST_LANG_IDS)
    try:
        assert len(eng.replicas) == dp and all(r.engine._group.size == tp for r in eng.replicas)
        state = eng.prefill(shard_batch(feats, mesh), LANG)
        got = eng.run_loop(state, 0.0, seed=0)
        logits = _logits(state)
    finally:
        eng.close()
    jax_out, jax_logits = _jax_decode(jparams, feats, dp, tp)

    assert _tokens(got) == _tokens(want) == _tokens(jax_out)
    for a, b, c in zip(got, want, jax_out):
        assert a.no_speech_prob == pytest.approx(b.no_speech_prob, abs=1e-5)
        assert a.no_speech_prob == pytest.approx(c.no_speech_prob, abs=1e-5)
    np.testing.assert_allclose(logits, ref_state["next_logits"].numpy(), atol=1e-4)
    np.testing.assert_allclose(logits, jax_logits, atol=1e-4)


def test_tp_quantized_decode_matches(jparams):
    jq = jax_quantize_decoder(jparams)
    pq = port_params(jq)
    feats = random_feats(CFG, B=2, T=16, seed=11)
    ref = DecodeEngine(pq, PCFG, ST, language_token_ids=TEST_LANG_IDS)
    want = ref.run_loop(ref.prefill(feats, LANG), 0.0, 0)
    mesh = _cpu_mesh(2, 2)
    eng = DecodeEngine(shard_params(pq, mesh), PCFG, ST, language_token_ids=TEST_LANG_IDS)
    try:
        got = eng.run_loop(eng.prefill(shard_batch(feats, mesh), LANG), 0.0, 0)
    finally:
        eng.close()
    jax_out, _ = _jax_decode(jq, feats, 2, 2)
    assert _tokens(got) == _tokens(want) == _tokens(jax_out)


def test_tp_detect_matches(jparams, params):
    feats = random_feats(CFG, B=2, T=16, seed=9)
    want = DecodeEngine(params, PCFG, ST, language_token_ids=TEST_LANG_IDS).detect_language(feats)
    mesh = _cpu_mesh(2, 2)
    eng = DecodeEngine(shard_params(params, mesh), PCFG, ST, language_token_ids=TEST_LANG_IDS)
    try:
        got = eng.detect_language(shard_batch(feats, mesh))
    finally:
        eng.close()
    jmesh = jax_make_mesh(dp=2, tp=2)
    jeng = JaxEngine(jax_shard_params(jparams, jmesh), CFG, TEST_ST, language_token_ids=TEST_LANG_IDS)
    jax_out = jeng.detect_language(jax_shard_batch(feats, jmesh))
    np.testing.assert_allclose(got, want, atol=1e-5)
    np.testing.assert_allclose(got, np.asarray(jax_out), atol=1e-5)


def test_tp_window_calls_each_kernel_wrapper_per_rank(monkeypatch):
    """The serving config's window at tp=2: every kernel wrapper is called
    on each rank's shard (heads D/tp wide, the int8 head's vocab shard), the
    encoder's kernels exactly twice the tp=1 engine's count, and the
    tokens equal tp=1's."""
    from norma_tpu.frontend.mel import prepare_audio

    kcfg = PCFG.with_(encoder_attn_impl="jax_flash", cross_kv_impl="kernel", self_kv_impl="kernel")
    p = quantize_encoder(quantize_decoder(fuse_qkv(init_params(kcfg, seed=1))))
    calls = []
    for name in ("flash_self_attention", "q8a8_dense", "q8a8_qkv", "self_attention_decode",
                 "cross_attention_q8_kernel_stacked", "w8_dense", "w8_matmul"):
        inner = getattr(pw, name)

        def spy(*a, _inner=inner, _name=name, **kw):
            calls.append((_name, tuple(a[0].shape), tuple(a[2].shape) if len(a) > 2 and torch.is_tensor(a[2]) else ()))
            return _inner(*a, **kw)

        monkeypatch.setattr(pw, name, spy)
    rng = np.random.default_rng(0)
    audio = np.stack([prepare_audio((0.1 * rng.standard_normal(16000)).astype(np.float32), 64) for _ in range(2)])
    one = DecodeEngine(p, kcfg, ST, language_token_ids=TEST_LANG_IDS, quantize_cross_kv=True)
    want, _ = one.transcribe_window(audio, [LANG] * 2, seed=0)
    n1 = {k: sum(1 for c in calls if c[0] == k) for k in {c[0] for c in calls}}
    calls.clear()
    mesh = _cpu_mesh(1, 2)
    eng = DecodeEngine(shard_params(p, mesh), kcfg, ST, language_token_ids=TEST_LANG_IDS, quantize_cross_kv=True)
    try:
        got, _ = eng.transcribe_window(audio, [LANG] * 2, seed=0)
    finally:
        eng.close()
    n2 = {k: sum(1 for c in calls if c[0] == k) for k in {c[0] for c in calls}}
    assert [None if r is None else r.tokens for r in got] == [None if r is None else r.tokens for r in want]
    assert set(n2) == set(n1) == {"flash_self_attention", "q8a8_dense", "q8a8_qkv", "self_attention_decode",
                                  "cross_attention_q8_kernel_stacked", "w8_dense", "w8_matmul"}
    for k in ("flash_self_attention", "q8a8_qkv"):  # the encoder: once per layer per rank
        assert n2[k] == 2 * n1[k], (k, n1, n2)
    D = kcfg.d_model
    flash = [c for c in calls if c[0] == "flash_self_attention"]
    assert all(c[1][-1] == D // 2 for c in flash)  # q: the rank's heads
    heads = [c for c in calls if c[0] == "w8_matmul"]
    assert all(c[2] == (kcfg.vocab_size // 2,) for c in heads)  # scale: the rank's vocab shard


def test_w8a8_rows_take_the_whole_rows_amax(monkeypatch):
    """tp=2 w8a8 encode equals tp=1 bit for bit: the split rows of o_proj's
    and fc2's inputs quantize on the whole row's grid (a max over the
    ranks), each rank's GEMM gives an exact integer partial, and the
    partials are summed before the scales and the bias.  With each rank's
    own amax (the trap) the result differs."""
    cfg = PCFG
    p = quantize_encoder(fuse_qkv(init_params(cfg, seed=2)))
    mel = torch.from_numpy(np.random.default_rng(3).standard_normal((2, cfg.num_mel_bins, 64)).astype(np.float32))
    want = pw.encode(p, cfg, mel)
    ranks = shard_params(p, _cpu_mesh(1, 2)).ranks(0)
    eng = DecodeEngine(TPParams(ranks, [0, 1], LocalGroup(["cpu", "cpu"])), cfg, ST, language_token_ids=TEST_LANG_IDS)
    got = eng.encode(mel)
    assert torch.equal(got, want)

    meet = pw._meet

    def per_shard_max(tp, op, t, **kw):
        if op == "max":
            return t
        return (yield from meet(tp, op, t, **kw))

    monkeypatch.setattr(pw, "_meet", per_shard_max)
    wrong = eng.encode(mel)
    assert not torch.equal(wrong, want)
    assert float((wrong - want).abs().max()) > 1e-4


def test_int8_self_kv_at_tp2_matches_jax(jparams, params):
    feats = random_feats(CFG, B=2, T=16, seed=5)
    ref = DecodeEngine(params, PCFG, ST, language_token_ids=TEST_LANG_IDS, quantize_self_kv=True)
    want = ref.run_loop(ref.prefill(feats, LANG), 0.0, 0)
    mesh = _cpu_mesh(1, 2)
    eng = DecodeEngine(shard_params(params, mesh), PCFG, ST, language_token_ids=TEST_LANG_IDS, quantize_self_kv=True)
    try:
        state = eng.prefill(feats, LANG)
        got = eng.run_loop(state, 0.0, 0)
        # The caches' row scales are the whole row's: every rank holds the same.
        _, s = state["parts"][0]
        ck = s["cache_k"]
        assert isinstance(ck, RankList) and torch.equal(ck[0]["s"], ck[1]["s"])
    finally:
        eng.close()
    jax_out, _ = _jax_decode(jparams, feats, 1, 2, quantize_self_kv=True)
    assert _tokens(got) == _tokens(want) == _tokens(jax_out)


def test_ragged_int8_head_over_tp4():
    """V=1002 over tp=4: the int8 head's vocabulary splits 251 x 3 + 249
    (GSPMD's padding), the logits gather back whole, and tokens and
    logits equal the tp=1 engine's."""
    cfg = port_cfg(tiny_config(d_model=64, encoder_attention_heads=4, decoder_attention_heads=4, vocab_size=1002))
    p = quantize_decoder(init_params(cfg, seed=4))
    sp = shard_params(p, _cpu_mesh(1, 4))
    assert [r["decoder"]["tok_emb_q8"]["q"].shape[1] for r in sp.ranks(0)] == [251, 251, 251, 249]
    assert [r["decoder"]["tok_emb_q8"]["s"].shape[0] for r in sp.ranks(0)] == [251, 251, 251, 249]
    with pytest.raises(ValueError, match="does not split"):
        shard_params(init_params(cfg.with_(d_model=66), seed=0), _cpu_mesh(1, 4))
    feats = random_feats(CFG, B=2, T=16, seed=6)
    ref = DecodeEngine(p, cfg, ST, language_token_ids=TEST_LANG_IDS)
    ref_state = ref.prefill(feats, LANG)
    want = ref.run_loop(ref_state, 0.0, 0)
    eng = DecodeEngine(sp, cfg, ST, language_token_ids=TEST_LANG_IDS)
    try:
        state = eng.prefill(feats, LANG)
        got = eng.run_loop(state, 0.0, 0)
        logits = _logits(state)
    finally:
        eng.close()
    assert logits.shape == (2, 1002)
    np.testing.assert_allclose(logits, ref_state["next_logits"].numpy(), atol=1e-4)
    assert _tokens(got) == _tokens(want)


@pytest.mark.parametrize("quant", ["bf16 head", "int8 head, int8 self-KV"])
def test_collectives_per_decode_step(params, quant):
    """One decode step at tp=2 meets the ranks 3 times a decoder layer (the
    row-parallel o, xo and fc2 products), once for the embedding's gather
    and once for the head (+2 a layer with the int8 self-KV rows)."""
    p = params if quant == "bf16 head" else quantize_decoder(params)
    eng = DecodeEngine(TPParams(shard_params(p, _cpu_mesh(1, 2)).ranks(0), [0, 1], LocalGroup(["cpu"] * 2)), PCFG, ST,
                       language_token_ids=TEST_LANG_IDS, quantize_self_kv=quant != "bf16 head")
    feats = torch.from_numpy(random_feats(CFG, B=2, T=16, seed=1))
    state = eng.prefill(feats, LANG)
    g = eng._group
    n0 = g.collectives
    eng._fan("decoder_step", eng._rp, PCFG, torch.tensor([5, 6], dtype=torch.int32), 3,
             state["cache_k"], state["cache_v"], state["xk"], state["xv"])
    L = PCFG.decoder_layers
    assert g.collectives - n0 == 3 * L + 2 + (2 * L if quant != "bf16 head" else 0)


def test_heads_must_split_over_tp(params):
    cfg = port_cfg(tiny_config())  # 2 heads
    with pytest.raises(ValueError, match="does not split over tp=4"):
        DecodeEngine(shard_params(init_params(cfg, seed=0), _cpu_mesh(1, 4)), cfg, ST, language_token_ids=TEST_LANG_IDS)


def test_lockstep_refuses_diverged_ranks():
    from norma_tpu_torch.parallel.collectives import lockstep

    def rank(n):
        for _ in range(n):
            yield ("sum", torch.ones(2), {})
        return n

    assert lockstep(LocalGroup(["cpu"] * 2), [rank(2), rank(2)]) == [2, 2]
    with pytest.raises(NormaError, match="diverged"):
        lockstep(LocalGroup(["cpu"] * 2), [rank(1), rank(2)])


def test_mesh_helpers_count_tp_positions(params):
    from norma_tpu_torch.utils import params_device_count, params_platform, params_replicated_on_mesh

    mesh = _cpu_mesh(2, 2)
    sp = shard_params(params, mesh)
    assert params_device_count(sp) == 4 and not params_replicated_on_mesh(sp, mesh)
    tpp = TPParams(sp.ranks(1), [0, 1], LocalGroup(["cpu"] * 2))
    assert params_device_count(tpp) == 2 and params_platform(tpp) == "cpu"
    assert [r["decoder"]["tok_emb"].shape[1] for r in sp.ranks(1)] == [32, 32]
    with pytest.raises(ValueError, match="ranks"):
        sp.replicas()


@pytest.mark.parametrize("head", ["tok_emb_q8", "tok_emb_q4"])
def test_unsharded_head_reads_only_its_leaves(params, head):
    """``logits_head`` on a tree holding only a quantized head (no
    ``tok_emb``), as chip_smoke carries JAX-layout head trees: the unsharded
    head needs nothing else."""
    from norma_tpu_torch.model.load import Params
    from norma_tpu_torch.model.quant import quantize_logits_head, quantize_logits_head_int4

    q = (quantize_logits_head if head == "tok_emb_q8" else quantize_logits_head_int4)(params)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((3, PCFG.d_model)).astype(np.float32))
    want = pw.logits_head(q["decoder"], x)
    only = Params({head: {k: v for k, v in q["decoder"][head].items()}})
    assert "tok_emb" not in only
    assert torch.equal(pw.logits_head(only, x), want)
