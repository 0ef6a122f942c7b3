"""The port's device meshes and data parallelism (norma_tpu_torch.parallel),
the twin of tests/test_parallel.py, on the CPU over virtual devices.

  - ``param_shardings``: every leaf's spec equals JAX's ``NamedSharding.spec``
    on plain, fused-QKV, int8- and int4-quantized trees (this also covers
    ``test_qkv_fusion.py::test_fused_shardings_build``);
  - ``shard_params``: each position's slices reassemble every leaf, and a
    position on the leaf's own device shares it;
  - dp 2, 3 and 4: greedy tokens of the port's dp engine equal the
    unsharded port's and the JAX package's dp-mesh engine's (GSPMD over its
    forced CPU devices), quantized and detection too;
  - speculative decoding on dp2 x tp2 gives the one-device speculative
    engine's tokens, and a draft over another group raises ``NormaError``
    (the tp engines: test_torch_tensor_parallel.py,
    test_torch_speculative_tp.py).

Tolerance: tokens equal; ``no_speech_prob`` and language probabilities
within 1e-5 (f32, JAX matmul precision "highest").
"""

import jax
import numpy as np
import pytest
import torch

from helpers import TEST_LANG_IDS, TEST_ST, random_feats, tiny_config
from torch_port_helpers import port_cfg, port_params, port_st

from norma_tpu.decode import DecodeEngine as JaxEngine
from norma_tpu.model import fuse_qkv as jax_fuse_qkv
from norma_tpu.model import init_params as jax_init
from norma_tpu.model.quant import quantize_decoder as jax_quantize_decoder
from norma_tpu.model.quant import quantize_encoder as jax_quantize_encoder
from norma_tpu.parallel import make_mesh as jax_make_mesh
from norma_tpu.parallel import param_shardings as jax_param_shardings
from norma_tpu.parallel import shard_batch as jax_shard_batch
from norma_tpu.parallel import shard_params as jax_shard_params
from norma_tpu_torch.decode import DecodeEngine, SpeculativeEngine
from norma_tpu_torch.errors import NormaError
from norma_tpu_torch.parallel import (
    ShardedParams,
    batch_sharding,
    make_mesh,
    param_shardings,
    shard_batch,
    shard_params,
)
from norma_tpu_torch.parallel.data_parallel import DataParallelEngine

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


def _cpu_mesh(dp, tp=1):
    return make_mesh(dp=dp, tp=tp, devices=["cpu"] * (dp * tp))


def _jax_tree(kind, jparams):
    if kind == "plain":
        return jparams
    if kind == "fused":
        return jax_fuse_qkv(jparams)
    if kind == "int8":
        return jax_quantize_encoder(jax_quantize_decoder(jax_fuse_qkv(jparams)))
    return jax_quantize_decoder(jparams, logits="int4")


def _flat(tree, path=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict) or isinstance(v, torch.nn.Module):  # a dict or a Params subtree
            out.update(_flat(v, path + (k,)))
        else:
            out[path + (k,)] = v
    return out


@pytest.mark.parametrize("kind", ["plain", "fused", "int8", "int4"])
def test_param_shardings_match_jax(jparams, kind):
    jtree = _jax_tree(kind, jparams)
    jspecs = jax_param_shardings(jtree, jax_make_mesh(dp=2, tp=2))
    want = {}
    for path, sh in jax.tree_util.tree_flatten_with_path(jspecs, is_leaf=lambda x: hasattr(x, "spec"))[0]:
        want[tuple(p.key for p in path)] = tuple(sh.spec)
    got = _flat(param_shardings(port_params(jtree), _cpu_mesh(2, 2)))
    assert got == want
    assert any("tp" in s for s in got.values())  # the table is not all replicated


def test_batch_sharding_spec():
    mesh = _cpu_mesh(2)
    assert batch_sharding(mesh, 3) == ("dp", None, None)
    jmesh = jax_make_mesh(dp=2, tp=1)
    from norma_tpu.parallel import batch_sharding as jax_batch_sharding

    assert tuple(jax_batch_sharding(jmesh, 3).spec) == batch_sharding(mesh, 3)


def test_make_mesh_shape_and_limits():
    mesh = make_mesh(dp=2, tp=2, devices=["cpu"] * 4)
    assert mesh.shape == {"dp": 2, "tp": 2} and mesh.axis_names == ("dp", "tp") and mesh.size == 4
    assert mesh == make_mesh(dp=2, tp=2, devices=["cpu"] * 5)
    assert mesh != make_mesh(dp=4, tp=1, devices=["cpu"] * 4)
    with pytest.raises(ValueError, match="needs 4 devices, have 3"):
        make_mesh(dp=2, tp=2, devices=["cpu"] * 3)


def test_make_mesh_defaults_to_the_cards(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(ValueError, match="needs 1 devices, have 0"):
        make_mesh()  # no CPU default
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert [str(d) for d in make_mesh(dp=2).devices.flat] == ["cuda:0", "cuda:1"]
    assert [str(d) for d in make_mesh(dp=2, devices=["cuda", "cuda"]).devices.flat] == ["cuda:0", "cuda:0"]


@pytest.mark.parametrize("dp,tp", [(2, 1), (1, 2), (2, 2)])
@pytest.mark.parametrize("kind", ["fused", "int8"])
def test_shard_params_reassemble(jparams, dp, tp, kind):
    tree = port_params(_jax_tree(kind, jparams))
    mesh = _cpu_mesh(dp, tp)
    sp = shard_params(tree, mesh)
    assert isinstance(sp, ShardedParams) and sp.mesh == mesh
    flat, specs = _flat(tree), _flat(sp.specs)
    for i in range(dp):
        pieces = [_flat(sp.shard(i, j)) for j in range(tp)]
        for path, leaf in flat.items():
            spec = specs[path]
            if "tp" in spec and tp > 1:
                whole = torch.cat([p[path] for p in pieces], dim=spec.index("tp"))
            else:
                whole = pieces[0][path]
                # A position on the leaf's own device shares it: nothing copied.
                assert all(p[path].data_ptr() == leaf.data_ptr() for p in pieces)
            assert torch.equal(whole, leaf), path
    if tp == 1:
        assert len(sp.replicas()) == dp
    else:
        with pytest.raises(ValueError, match="tp"):
            sp.replicas()


def test_shard_batch_splits_rows():
    x = np.arange(24, dtype=np.float32).reshape(6, 4)
    sb = shard_batch(x, _cpu_mesh(3))
    assert sb.shape == (6, 4) and len(sb.pieces) == 3
    assert np.array_equal(torch.cat(sb.pieces).numpy(), x)
    with pytest.raises(ValueError, match="does not split"):
        shard_batch(x[:5], _cpu_mesh(2))


def _tokens(results):
    return [r.tokens for r in results]


@pytest.mark.parametrize("dp", [2, 3, 4])
def test_dp_decode_matches_unsharded_and_jax(jparams, params, dp):
    feats = random_feats(CFG, B=12, T=16, seed=7)
    ref = DecodeEngine(params, PCFG, ST, language_token_ids=TEST_LANG_IDS)
    want = ref.run_loop(ref.prefill(feats, LANG), 0.0, seed=0)

    mesh = _cpu_mesh(dp)
    eng = DecodeEngine(shard_params(params, mesh), PCFG, ST, language_token_ids=TEST_LANG_IDS)
    try:
        assert isinstance(eng, DataParallelEngine) and len(eng.replicas) == dp and eng.mesh == mesh
        got = eng.run_loop(eng.prefill(shard_batch(feats, mesh), LANG), 0.0, seed=0)
        # Every replica decoded its rows.
        assert all(r.engine.decode_steps > 0 for r in eng.replicas)
    finally:
        eng.close()

    jmesh = jax_make_mesh(dp=dp, tp=1)
    jeng = JaxEngine(jax_shard_params(jparams, jmesh), CFG, TEST_ST, language_token_ids=TEST_LANG_IDS)
    jax_out = jeng.run_loop(jeng.prefill(jax_shard_batch(feats, jmesh), LANG), 0.0, seed=0)

    assert _tokens(got) == _tokens(want) == _tokens(jax_out)
    for a, b in zip(got, jax_out):
        assert a.no_speech_prob == pytest.approx(b.no_speech_prob, abs=1e-5)


def test_dp_quantized_decode_matches(jparams):
    jq = jax_quantize_decoder(jparams)
    pq = port_params(jq)
    feats = random_feats(CFG, B=4, T=16, seed=11)
    ref = DecodeEngine(pq, PCFG, ST, language_token_ids=TEST_LANG_IDS)
    want = ref.run_loop(ref.prefill(feats, LANG), 0.0, 0)
    mesh = _cpu_mesh(2)
    eng = DecodeEngine(shard_params(pq, mesh), PCFG, ST, language_token_ids=TEST_LANG_IDS)
    try:
        got = eng.run_loop(eng.prefill(shard_batch(feats, mesh), LANG), 0.0, 0)
    finally:
        eng.close()
    jmesh = jax_make_mesh(dp=2, tp=1)
    jeng = JaxEngine(jax_shard_params(jq, jmesh), CFG, TEST_ST, language_token_ids=TEST_LANG_IDS)
    jax_out = jeng.run_loop(jeng.prefill(jax_shard_batch(feats, jmesh), LANG), 0.0, 0)
    assert _tokens(got) == _tokens(want) == _tokens(jax_out)


def test_dp_detect_matches(jparams, params):
    feats = random_feats(CFG, B=4, T=16, seed=9)
    want = DecodeEngine(params, PCFG, ST, language_token_ids=TEST_LANG_IDS).detect_language(feats)
    mesh = _cpu_mesh(2)
    eng = DecodeEngine(shard_params(params, mesh), PCFG, ST, language_token_ids=TEST_LANG_IDS)
    try:
        got = eng.detect_language(shard_batch(feats, mesh))
    finally:
        eng.close()
    jmesh = jax_make_mesh(dp=2, tp=1)
    jeng = JaxEngine(jax_shard_params(jparams, jmesh), CFG, TEST_ST, language_token_ids=TEST_LANG_IDS)
    jax_out = jeng.detect_language(jax_shard_batch(feats, jmesh))
    np.testing.assert_allclose(got, want, atol=1e-5)
    np.testing.assert_allclose(got, np.asarray(jax_out), atol=1e-5)


def test_speculative_on_dp2_tp2(params):
    """Speculative decoding on dp2 x tp2 (its half of this test; DecodeEngine
    runs tp, test_torch_tensor_parallel.py): each replica's draft is a
    TPParams over its target's group, and the window's tokens equal the
    one-device speculative engine's.  A draft over another group raises."""
    from norma_tpu_torch.model import init_params
    from norma_tpu_torch.parallel.collectives import LocalGroup, TPParams

    dcfg = port_cfg(tiny_config(d_model=64, encoder_attention_heads=4, decoder_attention_heads=4, decoder_layers=1))
    draft = init_params(dcfg, seed=5)
    mesh = _cpu_mesh(2, 2)
    sp, sd = shard_params(params, mesh), shard_params(draft, mesh)
    audio = np.random.default_rng(2).standard_normal((4, 16000)).astype(np.float32) * 0.1
    langs = [LANG, -1, LANG, LANG]
    want, winfo = SpeculativeEngine(params, PCFG, draft, dcfg, ST, language_token_ids=TEST_LANG_IDS).transcribe_window(
        audio, langs, seed=0)
    eng = SpeculativeEngine(sp, PCFG, sd, dcfg, ST, language_token_ids=TEST_LANG_IDS)
    try:
        assert isinstance(eng, DataParallelEngine) and len(eng.replicas) == 2
        for r in eng.replicas:
            assert r.engine._group.size == 2 and len(r.engine._drp) == 2
        got, info = eng.transcribe_window(audio, langs, seed=0)
    finally:
        eng.close()
    assert [None if r is None else r.tokens for r in got] == [None if r is None else r.tokens for r in want]
    assert list(info["langs"]) == list(winfo["langs"])
    target = TPParams(sp.ranks(0), [0, 1], LocalGroup(["cpu"] * 2))
    other = TPParams(sd.ranks(0), [0, 1], LocalGroup(["cpu"] * 2))
    with pytest.raises(NormaError, match="same group"):
        SpeculativeEngine(target, PCFG, other, dcfg, ST, language_token_ids=TEST_LANG_IDS)


def test_mesh_argument_must_be_the_params_mesh(params):
    sp = shard_params(params, _cpu_mesh(2))
    with pytest.raises(NormaError, match="not the params' mesh"):
        DecodeEngine(sp, PCFG, ST, language_token_ids=TEST_LANG_IDS, mesh=_cpu_mesh(3))
    with pytest.raises(NormaError, match="shard_params"):
        DecodeEngine(params, PCFG, ST, language_token_ids=TEST_LANG_IDS, mesh=_cpu_mesh(2))
    eng = DecodeEngine(sp, PCFG, ST, language_token_ids=TEST_LANG_IDS, mesh=_cpu_mesh(2))
    eng.close()


def test_single_device_engine_keeps_kernel_config(params):
    kcfg = PCFG.with_(cross_kv_impl="kernel", self_kv_impl="kernel")
    eng = DecodeEngine(params, kcfg, ST, language_token_ids=TEST_LANG_IDS)
    assert type(eng) is DecodeEngine
    assert eng.cfg.cross_kv_impl == "kernel" and eng.cfg.self_kv_impl == "kernel"


def test_replicas_own_their_state(params):
    """Each replica has its own engine state: kernel params, device
    programs, graph pool and side stream are per-engine attributes; each
    replica's run_loop makes its one host read."""
    eng = DecodeEngine(shard_params(params, _cpu_mesh(2)), PCFG, ST, language_token_ids=TEST_LANG_IDS)
    try:
        a, b = (r.engine for r in eng.replicas)
        assert a is not b and a._programs is not b._programs
        assert len({id(r._pool) for r in eng.replicas}) == 2  # a worker thread each
        feats = random_feats(CFG, B=2, T=16, seed=3)
        eng.run_loop(eng.prefill(feats, LANG), 0.0, 0)
        assert eng.host_syncs == a.host_syncs + b.host_syncs and a.host_syncs == b.host_syncs == 2  # prefill, loop
    finally:
        eng.close()
