"""The dp carry keeps the kernel operating point (the twin of
tests/test_kernel_mesh_shardmap.py), on the CPU over virtual devices.

The JAX package runs its single-device Pallas program per device under
``shard_map`` over 'dp' (kernels in interpret mode here, through
``NORMA_XKV_KERNEL_INTERPRET`` / ``NORMA_SELF_KERNEL_INTERPRET``); the
port runs one single-device replica engine per dp position, each with the
kernel config (its kernel wrappers take their plain versions on CPU
tensors).  Pinned:
  - every replica keeps the kernel config, and the dp window's tokens equal
    the single-device engine's and JAX's dp-mesh engine's;
  - the detection path on the mesh;
  - params split over tp keep the kernel config on every rank (JAX falls
    back to XLA twins), at dp2 x tp2 and for a batch that does not divide
    over dp; speculative decoding on the same tp-sharded params, with the
    cross impl speculation allows, gives the one-device engine's tokens;
  - a batch that does not divide over dp runs whole on the first replica;
  - the device count of params takes the maximum over placements, and
    counts virtual devices.

Tolerance: greedy tokens equal (confident weights: rung 0 accepts).
"""

import jax
import numpy as np
import pytest
import torch

from helpers import TEST_LANG_IDS, TEST_ST, confident_params, texty_config
from torch_port_helpers import port_cfg, port_params, port_st

from norma_tpu.decode import DecodeEngine as JaxEngine
from norma_tpu.parallel import make_mesh as jax_make_mesh
from norma_tpu.parallel import shard_batch as jax_shard_batch
from norma_tpu.parallel import shard_params as jax_shard_params
from norma_tpu_torch.decode import DecodeEngine
from norma_tpu_torch.frontend.mel import prepare_audio
from norma_tpu_torch.parallel import make_mesh, shard_batch, shard_params
from norma_tpu_torch.utils import params_device_count, params_platform, params_replicated_on_mesh

KCFG_KW = dict(encoder_attn_impl="jax_flash", cross_kv_impl="kernel", self_kv_impl="kernel")
ST = port_st(TEST_ST)


@pytest.fixture()
def interp_escapes(monkeypatch):
    monkeypatch.setenv("NORMA_XKV_KERNEL_INTERPRET", "1")
    monkeypatch.setenv("NORMA_SELF_KERNEL_INTERPRET", "1")


@pytest.fixture(scope="module")
def setup():
    cfg = texty_config(**KCFG_KW)
    jparams = confident_params(cfg)
    return cfg, jparams, port_params(jparams)


def _audio(cfg, b=8, seconds=1.0):
    rng = np.random.default_rng(0)
    sr = 16_000
    t = np.arange(int(sr * seconds)) / sr
    base = 0.1 * np.sin(2 * np.pi * 330.0 * t)
    raw = [(base + 0.01 * rng.standard_normal(t.size)).astype(np.float32) for _ in range(b)]
    return np.stack([prepare_audio(a, n_frames=2 * cfg.max_source_positions) for a in raw])


def _tokens(results):
    return [None if r is None else r.tokens for r in results]


def _cpu_mesh(dp, tp=1):
    return make_mesh(dp=dp, tp=tp, devices=["cpu"] * (dp * tp))


def test_dp_mesh_carries_kernels_and_matches_single_device(setup, interp_escapes):
    cfg, jparams, params = setup
    pcfg = port_cfg(cfg)
    audio = _audio(cfg, 8)
    langs = np.full(8, TEST_LANG_IDS[0], np.int32)
    one = DecodeEngine(params, pcfg, ST, language_token_ids=TEST_LANG_IDS, quantize_cross_kv=True)
    want, _ = one.transcribe_window(audio, langs, seed=0)

    mesh = _cpu_mesh(2)
    e_dp = DecodeEngine(shard_params(params, mesh), pcfg, ST, language_token_ids=TEST_LANG_IDS,
                        quantize_cross_kv=True, mesh=mesh)
    try:
        for r in e_dp.replicas:
            c = r.engine.cfg
            assert (c.cross_kv_impl, c.self_kv_impl, c.encoder_attn_impl) == ("kernel", "kernel", "jax_flash")
            assert r.engine.quantize_cross_kv is True
        got, _ = e_dp.transcribe_window(shard_batch(audio, mesh), langs, seed=0)
        # Each replica's rows equal a single-device engine's on the same rows.
        half, _ = one.transcribe_window(audio[4:], langs[4:], seed=0)
    finally:
        e_dp.close()

    jmesh = jax_make_mesh(dp=2, tp=1, devices=jax.devices()[:2])
    j_dp = JaxEngine(jax_shard_params(jparams, jmesh), cfg, TEST_ST, language_token_ids=TEST_LANG_IDS,
                     quantize_cross_kv=True, mesh=jmesh)
    jax_out, _ = j_dp.transcribe_window(jax_shard_batch(audio, jmesh), langs, seed=0)

    assert _tokens(got) == _tokens(want) == _tokens(jax_out)
    assert _tokens(got[4:]) == _tokens(half)
    assert all(t is not None and len(t) > 3 for t in _tokens(got))  # text was decoded


def test_dp_mesh_detect_path_carries(setup):
    cfg, _, params = setup
    audio = _audio(cfg, 4)
    mesh = _cpu_mesh(2)
    e_dp = DecodeEngine(shard_params(params, mesh), port_cfg(cfg), ST, language_token_ids=TEST_LANG_IDS,
                        quantize_cross_kv=True, mesh=mesh)
    try:
        out, info = e_dp.transcribe_window(audio, np.full(4, -1, np.int32), seed=0)
    finally:
        e_dp.close()
    one = DecodeEngine(params, port_cfg(cfg), ST, language_token_ids=TEST_LANG_IDS, quantize_cross_kv=True)
    want, want_info = one.transcribe_window(audio, np.full(4, -1, np.int32), seed=0)
    assert len(out) == 4 and all(int(l) in TEST_LANG_IDS for l in info["langs"])
    assert list(info["langs"]) == list(want_info["langs"]) and _tokens(out) == _tokens(want)
    np.testing.assert_allclose(info["lang_probs"], want_info["lang_probs"], atol=1e-5)


def test_tp_sharded_params_raise(setup, interp_escapes):
    """The twin of JAX's test_tp_sharded_params_still_fall_back: JAX falls
    back to XLA twins on tp-sharded params; the port keeps the kernel config
    on every rank, and its dp2 x tp2 window equals the one-device engine's.
    Speculative decoding on the same tp-sharded params (a self-draft, the
    int8 cross-K/V on the einsum impl: the kernel layout is single-query)
    gives the one-device speculative engine's tokens."""
    cfg, _, params = setup
    pcfg = port_cfg(cfg)
    mesh = _cpu_mesh(2, 2)
    audio = _audio(cfg, 4)
    langs = np.full(4, TEST_LANG_IDS[0], np.int32)
    e = DecodeEngine(shard_params(params, mesh), pcfg, ST, language_token_ids=TEST_LANG_IDS,
                     quantize_cross_kv=True, mesh=mesh)
    try:
        for r in e.replicas:
            c = r.engine.cfg
            assert (c.cross_kv_impl, c.self_kv_impl, c.encoder_attn_impl) == ("kernel", "kernel", "jax_flash")
            assert r.engine._group.size == 2
        got, _ = e.transcribe_window(shard_batch(audio, mesh), langs, seed=0)
    finally:
        e.close()
    want, _ = DecodeEngine(params, pcfg, ST, language_token_ids=TEST_LANG_IDS,
                           quantize_cross_kv=True).transcribe_window(audio, langs, seed=0)
    assert _tokens(got) == _tokens(want) and all(t is not None and len(t) > 3 for t in _tokens(got))
    from norma_tpu_torch.decode import SpeculativeEngine

    scfg = pcfg.with_(cross_kv_impl="einsum")
    sp = shard_params(params, mesh)
    es = SpeculativeEngine(sp, scfg, sp, scfg, ST, language_token_ids=TEST_LANG_IDS, quantize_cross_kv=True)
    try:
        assert all(r.engine._group.size == 2 and r.engine._drp[0] is r.engine._rp[0] for r in es.replicas)
        s_got, _ = es.transcribe_window(shard_batch(audio, mesh), langs, seed=0)
    finally:
        es.close()
    s_want, _ = SpeculativeEngine(params, scfg, params, scfg, ST, language_token_ids=TEST_LANG_IDS,
                                  quantize_cross_kv=True).transcribe_window(audio, langs, seed=0)
    assert _tokens(s_got) == _tokens(s_want) and all(t is not None and len(t) > 3 for t in _tokens(s_got))


def test_non_divisible_batch_runs_on_one_tp_group(setup):
    """B=1 on dp2 x tp2 (the (2, 2) twin of JAX's
    test_non_divisible_batch_uses_gspmd_twin): the whole batch on the first
    dp position's tp group, its tokens the one-device engine's."""
    cfg, _, params = setup
    mesh = _cpu_mesh(2, 2)
    e = DecodeEngine(shard_params(params, mesh), port_cfg(cfg), ST, language_token_ids=TEST_LANG_IDS, mesh=mesh)
    try:
        audio = _audio(cfg, 1)
        out, _ = e.transcribe_window(audio, [TEST_LANG_IDS[0]], seed=0)
        steps = [r.engine.decode_steps for r in e.replicas]
    finally:
        e.close()
    want, _ = DecodeEngine(params, port_cfg(cfg), ST, language_token_ids=TEST_LANG_IDS).transcribe_window(
        audio, [TEST_LANG_IDS[0]], seed=0)
    assert len(out) == 1 and _tokens(out) == _tokens(want)
    assert steps[0] > 0 and steps[1] == 0


def test_non_divisible_batch_runs_on_one_replica(setup):
    cfg, _, params = setup
    mesh = _cpu_mesh(2)
    e_dp = DecodeEngine(shard_params(params, mesh), port_cfg(cfg), ST, language_token_ids=TEST_LANG_IDS, mesh=mesh)
    try:
        audio = _audio(cfg, 1)
        out, _ = e_dp.transcribe_window(audio, [TEST_LANG_IDS[0]], seed=0)  # B=1: not divisible by dp=2
        steps = [r.engine.decode_steps for r in e_dp.replicas]
    finally:
        e_dp.close()
    want, _ = DecodeEngine(params, port_cfg(cfg), ST, language_token_ids=TEST_LANG_IDS).transcribe_window(
        audio, [TEST_LANG_IDS[0]], seed=0)
    assert len(out) == 1 and out[0] is not None and _tokens(out) == _tokens(want)
    assert steps[0] > 0 and steps[1] == 0


def test_heterogeneous_placement_counts_max_devices(setup):
    _, _, params = setup
    wide = shard_params(params, _cpu_mesh(1, 2))  # one leaf set over two (virtual) positions
    assert params_device_count({"a": torch.zeros(4), "b": wide}) == 2
    assert params_device_count(params) == 1
    # Positions, not distinct devices: a card (or the CPU) named twice counts twice.
    mesh = _cpu_mesh(4)
    sp = shard_params(params, mesh)
    assert params_device_count(sp) == 4
    assert params_replicated_on_mesh(sp, mesh) and not params_replicated_on_mesh(sp, _cpu_mesh(2))
    assert not params_replicated_on_mesh(wide, wide.mesh)  # split over tp
    assert not params_replicated_on_mesh(params, mesh)
    assert params_replicated_on_mesh(params, _cpu_mesh(1))
    assert params_platform(sp) == "cpu" and params_platform({"a": torch.zeros(1)}) == "cpu"
