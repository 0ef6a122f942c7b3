"""The tp group's collectives and the worker processes
(norma_tpu_torch.parallel.collectives / workers) on the CPU.

  - ``LocalGroup`` against a two-process gloo ``ProcessGroup``: the same
    sums, maxima and ragged gathers, bit for bit;
  - the group is chosen by the devices;
  - a ``WorkerEngine`` (gloo workers, tp=2) decodes what one engine does,
    its ranks bit for bit; the dp engine with every position in worker
    processes (``WorkerPositions``: on the CPU, where the devices never
    choose them) decodes what the in-process one does;
  - the mesh's devices choose the workers (tp above 1 over distinct
    cards), and such a mesh's shards stay on the host for them;
  - a dead worker, a failing call and a worker that never gets ready raise
    ``NormaError`` in the parent.

Every spawn runs under its own time limit (``SPAWN_S``).
"""

import multiprocessing
import os
import tempfile
import time

import numpy as np
import pytest
import torch

from helpers import TEST_LANG_IDS, TEST_ST, random_feats, tiny_config
from torch_port_helpers import port_cfg, port_params, port_st

from norma_tpu.model import init_params as jax_init
from norma_tpu_torch.decode import DecodeEngine
from norma_tpu_torch.errors import NormaError
from norma_tpu_torch.parallel import make_mesh, shard_params
from norma_tpu_torch.parallel.collectives import LocalGroup, ProcessGroup, first
from norma_tpu_torch.parallel.data_parallel import DataParallelEngine
from norma_tpu_torch.parallel.sharding import in_workers, split_sizes
from norma_tpu_torch.parallel.workers import WorkerEngine

SPAWN_S = 120.0  # each spawned process must be ready, and each exchange done, within this
CFG = tiny_config(d_model=64, encoder_attention_heads=4, decoder_attention_heads=4)
PCFG = port_cfg(CFG)
ST = port_st(TEST_ST)
LANG = TEST_LANG_IDS[0]


@pytest.fixture(scope="module")
def params():
    return port_params(jax_init(CFG, seed=0))


def _inputs(rank):
    g = torch.Generator().manual_seed(100 + rank)
    sizes = split_sizes(1002, 2)
    return dict(
        sum=torch.randn(3, 5, generator=g),
        max=torch.randn(3, 1, generator=g),
        gather=torch.randn(3, sizes[rank], generator=g),
    )


def _gloo_rank(rank, path, q):
    torch.set_num_threads(1)
    g = ProcessGroup(rank, 2, "cpu", path, timeout_s=SPAWN_S)
    x = _inputs(rank)
    out = dict(
        sum=g.all_reduce_sum([x["sum"].clone()])[0],
        max=g.all_reduce_max([x["max"].clone()])[0],
        gather=g.all_gather([x["gather"]], -1, split_sizes(1002, 2))[0],
    )
    q.put((rank, {k: v.numpy() for k, v in out.items()}))
    g.close()


def test_local_group_matches_gloo_processes():
    ctx = multiprocessing.get_context("spawn")
    q = ctx.Queue()
    with tempfile.TemporaryDirectory() as d:
        procs = [ctx.Process(target=_gloo_rank, args=(r, os.path.join(d, "store"), q), daemon=True) for r in range(2)]
        for p in procs:
            p.start()
        try:
            got = dict(q.get(timeout=SPAWN_S) for _ in procs)
        finally:
            for p in procs:
                p.join(timeout=SPAWN_S)
                if p.is_alive():
                    p.kill()
    local = LocalGroup(["cpu", "cpu"])
    xs = [_inputs(r) for r in range(2)]
    want = dict(
        sum=local.all_reduce_sum([x["sum"] for x in xs])[0],
        max=local.all_reduce_max([x["max"] for x in xs])[0],
        gather=local.all_gather([x["gather"] for x in xs], -1, split_sizes(1002, 2))[0],
    )
    assert want["gather"].shape == (3, 1002)
    for r in range(2):
        for k, v in want.items():
            assert np.array_equal(got[r][k], v.numpy()), (r, k)


def test_local_group_checks_and_run():
    g = LocalGroup(["cpu"] * 3)
    ts = [torch.full((2,), float(i)) for i in range(3)]
    assert torch.equal(g.run("sum", ts)[2], torch.full((2,), 3.0))
    assert torch.equal(g.run("max", ts)[0], torch.full((2,), 2.0))
    assert g.run("gather", [torch.ones(1, 4), torch.ones(1, 4), torch.ones(1, 2)], dim=-1, total=10)[0].shape == (1, 10)
    assert g.collectives == 3
    with pytest.raises(ValueError, match="widths"):
        g.all_gather(ts, -1, [1, 1, 1])
    with pytest.raises(ValueError, match="unknown collective"):
        g.run("mean", ts)


def test_split_sizes_as_gspmd_pads():
    assert split_sizes(51866, 4) == [12967, 12967, 12967, 12965]
    assert split_sizes(51866, 2) == [25933, 25933]
    assert split_sizes(1280, 4) == [320] * 4


def test_group_chosen_by_devices(params):
    """The mesh's devices choose: ranks on one device share a LocalGroup in
    this process; a tp group over distinct devices that are not all cards
    (or the CPU) has no group and raises."""
    mesh = make_mesh(dp=2, tp=2, devices=["cpu"] * 4)
    eng = DecodeEngine(shard_params(params, mesh), PCFG, ST, language_token_ids=TEST_LANG_IDS)
    try:
        assert all(isinstance(r.engine._group, LocalGroup) and not r.remote for r in eng.replicas)
    finally:
        eng.close()
    with pytest.raises(NormaError, match="one device"):
        LocalGroup(["cuda:0", "cuda:1"])
    with pytest.raises(NormaError, match="a tp group is on one device"):
        DecodeEngine(shard_params(params, make_mesh(tp=2, devices=["cpu", "meta"])), PCFG, ST,
                     language_token_ids=TEST_LANG_IDS)


def test_worker_engine_tp2_over_gloo(params):
    feats = random_feats(CFG, B=4, T=16, seed=7)
    ref = DecodeEngine(params, PCFG, ST, language_token_ids=TEST_LANG_IDS)
    want = ref.run_loop(ref.prefill(feats, LANG), 0.0, 0)
    sp = shard_params(params, make_mesh(tp=2, devices=["cpu"] * 2))
    t0 = time.monotonic()
    w = WorkerEngine(DecodeEngine, sp.ranks(0), ["cpu", "cpu"], (PCFG, ST), dict(language_token_ids=TEST_LANG_IDS),
                     spawn_timeout_s=SPAWN_S)
    try:
        assert time.monotonic() - t0 < SPAWN_S
        state = w.prefill(feats, LANG)
        got = w.run_loop(state, 0.0, 0)
        again = w.run_loop(state, 0.0, 0)  # a prefill state serves several loops (the ladder)
        assert [r.tokens for r in got] == [r.tokens for r in want] == [r.tokens for r in again]
        assert w.decode_steps > 0 and w.host_syncs > 0
        # A plain engine's worker splits its window (dispatch, fetch) and has
        # no speculative fallback to warm.
        assert w.supports_async_window is True and not hasattr(w, "warmup_fallback")
        launches = w.launches(reset=True)
        assert len(launches) == 2 and set(launches[0]) >= {"sample_step", "w8_matmul"}
        audio = np.random.default_rng(0).standard_normal((2, 16000)).astype(np.float32) * 0.1
        res, _ = w.transcribe_window_fetch(w.transcribe_window_async(audio, [LANG] * 2, 0))
        one, _ = ref.transcribe_window(audio, [LANG] * 2, 0)
        assert [r.tokens for r in res] == [r.tokens for r in one]
        with pytest.raises(NormaError, match="failed"):
            w.call("transcribe_window", audio[:, :10], [LANG] * 2, 0)  # too short: the engine raises in the worker
        with pytest.raises(AttributeError):
            w.not_an_attribute
    finally:
        w.close()
    assert all(not p.is_alive() for p in w._procs)


def test_dead_worker_raises_in_parent(params):
    sp = shard_params(params, make_mesh(dp=1, devices=["cpu"]))
    w = WorkerEngine(DecodeEngine, sp.ranks(0), ["cpu"], (PCFG, ST), dict(language_token_ids=TEST_LANG_IDS),
                     spawn_timeout_s=SPAWN_S)
    try:
        proc = w._procs[0]
        proc.kill()
        proc.join(timeout=SPAWN_S)
        with pytest.raises(NormaError, match="died|closed"):
            w.detect_language(random_feats(CFG, B=1, T=16, seed=0))
    finally:
        w.close()


class SlowEngine(DecodeEngine):
    """An engine whose construction never ends in time."""

    def __init__(self, params, cfg, st, **kwargs):
        time.sleep(600)


def test_spawn_timeout_raises(params):
    sp = shard_params(params, make_mesh(dp=1, devices=["cpu"]))
    t0 = time.monotonic()
    with pytest.raises(NormaError, match="did not answer in 5 s"):
        WorkerEngine(SlowEngine, sp.ranks(0), ["cpu"], (PCFG, ST), {}, spawn_timeout_s=5.0)
    assert time.monotonic() - t0 < SPAWN_S


class WorkerPositions(DataParallelEngine):
    """A dp engine whose every position runs in worker processes: the
    cards' path, on the CPU's gloo."""

    _in_workers = staticmethod(lambda mesh: True)


def test_dp_engine_runs_cpu_positions_in_workers(params):
    """One worker process a position (gloo for its tp ranks), the results
    the in-process engine's."""
    feats = random_feats(CFG, B=4, T=16, seed=3)
    audio = np.random.default_rng(1).standard_normal((4, 16000)).astype(np.float32) * 0.1
    mesh = make_mesh(dp=2, tp=2, devices=["cpu"] * 4)
    sp = shard_params(params, mesh)
    local = DecodeEngine(sp, PCFG, ST, language_token_ids=TEST_LANG_IDS)
    remote = WorkerPositions(DecodeEngine, sp, PCFG, ST, language_token_ids=TEST_LANG_IDS)
    try:
        assert all(r.remote for r in remote.replicas) and not any(r.remote for r in local.replicas)
        sa, sb = local.prefill(feats, LANG), remote.prefill(feats, LANG)
        for (_, a), (_, b) in zip(sa["parts"], sb["parts"]):  # rank 0's logits come back from the workers
            np.testing.assert_array_equal(first(a["next_logits"]).numpy(), b["next_logits"])
        a = local.run_loop(sa, 0.0, 0)
        b = remote.run_loop(sb, 0.0, 0)
        assert [r.tokens for r in a] == [r.tokens for r in b]
        wa, ia = local.transcribe_window(audio, [-1, LANG, LANG, LANG], seed=0, n_active=3)
        wb, ib = remote.transcribe_window(audio, [-1, LANG, LANG, LANG], seed=0, n_active=3)
        assert [None if r is None else r.tokens for r in wa] == [None if r is None else r.tokens for r in wb]
        assert list(ia["langs"]) == list(ib["langs"])
        assert remote.graph_captures == 0 and remote.decode_steps > 0
    finally:
        local.close()
        remote.close()
    with pytest.raises(NormaError, match="a tp group is on one device"):
        DecodeEngine(shard_params(params, make_mesh(tp=2, devices=["cpu", "meta"])), PCFG, ST,
                     language_token_ids=TEST_LANG_IDS)


@pytest.mark.parametrize("dp,tp,devices,workers", [
    (1, 2, ["cuda:0", "cuda:1"], True),
    (2, 2, ["cuda:0", "cuda:1", "cuda:2", "cuda:3"], True),
    (2, 1, ["cuda:0", "cuda:1"], False),  # dp on distinct cards: threads
    (1, 2, ["cuda:0", "cuda:0"], False),  # virtual devices: one process
    (2, 2, ["cpu"] * 4, False),
])
def test_devices_choose_the_workers(params, dp, tp, devices, workers):
    """Worker processes run exactly the meshes whose tp ranks are on
    distinct cards; their shards stay on the host (each worker puts its
    own on its card), so the parent holds no copy on the cards."""
    mesh = make_mesh(dp=dp, tp=tp, devices=devices)
    assert in_workers(mesh) is workers
    if workers:  # slicing on the host touches no card: this runs on the CPU
        sp = shard_params(params, mesh)
        assert sp.device == torch.device("cuda", 0)
        for i in range(dp):
            for shard in sp.ranks(i):
                assert shard["decoder"]["tok_emb"].device.type == "cpu"


class FlagsEngine(DecodeEngine):
    """An engine that records the process-wide numerics it was built under."""

    def __init__(self, params, cfg, st, **kwargs):
        super().__init__(params, cfg, st, **kwargs)
        self.tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)


def test_workers_take_the_parents_numerics(params, monkeypatch):
    """A worker computes under its parent's TF32 settings (cuDNN allows
    TF32 by default; a parent that turned it off must not get a worker
    whose convolutions round differently)."""
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    sp = shard_params(params, make_mesh(dp=1, devices=["cpu"]))
    w = WorkerEngine(FlagsEngine, sp.ranks(0), ["cpu"], (PCFG, ST), {}, spawn_timeout_s=SPAWN_S)
    try:
        assert w._call("get", "tf32") == (True, False)
    finally:
        w.close()
