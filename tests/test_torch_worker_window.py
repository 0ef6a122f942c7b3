"""A tp rank's window in worker processes (norma_tpu_torch.parallel.workers)
on the CPU: the cards' NCCL path on gloo.

  - a tp=2 ``WorkerEngine`` window (dispatch, then fetch) takes the
    device-loop path: each rank's loops are device-tested
    (``_device_while``), it makes one host read a window, and its results
    equal the same ranks' ``transcribe_window_eager``, a ``LocalGroup``
    tp=2 engine's and the JAX package's window at f32 greedy, at B=1
    (rungs as rows) and padded B=8 (sequential rungs);
  - ``ProcessGroup.all_gather`` over four gloo processes with a ragged
    split (a vocabulary 4 does not divide, as 51866 over 4) equals
    ``LocalGroup``'s along either axis;
  - a window that does not end raises ``NormaError`` in the parent at the
    fetch's deadline, naming each rank, not a hang;
  - a ``ProcessGroup`` collective outside a capture waits until the graphs
    in flight (``graph_launched``) are done, and raises ``NormaError`` at
    the group's timeout when one never ends.

The module spawns the worker engine once (``workers``); every spawn runs
under ``SPAWN_S``.
"""

import multiprocessing
import os
import tempfile
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import TEST_LANG_IDS, TEST_ST, confident_params, texty_config
from torch_port_helpers import port_cfg, port_params, port_st

from norma_tpu.decode.engine import DecodeEngine as JaxEngine
from norma_tpu_torch.decode import DecodeEngine
from norma_tpu_torch.errors import NormaError
from norma_tpu_torch.frontend.mel import prepare_audio
from norma_tpu_torch.parallel import make_mesh, shard_params
from norma_tpu_torch.parallel import workers as workers_mod
from norma_tpu_torch.parallel.collectives import LocalGroup, ProcessGroup
from norma_tpu_torch.parallel.sharding import split_sizes
from norma_tpu_torch.parallel.workers import WorkerEngine

SPAWN_S = 120.0
TCFG = texty_config()
PCFG = port_cfg(TCFG)
ST = port_st(TEST_ST)
LANG = TEST_LANG_IDS[0]


@pytest.fixture(scope="module")
def texty():
    jp = confident_params(TCFG, seed=3)
    return jp, port_params(jp)


@pytest.fixture(scope="module")
def workers(texty):
    sp = shard_params(texty[1], make_mesh(tp=2, devices=["cpu"] * 2))
    w = WorkerEngine(DecodeEngine, sp.ranks(0), ["cpu", "cpu"], (PCFG, ST), dict(language_token_ids=TEST_LANG_IDS),
                     spawn_timeout_s=SPAWN_S)
    w.on_ranks(_count_device_whiles)
    yield w
    w.close()
    assert all(not p.is_alive() for p in w._procs)


def _audio(B, seed):
    rng = np.random.default_rng(seed)
    k = 2 * TCFG.max_source_positions * 160
    return np.stack([prepare_audio((0.1 * rng.standard_normal(k)).astype(np.float32),
                                   n_frames=2 * TCFG.max_source_positions) for _ in range(B)])


# Functions of a rank's engine, run in its worker (WorkerEngine.on_ranks).

def _count_device_whiles(engine):
    """Count the engine's device-tested loops (``_device_while`` calls)."""
    inner = engine._device_while
    engine.device_whiles = 0

    def spy(buf, pos_end, body):
        engine.device_whiles += 1
        return inner(buf, pos_end, body)

    engine._device_while = spy


def _counters(engine):
    return engine.host_syncs, engine.device_whiles, engine.decode_steps


def _rows(drs):
    """Each row's tokens and both floats' bits (a grammar deadlock's NaN
    average compares equal to itself)."""
    bits = lambda x: np.float64(x).tobytes()  # noqa: E731
    return [d and (d.tokens, bits(d.avg_logprob), bits(d.no_speech_prob)) for d in drs]


@pytest.mark.parametrize("B", [1, 8], ids=["B1_rungs_as_rows", "B8_sequential"])
def test_worker_window_takes_the_device_loops(texty, workers, B):
    jp, pp = texty
    audio = _audio(B, seed=7)
    na = None if B == 1 else 5
    before = workers.on_ranks(_counters)
    got, gi = workers.transcribe_window_fetch(workers.transcribe_window_async(audio, [LANG] * B, 2, n_active=na))
    after = workers.on_ranks(_counters)
    for (h0, w0, s0), (h1, w1, s1) in zip(before, after):
        assert h1 - h0 == 1  # one host read a window on each rank: its fetch
        assert w1 > w0 and s1 > s0  # its loops were device-tested, and decoded
    assert all(d is not None and d.tokens for d in got[: na or 1])
    eager, ei = workers.call("transcribe_window_eager", audio, [LANG] * B, 2, n_active=na)
    assert _rows(got) == _rows(eager)
    np.testing.assert_array_equal(gi["langs"], ei["langs"])
    local = DecodeEngine(shard_params(pp, make_mesh(tp=2, devices=["cpu"] * 2)), PCFG, ST,
                         language_token_ids=TEST_LANG_IDS)
    try:
        want, _ = local.transcribe_window(audio, [LANG] * B, 2, n_active=na)
    finally:
        local.close()
    assert _rows(got) == _rows(want)
    je = JaxEngine(jp, TCFG, TEST_ST, language_token_ids=TEST_LANG_IDS)
    jdrs, _ = je.transcribe_window(jnp.asarray(audio), [LANG] * B, 2, n_active=na)
    assert [d and d.tokens for d in got] == [d and d.tokens for d in jdrs]
    np.testing.assert_allclose([d.avg_logprob for d in got[: na or 1]], [d.avg_logprob for d in jdrs[: na or 1]],
                               atol=2e-4)


# -- the ragged gather over four processes ---------------------------------------

V = 1001  # split_sizes(1001, 4) == [251, 251, 251, 248], as 51866 over 4 is ragged


def _shard(rank, dim):
    sizes = split_sizes(V, 4)
    g = torch.Generator().manual_seed(300 + rank)
    shape = [3, 2]
    shape.insert(dim % 3, sizes[rank])
    return torch.randn(*shape, generator=g)


def _gather_rank(rank, path, q):
    torch.set_num_threads(1)
    g = ProcessGroup(rank, 4, "cpu", path, timeout_s=SPAWN_S)
    out = {dim: g.all_gather([_shard(rank, dim)], dim, split_sizes(V, 4))[0].numpy() for dim in (0, -1)}
    q.put((rank, out))
    g.close()


def test_ragged_all_gather_over_four_processes():
    ctx = multiprocessing.get_context("spawn")
    q = ctx.Queue()
    with tempfile.TemporaryDirectory() as d:
        procs = [ctx.Process(target=_gather_rank, args=(r, os.path.join(d, "store"), q), daemon=True)
                 for r in range(4)]
        for p in procs:
            p.start()
        try:
            got = dict(q.get(timeout=SPAWN_S) for _ in procs)
        finally:
            for p in procs:
                p.join(timeout=SPAWN_S)
                if p.is_alive():
                    p.kill()
    local = LocalGroup(["cpu"] * 4)
    assert split_sizes(V, 4) == [251, 251, 251, 248]
    for dim in (0, -1):
        want = local.all_gather([_shard(r, dim) for r in range(4)], dim, split_sizes(V, 4))[0]
        assert want.shape[dim] == V
        for r in range(4):
            assert np.array_equal(got[r][dim], want.numpy()), (r, dim)


# -- the fetch's deadline ---------------------------------------------------------


class _Never:
    def query(self):
        return False


class _Stalled:
    """A dispatched window whose device work never ends."""

    done = _Never()


class StallEngine(DecodeEngine):
    """An engine whose dispatched windows never end, in a worker whose
    fetch deadline is cut to one second."""

    def __init__(self, params, cfg, st, **kwargs):
        super().__init__(params, cfg, st, **kwargs)
        workers_mod.FETCH_TIMEOUT_S = 1.0

    def transcribe_window_async(self, audio, langs, seed, n_active=None):
        return _Stalled()


def test_fetch_deadline_raises(texty):
    sp = shard_params(texty[1], make_mesh(tp=2, devices=["cpu"] * 2))
    w = WorkerEngine(StallEngine, sp.ranks(0), ["cpu", "cpu"], (PCFG, ST), dict(language_token_ids=TEST_LANG_IDS),
                     spawn_timeout_s=SPAWN_S)
    try:
        pending = w.transcribe_window_async(_audio(1, seed=0), [LANG], 0)
        t0 = time.monotonic()
        with pytest.raises(NormaError, match="not done after 1 s") as err:
            w.transcribe_window_fetch(pending)
        assert time.monotonic() - t0 < 30.0
        assert "rank 0" in str(err.value) and "rank 1" in str(err.value) and "WHILE passes" in str(err.value)
    finally:
        w.close()


# -- no collective outside a graph while one is in flight --------------------------


class _DoneAfter:
    """A graph's done event that reports done from its ``n``-th query on."""

    def __init__(self, n):
        self.n = n

    def query(self):
        self.n -= 1
        return self.n <= 0


def _quiet_rank(path, q):
    torch.set_num_threads(1)
    g = ProcessGroup(0, 1, "cpu", path, timeout_s=2.0)
    out = {}
    for name, call in (("sum", lambda: g.all_reduce_sum([torch.ones(2)])),
                       ("max", lambda: g.all_reduce_max([torch.ones(2)])),
                       ("gather", lambda: g.all_gather([torch.ones(3, 2)], 0, [3]))):
        events = [_DoneAfter(4), _DoneAfter(2)]
        for e in events:
            g.graph_launched(e)
        call()
        out[name] = [e.n <= 0 for e in events]  # each reported done before the collective ran
    g.graph_launched(_Never())
    t0 = time.monotonic()
    try:
        g.all_reduce_sum([torch.ones(2)])
        out["never"] = None
    except NormaError as e:
        out["never"] = (str(e), time.monotonic() - t0)
    q.put(out)
    g.close()


def test_collective_waits_for_graphs_in_flight():
    ctx = multiprocessing.get_context("spawn")
    q = ctx.Queue()
    with tempfile.TemporaryDirectory() as d:
        p = ctx.Process(target=_quiet_rank, args=(os.path.join(d, "store"), q), daemon=True)
        p.start()
        try:
            out = q.get(timeout=SPAWN_S)
        finally:
            p.join(timeout=SPAWN_S)
            if p.is_alive():
                p.kill()
    assert out["sum"] == out["max"] == out["gather"] == [True, True]
    assert out["never"] is not None, "a collective ran while a graph was still in flight"
    msg, waited = out["never"]
    assert "not done after 2 s" in msg and 2.0 <= waited < 30.0
