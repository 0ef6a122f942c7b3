"""The window as one device program, on the CPU.

On CUDA a window is one CUDA graph per shape, its loops' stop tests WHILE
nodes on the device (``DecodeEngine._device_while``); on the CPU the same
structure runs eagerly, the conditions read on the host.  These tests
hold that structure:

  - (a) with the no-speech gate forced on the warm-up's silence, every
    row finishes before its first step, yet the warm-up runs the whole
    window structure (each loop's device-tested runs), and a live window
    afterwards, at B=1 and B=8, uses only window keys the warm-up used:
    what a capture records does not depend on the data;
  - (b) two ``transcribe_window_async`` calls before either fetch, fetched
    in order, equal the synchronous calls (results, packed layout and
    every loop's tokens), at t=0 and with the t>0 fallback forced;
  - (c) the seed as a device input: the t>0 rows for seeds 0 and 1 equal
    the per-step ``_token_loop_eager``'s for the same seeds, and differ
    from each other;
  - (d) tokens equal the JAX package's on ``texty_config`` at B=1 (six
    rungs as rows) and at padded B=8 (sequential rungs);
  - the loops' crops: a window's loops are one device-tested loop (one
    WHILE node on the card) a cache crop, each ending where its crop ends;
    the stop test's plain version;
  - a tp=2 engine over one process's ranks (a LocalGroup) takes the same
    structure: one host read a window, results equal to its per-step
    ``transcribe_window_eager``'s.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import TEST_LANG_IDS, TEST_ST, ToyTokenizer, confident_params, texty_config, tiny_config
from torch_port_helpers import n, port_cfg, port_params, port_st

from norma_tpu.decode.engine import DecodeEngine as JaxEngine
from norma_tpu.model import load as jload
from norma_tpu_torch.decode import DecodeEngine, LanguageState
from norma_tpu_torch.decode import engine as engine_mod
from norma_tpu_torch.frontend.mel import prepare_audio
from norma_tpu_torch.models.whisper import WhisperModel
from norma_tpu_torch.ops.loop_cond import loop_cond, loop_cond_torch
from norma_tpu_torch.parallel import make_mesh, shard_params

TCFG = texty_config()
LANG = TEST_LANG_IDS[0]


@pytest.fixture(scope="module")
def texty():
    jp = confident_params(TCFG, seed=3)
    return jp, port_params(jp)


def _engine(pp, cfg=TCFG):
    return DecodeEngine(pp, port_cfg(cfg), port_st(TEST_ST), language_token_ids=TEST_LANG_IDS)


def _audio(B, cfg=TCFG, seed=0):
    rng = np.random.default_rng(seed)
    k = 2 * cfg.max_source_positions * 160
    return np.stack([prepare_audio((0.1 * rng.standard_normal(k)).astype(np.float32),
                                   n_frames=2 * cfg.max_source_positions) for _ in range(B)])


def _record_structure(engine, keys):
    """Spy on the engine: each window appends (audio shape, detect, its
    device-tested loops as (rows, pos_end))."""
    ladder, dwhile = engine._ladder_impl, engine._device_while
    runs = []

    def ladder_spy(audio, langs, seed, active, *, detect, eager=False):
        runs.clear()
        out = ladder(audio, langs, seed, active, detect=detect, eager=eager)
        keys.append((tuple(audio.shape), detect, tuple(runs)))
        return out

    def while_spy(buf, pos_end, body):
        runs.append((buf.fin.shape[0], pos_end))
        return dwhile(buf, pos_end, body)

    engine._ladder_impl, engine._device_while = ladder_spy, while_spy


def _record_loops(engine, loops, inner=None):
    """Spy on ``_token_loop`` (or run ``inner`` in its place): each loop's
    (temperatures, tokens, lengths, logprob sums)."""
    inner = inner or engine._token_loop

    def spy(*a, **k):
        toks, nn, slp = inner(*a, **k)
        loops.append((a[9].tolist(), toks.clone(), nn.clone(), slp.clone()))
        return toks, nn, slp

    engine._token_loop = spy


def _same_loops(a, b):
    assert len(a) == len(b) > 0
    for (ta, *xa), (tb, *xb) in zip(a, b):
        assert ta == tb
        for x, y in zip(xa, xb):  # bit-equal; a deadlocked row's sum is NaN in both
            torch.testing.assert_close(x, y, rtol=0, atol=0, equal_nan=True)


# -- (a) the warm-up's silence under the no-speech gate ------------------------


def test_gated_warmup_covers_live_windows(texty, monkeypatch):
    _, pp = texty
    engine = _engine(pp)
    model = WhisperModel(engine, ToyTokenizer(), LanguageState(const=LANG))
    warm, live = [], []
    _record_structure(engine, warm)
    monkeypatch.setattr(engine_mod, "NO_SPEECH_THRESHOLD", -1.0)  # every probe fires
    for B in (1, 8):
        model.warmup(batch=B)
    assert engine.decode_steps == 0  # the gate finished every row before its first step
    assert {k[0][0] for k in warm} == {1, 8}
    assert all(k[2] for k in warm)  # yet every loop's device-tested runs were reached
    monkeypatch.undo()
    _record_structure(engine, live)
    audio = _audio(8)
    drs1, _ = engine.transcribe_window(audio[:1], [LANG], seed=3)
    drs8, _ = engine.transcribe_window(audio, [LANG] * 8, seed=4, n_active=5)
    assert engine.decode_steps > 0 and drs1[0] is not None and drs1[0].tokens
    assert all(d is not None for d in drs8[:5]) and drs8[5:] == [None] * 3
    assert len(live) == 2 and set(live) <= set(warm), sorted(set(live) - set(warm))


# -- (b) two windows in flight --------------------------------------------------

# Random weights at mtp 12 stop before the tiny timestamp space deadlocks,
# so avg_logprob stays finite and the default gate rejects rung 0: the t>0
# fallback runs (tests/test_torch_fused_window.py).
FCFG = tiny_config(max_target_positions=12)


@pytest.fixture(scope="module")
def failing():
    return port_params(jload.init_params(FCFG, seed=0))


@pytest.mark.parametrize("B", [1, 8], ids=["B1", "B8"])
@pytest.mark.parametrize("fallback", [False, True], ids=["t0", "t_gt_0"])
def test_two_windows_in_flight(texty, failing, B, fallback):
    cfg, pp = (FCFG, failing) if fallback else (TCFG, texty[1])
    audio = _audio(2 * B, cfg=cfg, seed=1)
    a1, a2 = audio[:B], audio[B:]
    na = None if B == 1 else 5
    sync, sync_loops = _engine(pp, cfg), []
    _record_loops(sync, sync_loops)
    want = [sync.transcribe_window(a, [LANG] * B, seed=s, n_active=na) for a, s in ((a1, 0), (a2, 9))]
    eng, loops = _engine(pp, cfg), []
    _record_loops(eng, loops)
    p1 = eng.transcribe_window_async(a1, [LANG] * B, seed=0, n_active=na)
    p2 = eng.transcribe_window_async(a2, [LANG] * B, seed=9, n_active=na)
    got = [eng.transcribe_window_fetch(p1), eng.transcribe_window_fetch(p2)]
    for (wd, wi), (gd, gi) in zip(want, got):
        np.testing.assert_equal([d and (d.tokens, d.avg_logprob, d.no_speech_prob) for d in gd],
                                [d and (d.tokens, d.avg_logprob, d.no_speech_prob) for d in wd])  # NaN-equal
        np.testing.assert_array_equal(wi["langs"], gi["langs"])
    _same_loops(sync_loops, loops)
    if B == 8:  # the sequential ladder: rungs 1-5 per window decode only after a rejection
        decoded = [bool((lp[2][:na] > 3).any()) for lp in loops if lp[0][0] > 0]
        assert len(decoded) == 10 and any(decoded) == fallback
    if not fallback:
        assert all(d is not None and d.tokens for drs, _ in got for d in drs[: na or 1])
    assert eng.host_syncs == 2  # one fetch each: the loops' tests are device work


# -- (c) the seed as a device input ---------------------------------------------


def test_device_seed_matches_eager_per_seed(failing):
    audio = _audio(3, cfg=FCFG, seed=2)
    rows = {}
    for seed in (0, 1):
        dev, dev_loops = _engine(failing, FCFG), []
        _record_loops(dev, dev_loops)
        dev.transcribe_window(audio, [LANG] * 3, seed=seed)
        eager, eager_loops = _engine(failing, FCFG), []
        _record_loops(eager, eager_loops, inner=eager._token_loop_eager)
        eager.transcribe_window(audio, [LANG] * 3, seed=seed)
        _same_loops(dev_loops, eager_loops)
        rows[seed] = [lp for lp in dev_loops if lp[0][0] > 0]
        assert len(rows[seed]) == 5 and any(bool((lp[2] > 3).any()) for lp in rows[seed])  # t>0 rungs decoded
    assert any(not torch.equal(a[1], b[1]) for a, b in zip(rows[0], rows[1])), "the seed did not reach the draws"


# -- (d) tokens against the JAX package ----------------------------------------


@pytest.mark.parametrize("B", [1, 8], ids=["B1_rungs_as_rows", "B8_sequential"])
def test_window_matches_jax(texty, B):
    jp, pp = texty
    audio = _audio(B, seed=5)
    na = None if B == 1 else 5
    je = JaxEngine(jp, TCFG, TEST_ST, language_token_ids=TEST_LANG_IDS)
    pe = _engine(pp)
    jpacked = np.asarray(je.transcribe_window_async(jnp.asarray(audio), [LANG] * B, 5, n_active=na)[0])
    pending = pe.transcribe_window_async(audio, [LANG] * B, 5, n_active=na)
    ppacked = n(pending[0])
    rows = na or 1
    T = TCFG.max_target_positions
    assert (ppacked[:rows, T + 2] == 0).all()  # the confident params pass the gate at rung 0
    np.testing.assert_array_equal(ppacked[:rows, : T + 1], jpacked[:rows, : T + 1])  # tokens and n
    np.testing.assert_array_equal(ppacked[:rows, T + 2], jpacked[:rows, T + 2])  # rung
    np.testing.assert_allclose(ppacked[:rows, T + 1:], jpacked[:rows, T + 1:], atol=2e-4)
    drs, _ = pe.transcribe_window_fetch(pending)
    jdrs, _ = je.transcribe_window(jnp.asarray(audio), [LANG] * B, 5, n_active=na)
    assert [d.tokens for d in drs[:rows]] == [d.tokens for d in jdrs[:rows]]
    assert pe.host_syncs == 1


# -- the structure's pieces -----------------------------------------------------


@pytest.mark.parametrize("B", [1, 8], ids=["B1_rungs_as_rows", "B8_sequential"])
@pytest.mark.parametrize("buckets", [(), (8, 20), (10,)], ids=["one_crop", "three_crops", "two_crops"])
def test_window_loops_one_while_a_crop(B, buckets):
    """A window's loops are one device-tested loop (a WHILE node in its
    graph on the card) a cache crop, in crop order, each ending where its
    crop ends: B=1 runs every rung as rows of one loop, padded B=8 one loop
    a rung (six); the window makes one host read."""
    cfg = tiny_config(decode_buckets=buckets)
    engine = _engine(port_params(jload.init_params(cfg, seed=1)), cfg)
    crops = engine._loop_crops(3)
    keys = []
    _record_structure(engine, keys)
    engine.transcribe_window(_audio(B, cfg=cfg, seed=4), [LANG] * B, 3, n_active=None if B == 1 else 5)
    rows, loops = (6, 1) if B == 1 else (8, 6)
    assert keys[0][2] == tuple((rows, pos_end) for _ in range(loops) for _, pos_end in crops)
    assert [S for S, _ in crops] == [*buckets, cfg.max_target_positions]
    assert engine.host_syncs == 1


@pytest.mark.parametrize("B", [1, 6, 48])
def test_loop_cond_plain(B):
    rng = np.random.default_rng(B)
    for trial in range(4):
        fin = torch.from_numpy(rng.random(B) < (0.0, 0.5, 0.95, 1.1)[trial])
        for pos, end in ((3, 8), (8, 8), (9, 8)):
            want = bool((~fin).any()) and pos < end
            p = torch.tensor([pos])
            assert int(loop_cond_torch(fin, p, end)[0]) == want
            assert torch.equal(loop_cond(fin, p, end), loop_cond_torch(fin, p, end))
    with pytest.raises(ValueError, match="int64"):
        loop_cond(torch.zeros(B, dtype=torch.bool), torch.tensor([1], dtype=torch.int32), 4)


# -- tp ranks in one process ----------------------------------------------------


@pytest.mark.parametrize("B", [1, 8], ids=["B1_rungs_as_rows", "B8_sequential"])
def test_local_group_window_one_read(texty, B):
    """A tp=2 engine whose ranks share this process (a LocalGroup) runs the
    window as one device program too: its loops are device-tested, it makes
    one host read, and its results equal its per-step eager window's."""
    _, pp = texty
    audio = _audio(B, seed=6)
    na = None if B == 1 else 5
    eng = DecodeEngine(shard_params(pp, make_mesh(tp=2, devices=["cpu"] * 2)), port_cfg(TCFG), port_st(TEST_ST),
                       language_token_ids=TEST_LANG_IDS)
    try:
        r0 = eng.replicas[0].engine
        keys = []
        _record_structure(r0, keys)
        got, gi = eng.transcribe_window_fetch(eng.transcribe_window_async(audio, [LANG] * B, 2, n_active=na))
        assert r0.host_syncs == 1 and r0.decode_steps > 0
        assert keys and keys[0][2]  # the window's loops were device-tested
        want, wi = r0.transcribe_window_eager(audio, [LANG] * B, 2, n_active=na)
        np.testing.assert_equal([d and (d.tokens, d.avg_logprob, d.no_speech_prob) for d in got],
                                [d and (d.tokens, d.avg_logprob, d.no_speech_prob) for d in want])
        np.testing.assert_array_equal(gi["langs"], wi["langs"])
        assert all(d is not None and d.tokens for d in got[: na or 1])
    finally:
        eng.close()
