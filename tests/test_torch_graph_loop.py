"""The device-tested token loop and the repairs around it, on the CPU.

On CUDA the engine's token loop is one WHILE node per cache crop inside a
captured program's CUDA graph (a window, ``run_loop``); on the CPU the same
device-tested loop runs eagerly, its stop test read on the host and not
counted, which is what these tests hold:

  - ``decoder_step`` with a device position (a one-element int64 tensor)
    equals the ``int`` version bit for bit, and the JAX ``decoder_step``
    (f32, the logit tolerance of tests/test_torch_model.py);
  - ``self_attention_decode_torch`` with a device position equals the
    ``int`` version;
  - the device-tested ``_token_loop`` gives the per-step loop's tokens,
    lengths and logprob sums exactly: greedy and t>0 (the CPU generator),
    across bucket boundaries, with rows finished early; ``run_loop`` makes
    one host read, its fetch, and equals ``run_loop_eager``, which reads
    the flags before every step;
  - a step run after every row has finished changes no loop state;
  - the cache crops follow the buckets and end at ``mtp - 1``, and a
    window makes one host read, its fetch (its loops' stop tests are
    device work, read on the host only on the CPU);
  - the engine's own tree: the K-major encoder prep leaves the caller's
    params as they were (pointers, strides, values), so a second engine in
    "w8a16" mode reads codes in the w8 kernel's layout, and unprepped codes
    still run ``encode``; ``pitched_codes`` keeps values and aligns rows.
"""

import dataclasses
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import TEST_LANG_IDS, TEST_ST, confident_params, texty_config, tiny_config
from torch_port_helpers import n, port_cfg, port_params, port_st, t

from norma_tpu.decode.engine import DecodeEngine as JaxEngine
from norma_tpu.model import load as jload
from norma_tpu.model import whisper as jw
from norma_tpu_torch.decode import DecodeEngine
from norma_tpu_torch.decode.engine import _LoopBuffers
from norma_tpu_torch.frontend.mel import prepare_audio
from norma_tpu_torch.model import load as pload
from norma_tpu_torch.model import quant as pquant
from norma_tpu_torch.model import whisper as pw
from norma_tpu_torch.ops import quant_matmul as pq
from norma_tpu_torch.ops import self_decode as sd

CFG = tiny_config()
PCFG = port_cfg(CFG)
LOGIT_TOL = dict(rtol=5e-4, atol=5e-4)  # f32, summation order (test_torch_model.py)


@pytest.fixture(scope="module")
def params():
    jp = jload.init_params(CFG, seed=1)
    return jp, port_params(jp)


def _feats(B, seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((B, CFG.max_source_positions, CFG.d_model)).astype(np.float32)


def _pos(p):
    return torch.tensor([p], dtype=torch.int64)


@pytest.mark.parametrize("impl", ["xla", "kernel", "q8cache"])
def test_decoder_step_device_pos(params, impl):
    jp, pp = params
    B, P = 2, 3
    rng = np.random.default_rng(0)
    toks = rng.integers(0, CFG.vocab_size, (B, P)).astype(np.int32)
    xa = _feats(B, 0)
    jxk, jxv = jw.cross_kv(jp, CFG, jnp.asarray(xa))
    pxk, pxv = pw.cross_kv(pp, PCFG, t(xa))
    _, jck, jcv = jw.decoder_prefill(jp, CFG, jnp.asarray(toks), jxk, jxv)
    _, pck, pcv = pw.decoder_prefill(pp, PCFG, t(toks), pxk, pxv)
    pcfg = dataclasses.replace(PCFG, self_kv_impl="xla" if impl == "q8cache" else impl)
    if impl == "q8cache":
        pck, pcv = pw.quantize_self_kv_cache(pck), pw.quantize_self_kv_cache(pcv)
    clone = lambda c: {k: v.clone() for k, v in c.items()} if isinstance(c, dict) else c.clone()
    ick, icv, dck, dcv = clone(pck), clone(pcv), clone(pck), clone(pcv)
    tok = np.asarray([7, 911], np.int32)
    for pos in (3, 4):  # the second step reads the first's row
        li, _, _ = pw.decoder_step(pp, pcfg, t(tok), pos, ick, icv, pxk, pxv)
        ld, _, _ = pw.decoder_step(pp, pcfg, t(tok), _pos(pos), dck, dcv, pxk, pxv)
        assert torch.equal(li, ld)
        for a, b in ((ick, dck), (icv, dcv)):
            for x, y in ((a, b),) if not isinstance(a, dict) else ((a[k], b[k]) for k in a):
                assert torch.equal(x, y)  # the same rows written
        if impl != "q8cache":
            jl, jck, jcv = jw.decoder_step(jp, CFG, jnp.asarray(tok), jnp.int32(pos), jck, jcv, jxk, jxv)
            np.testing.assert_allclose(n(ld), n(jl), **LOGIT_TOL)
        tok = tok[::-1].copy()


def test_decoder_step_rejects_bad_device_pos(params):
    _, pp = params
    xk, xv = pw.cross_kv(pp, PCFG, t(_feats(1, 1)))
    _, ck, cv = pw.decoder_prefill(pp, PCFG, torch.tensor([[1, 2, 3]]), xk, xv)
    with pytest.raises(ValueError, match="int64"):
        pw.decoder_step(pp, PCFG, torch.tensor([5]), torch.tensor([3], dtype=torch.int32), ck, cv, xk, xv)


@pytest.mark.parametrize("pos", [0, 5, 15])
def test_self_attention_decode_device_pos(pos):
    rng = np.random.default_rng(pos)
    L, B, T, D, H = 2, 3, 16, 64, 2
    ck, cv = (t(rng.standard_normal((L, B, T, D)).astype(np.float32)) for _ in range(2))
    q, kn, vn = (t(rng.standard_normal((B, 1, D)).astype(np.float32)) for _ in range(3))
    ck2, cv2 = ck.clone(), cv.clone()
    a, _, _ = sd.self_attention_decode_torch(q, kn, vn, ck, cv, 1, pos, H)
    b, _, _ = sd.self_attention_decode(q, kn, vn, ck2, cv2, 1, _pos(pos), H)
    assert torch.equal(a, b) and torch.equal(ck, ck2) and torch.equal(cv, cv2)


def test_self_attention_decode_checks_positions():
    L, B, T, D = 1, 1, 8, 64
    c = torch.zeros((L, B, T, D))
    r = torch.zeros((B, 1, D))
    with pytest.raises(ValueError, match="outside"):
        sd.self_attention_decode(r, r, r, c, c.clone(), 0, T, 2)
    with pytest.raises(ValueError, match="int64"):
        sd.self_attention_decode(r, r, r, c, c.clone(), 0, torch.tensor([1], dtype=torch.int32), 2)


# -- the device-tested loop --------------------------------------------------


def _engine(buckets=(), seed=3):
    cfg = tiny_config(decode_buckets=tuple(buckets))
    jp = jload.init_params(cfg, seed=seed)
    return DecodeEngine(port_params(jp), port_cfg(cfg), port_st(TEST_ST), language_token_ids=TEST_LANG_IDS)


def _loop_inputs(engine, B, temps, fin_rows=(), seed=0):
    rng = np.random.default_rng(seed)
    feats = t(rng.standard_normal((B, CFG.max_source_positions, CFG.d_model)).astype(np.float32) * 0.5)
    state = engine.prefill(feats, TEST_LANG_IDS[0])
    prefix = np.asarray(state["prefix"])
    Tmax = engine.cfg.max_target_positions
    tokens_init = np.zeros((B, Tmax), np.int32)
    tokens_init[:, :3] = prefix
    fin = torch.zeros(B, dtype=torch.bool)
    fin[list(fin_rows)] = True
    return (
        state["xk"], state["xv"], state["cache_k"], state["cache_v"], state["next_logits"],
        torch.from_numpy(tokens_init), 3, torch.from_numpy(prefix[:, -1]), torch.from_numpy(prefix[:, -2]),
        torch.tensor(temps, dtype=torch.float32), 1234,
    ), fin, state


def _results(drs):
    """Each result's tokens and both floats' bits (a deadlocked row's NaN
    average compares equal to itself)."""
    bits = lambda x: np.float64(x).tobytes()  # noqa: E731
    return [(d.tokens, bits(d.avg_logprob), bits(d.no_speech_prob)) for d in drs]


@pytest.mark.parametrize("buckets", [(), (8, 20), (10,)], ids=["one_crop", "three_crops", "two_crops"])
@pytest.mark.parametrize("temps", [[0.0, 0.0, 0.0], [0.0, 0.6, 1.0]], ids=["greedy", "t>0"])
def test_device_loop_matches_per_step(buckets, temps):
    engine = _engine(buckets=buckets)
    args, fin, state = _loop_inputs(engine, 3, temps, fin_rows=(2,))
    greedy = all(x == 0.0 for x in temps)
    clone = lambda a: [x.clone() if isinstance(x, torch.Tensor) else x for x in a]
    want = engine._token_loop_eager(*clone(args), fin_init=fin.clone(), greedy_only=greedy)
    steps = engine.decode_steps
    engine.host_syncs = engine.decode_steps = 0
    got = engine._token_loop(*clone(args), fin_init=fin.clone(), greedy_only=greedy)
    for w, g in zip(want, got):  # bit-equal; a deadlocked row's sum is NaN in both
        torch.testing.assert_close(g, w, rtol=0, atol=0, equal_nan=True)
    assert int(got[1][2]) == 3  # the row born finished decoded nothing
    assert engine.host_syncs == 0 and engine.decode_steps == steps  # its stop tests are device work
    # run_loop over the prefill state, at one temperature: one host read,
    # the per-step twin's results.
    t_ = max(temps)
    engine.host_syncs = 0
    got = engine.run_loop(state, t_, 1234)
    assert engine.host_syncs == 1
    eager = engine.run_loop_eager(state, t_, 1234)
    assert _results(got) == _results(eager)


def test_device_loop_runs_to_the_cap():
    """Confident texty weights decode to the mtp - 1 guard: run_loop runs
    every step, crossing both bucket boundaries, with one host read, and
    equals the per-step loop; the JAX package's loop gives the same
    tokens."""
    cfg = texty_config(decode_buckets=(8, 20))
    jp = confident_params(cfg)
    engine = DecodeEngine(port_params(jp), port_cfg(cfg), port_st(TEST_ST), language_token_ids=TEST_LANG_IDS)
    _, _, state = _loop_inputs(engine, 2, [0.0, 0.0])
    engine.host_syncs = engine.decode_steps = 0
    got = engine.run_loop(state, 0.0, 0)
    mtp = cfg.max_target_positions
    assert engine.host_syncs == 1 and engine.decode_steps == mtp - 4
    eager = engine.run_loop_eager(state, 0.0, 0)
    assert _results(got) == _results(eager)
    assert max(len(d.tokens) for d in got) >= mtp - 2  # a row reached the cap (less the timestamp cleanup)
    jstate = JaxEngine(jp, cfg, TEST_ST, language_token_ids=TEST_LANG_IDS)
    feats = np.asarray(engine.encode(torch.zeros(2, cfg.num_mel_bins, 2 * cfg.max_source_positions)))
    jres = jstate.run_loop(jstate.prefill(jnp.asarray(feats), TEST_LANG_IDS[0]), 0.0, 0)
    pres = engine.run_loop(engine.prefill(t(feats), TEST_LANG_IDS[0]), 0.0, 0)
    assert [d.tokens for d in pres] == [d.tokens for d in jres]


def test_steps_after_finish_change_nothing(params):
    engine = _engine(buckets=(8,))
    args, _, _ = _loop_inputs(engine, 3, [0.0, 0.5, 1.0])
    ins = args[:6]
    buf = _LoopBuffers(ins)
    buf.start(ins, 3, args[7], args[8], args[9], args[10], torch.ones(3, dtype=torch.bool))
    buf.tokens[:, 5] = 77  # state a finished loop might hold
    buf.n.fill_(6)
    buf.slp.fill_(-2.5)
    buf.last_ts.fill_(3)
    before = {k: getattr(buf, k).clone() for k in ("tokens", "n", "slp", "p1", "p2", "last_ts", "fin")}
    gen = torch.Generator().manual_seed(0)
    for _ in range(6):  # across the bucket boundary at 8
        engine._loop_step(buf, 8 if int(buf.pos) < 8 else CFG.max_target_positions, 1, False, gen)
    for k, v in before.items():
        assert torch.equal(getattr(buf, k), v), k
    assert int(buf.pos) == 9 and buf.step.tolist() == [6, 6, 6]


@pytest.mark.parametrize("n0", [2, 3, 7])
@pytest.mark.parametrize("buckets", [(), (8, 20), (10,)])
def test_loop_crops_follow_buckets(n0, buckets):
    """One crop a bucket segment: each crop's loop runs from the previous
    crop's end to its own, inside its crop, the last ending at mtp - 1 (the
    step budget); each step's crop is the smallest that holds its row."""
    engine = _engine(buckets=buckets)
    mtp = engine.cfg.max_target_positions
    crops = engine._loop_crops(n0)
    assert [S for S, _ in crops] == [*buckets, mtp]
    pos = n0
    for S, pos_end in crops:
        assert pos < pos_end <= S
        for p in range(pos, pos_end):  # every step of the crop
            assert S == min([b for b in buckets if b > p] + [mtp])
        pos = pos_end
    assert pos == mtp - 1
    assert _engine(buckets=(mtp - 1,))._loop_crops(n0) == [(mtp - 1, mtp - 1)]
    with pytest.raises(ValueError, match="do not exceed"):
        _engine(buckets=(n0,))._loop_crops(n0)


@pytest.mark.parametrize("buckets", [(), (16,)], ids=["one_crop", "two_crops"])
def test_window_host_syncs(buckets):
    """A B=1 window (speculative ladder) on texty confident weights: it
    decodes to the cap and makes one host read, its fetch, whether its
    loop is one WHILE node or one a crop, against one per step (plus the
    fetch) for the per-step loop."""
    cfg = texty_config(decode_buckets=buckets)
    jp = confident_params(cfg)
    engine = DecodeEngine(port_params(jp), port_cfg(cfg), port_st(TEST_ST), language_token_ids=TEST_LANG_IDS)
    raw = np.random.default_rng(5).standard_normal(2 * cfg.max_source_positions * 160).astype(np.float32) * 0.1
    audio = prepare_audio(raw, n_frames=2 * cfg.max_source_positions)[None]
    engine.transcribe_window(audio, [TEST_LANG_IDS[0]], seed=0)
    steps, syncs = engine.decode_steps, engine.host_syncs
    assert steps == cfg.max_target_positions - 4
    assert syncs == 1
    eager = DecodeEngine(port_params(jp), port_cfg(cfg), port_st(TEST_ST), language_token_ids=TEST_LANG_IDS)
    drs_e, _ = eager.transcribe_window_eager(audio, [TEST_LANG_IDS[0]], seed=0)
    assert eager.decode_steps == steps and eager.host_syncs == steps + 1  # one per step, the fetch
    engine2 = DecodeEngine(port_params(jp), port_cfg(cfg), port_st(TEST_ST), language_token_ids=TEST_LANG_IDS)
    drs_g, _ = engine2.transcribe_window(audio, [TEST_LANG_IDS[0]], seed=0)
    assert [d and d.tokens for d in drs_g] == [d and d.tokens for d in drs_e]


# -- the engine's own tree (the K-major prep) ---------------------------------


def _quantized_params(fused):
    jp = jload.init_params(CFG, seed=4)
    pp = port_params(jp)
    if fused:
        pp = pload.fuse_qkv(pp)
    return pquant.quantize_encoder(pquant.quantize_decoder(pp))


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_engine_prep_leaves_caller_params(fused):
    pp = _quantized_params(fused)
    layers = pp["encoder"]["layers"]
    keys = [k for k, _ in layers.items() if k.endswith("_q")]
    before = {k: (layers[k].data_ptr(), layers[k].stride(), layers[k].clone()) for k in keys}
    cfg = PCFG.with_(encoder_q8_mode="w8a8")
    own = DecodeEngine._kernel_params(pp, cfg, torch.device("cuda"))  # the card's prep, on CPU tensors
    assert own is not pp
    for k in keys:
        ptr, stride, vals = before[k]
        assert layers[k].data_ptr() == ptr and layers[k].stride() == stride and torch.equal(layers[k], vals), k
        assert own["encoder"]["layers"][k].stride(1) == 1  # the engine's copy is K-major
        assert torch.equal(own["encoder"]["layers"][k], vals)
    # Everything else is shared, not copied.
    assert own["decoder"]["tok_emb"] is pp["decoder"]["tok_emb"]
    # The caller's codes stay in the w8 kernel's layout: a second engine in
    # "w8a16" mode on the same params reads them as they are.
    for i in range(CFG.encoder_layers):
        for k in keys:
            w = layers.layer(i)[k]
            w2 = w.reshape(w.shape[0], -1)
            assert pq.pitched_codes(w2) is w2, k
    assert DecodeEngine._kernel_params(pp, PCFG.with_(encoder_q8_mode="w8a16"), torch.device("cuda")) is pp
    assert DecodeEngine._kernel_params(pp, cfg, torch.device("cpu")) is pp


@pytest.mark.parametrize("mode", ["w8a8", "w8a16"])
def test_unprepped_codes_run_encode(mode):
    """encode on quantized params that no engine prepped runs and equals
    the prepped tree's result (the card's wrapper copies such codes
    K-major for the call)."""
    pp = _quantized_params(True)
    cfg = PCFG.with_(encoder_q8_mode=mode)
    mel = t(np.random.default_rng(2).standard_normal((1, CFG.num_mel_bins, 2 * CFG.max_source_positions))
            .astype(np.float32))
    plain = pw.encode(pp, cfg, mel)
    prepped = pw.encode(DecodeEngine._kernel_params(pp, cfg, torch.device("cuda")), cfg, mel)
    assert torch.isfinite(plain).all() and torch.equal(plain, prepped)


@pytest.mark.parametrize("N", [16, 700, 51866])
def test_pitched_codes(N):
    q = torch.randint(-127, 128, (8, N), dtype=torch.int8)
    p = pq.pitched_codes(q)
    assert torch.equal(p, q) and p.stride() == (-(-N // 16) * 16, 1)
    assert pq.pitched_codes(p) is p
    x = torch.randn(3, 8)
    s = torch.rand(N)
    assert torch.equal(pq.w8_dense(x, p, s), pq.w8_dense_torch(x, q, s))
