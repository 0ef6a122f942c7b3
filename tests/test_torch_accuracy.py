"""The port's flip-rate tool (``norma_tpu_torch/tools/accuracy_flip_rate.py``)
against the JAX package's (``tools/accuracy_flip_rate.py``), and bf16
parity on weights with real margins.

  - the tool's audio, fit targets and Wilson interval equal the JAX tool's
    (loaded from its file; ``target_tokens`` is a closure inside its
    ``main``, called with the same constants);
  - the fit's loss and gradients at seeded f32 params equal
    ``jax.value_and_grad`` of the JAX tool's loss (highest matmul
    precision, relative 1e-4), and five Adam steps equal
    ``optax.adam(1e-3)``'s (1e-5);
  - bf16 end to end on real margins: a tiny config fit with the port to
    its decode sequences until the median top-2 logit gap passes 3, over
    the vocabulary and at the first decision, carried to JAX; the bf16 greedy
    tokens of both packages' engines are equal on every window, for the
    base engine and the ``w8_decoder`` and ``xkv_int8`` tiers;
  - the inference entry points build no autograd graph over params that
    require grad, and a kernel wrapper refuses a gradient.
"""

import importlib.util
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from helpers import TEST_LANG_IDS, TEST_ST, tiny_config
from torch_port_helpers import port_cfg, port_params, port_st, to_numpy_tree

import norma_tpu.decode.engine as jax_engine_mod
import norma_tpu.model as jax_model
import norma_tpu.model.quant as jax_quant
from norma_tpu.frontend.mel import log_mel_spectrogram as jax_log_mel
from norma_tpu.frontend.mel import prepare_audio
from norma_tpu.model.whisper import cross_kv as jax_cross_kv
from norma_tpu.model.whisper import decoder_prefill as jax_decoder_prefill
from norma_tpu.model.whisper import encode as jax_encode
from norma_tpu_torch.decode.engine import DecodeEngine
from norma_tpu_torch.decode.masks import SpecialTokens
from norma_tpu_torch.model import fuse_qkv, init_params, params_from_numpy, params_to_numpy
from norma_tpu_torch.model.quant import quantize_decoder
from norma_tpu_torch.tools import accuracy_flip_rate as afr

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LANG = TEST_LANG_IDS[0]
# The tiny layout's specials and text range for the fit targets.
TINY_TARGET = dict(sot=TEST_ST.sot, lang=LANG, task=TEST_ST.task, eot=TEST_ST.eot, text_hi=TEST_ST.eot)
WINDOW_S = 0.64  # 2 * max_source_positions (32) frames of 10 ms


@pytest.fixture(scope="module")
def jax_tool():
    spec = importlib.util.spec_from_file_location(
        "jax_accuracy_flip_rate", os.path.join(REPO, "tools", "accuracy_flip_rate.py")
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_audio_targets_and_interval_match_jax_tool(jax_tool):
    code = next(c for c in jax_tool.main.__code__.co_consts
                if isinstance(c, types.CodeType) and c.co_name == "target_tokens")
    consts = dict(SOT=afr.SOT, EOT=afr.EOT, LANG=afr.LANG, TASK=afr.TASK)
    jax_targets = types.FunctionType(code, vars(jax_tool), "target_tokens", None,
                                     tuple(types.CellType(consts[n]) for n in code.co_freevars))
    for seed in range(3):
        for i, kind in enumerate(afr.AUDIOS):
            np.testing.assert_array_equal(afr.make_audio(kind, 6.0, 100 + seed),
                                          jax_tool.make_audio(kind, 6.0, 100 + seed))
            got, want = afr.target_tokens(seed, i), jax_targets(seed, i)
            assert got.dtype == want.dtype and got.tolist() == want.tolist()
    for k, n in ((0, 0), (0, 10), (3, 10), (10, 10), (7, 1000), (500, 1000)):
        assert afr.wilson_ci(k, n) == jax_tool.wilson_ci(k, n)
    with pytest.raises(ValueError):
        afr.make_audio("speech", 1.0, 0)


def _problem(seed=0):
    """The tiny config, its seeded JAX params, the four windows' log-mel (as
    numpy, fed to both packages) and the fit targets."""
    cfg = tiny_config()
    audios = [afr.make_audio(kind, WINDOW_S, seed=100 + seed) for kind in afr.AUDIOS]
    mels = afr.window_mels(audios, port_cfg(cfg), "cpu").numpy()
    targets = [afr.target_tokens(seed, i, **TINY_TARGET) for i in range(len(afr.AUDIOS))]
    return cfg, jax_model.init_params(cfg, seed=seed), mels, targets, audios


def _jax_loss(cfg):
    """The JAX tool's loss_fn (``tools/accuracy_flip_rate.py``, ``train``)."""

    def loss_fn(p, mels, toks):
        feats = jax_encode(p, cfg, mels)
        xk, xv = jax_cross_kv(p, cfg, feats)
        logits, _, _ = jax_decoder_prefill(p, cfg, toks[:, :-1], xk, xv)
        lp = jax.nn.log_softmax(logits.astype(jnp.float32), axis=-1)
        return -jnp.take_along_axis(lp, toks[:, 1:, None], -1).mean()

    return loss_fn


def _close(got, want, rel):
    """Leaf by leaf: max |got - want| within ``rel`` of max |want|."""
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _close(got[k], want[k], rel)
        return
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= rel * max(np.abs(want).max(), 1e-30)


def test_decode_sequence_puts_the_first_timestamp_after_the_prompt():
    """The sequence the trained regime fits: the target with <|0.00|>
    between the prompt and the text, the only order the grammar decodes
    (first token among <|0.00|>..<|1.00|>, then text)."""
    t = afr.target_tokens(1, 2)
    seq = afr.decode_sequence(t)
    assert seq.dtype == t.dtype
    assert seq.tolist() == t[:3].tolist() + [afr.SPECIALS["zero_sec"]] + t[3:].tolist()
    st = SpecialTokens(**afr.SPECIALS)
    assert afr.first_token_ids(afr.make_config(64, 2, 48), st).tolist() == list(range(st.zero_sec, st.one_sec + 1))


def test_fit_loss_and_gradients_match_jax():
    cfg, jp, mels, targets, _ = _problem()
    toks = np.stack(targets)
    with jax.default_matmul_precision("highest"):
        jl, jg = jax.value_and_grad(_jax_loss(cfg))(jp, jnp.asarray(mels), jnp.asarray(toks))
    p = port_params(jp)
    leaves = [b for b in p.buffers() if b.is_floating_point()]
    for b in leaves:
        b.requires_grad_(True)
    loss = afr.fit_loss(p, port_cfg(cfg), torch.from_numpy(mels), torch.from_numpy(toks))
    loss.backward()
    assert abs(float(loss.detach()) - float(jl)) <= 1e-4 * abs(float(jl))

    def grads(tree):
        return {k: grads(v) if isinstance(v, torch.nn.Module) else v.grad.numpy() for k, v in tree.items()}

    _close(grads(p), to_numpy_tree(jg), 1e-4)


def test_adam_steps_match_optax(monkeypatch):
    """Five steps of the tool's fit: the losses follow JAX's own optax
    run (relative 1e-4, the gradients' tolerance above), and the port's
    Adam applied to the fit's gradients gives the parameters
    ``optax.adam(1e-3)`` gives on the same gradients (1e-5).  The second
    check feeds both optimizers one gradient sequence: Adam divides by
    sqrt(v), so f32 gradient noise on an element whose gradient is near
    zero moves it by up to a step's 1e-3, which says nothing of the
    optimizer."""
    cfg, jp, mels, targets, _ = _problem()
    toks = jnp.asarray(np.stack(targets))
    p = port_params(jp)
    leaves0 = [b.detach().numpy().copy() for b in p.buffers() if b.is_floating_point()]
    grads = []

    class RecordingAdam(torch.optim.Adam):
        def step(self, closure=None):
            grads.append([q.grad.numpy().copy() for g in self.param_groups for q in g["params"]])
            return super().step(closure)

    monkeypatch.setattr(torch.optim, "Adam", RecordingAdam)
    losses = afr.fit(p, port_cfg(cfg), torch.from_numpy(mels), targets, steps=5, log=lambda *_: None)
    assert all(not b.requires_grad for b in p.buffers()) and len(grads) == 5

    opt = optax.adam(1e-3)
    step = jax.jit(jax.value_and_grad(_jax_loss(cfg)))
    state = opt.init(jp)
    jl = []
    with jax.default_matmul_precision("highest"):
        for _ in range(5):
            l, g = step(jp, jnp.asarray(mels), toks)
            updates, state = opt.update(g, state)
            jp = optax.apply_updates(jp, updates)
            jl.append(float(l))
    np.testing.assert_allclose(losses, jl, rtol=1e-4)

    q = [jnp.asarray(a) for a in leaves0]
    state = opt.init(q)
    for g in grads:
        updates, state = opt.update([jnp.asarray(x) for x in g], state)
        q = optax.apply_updates(q, updates)
    got = [b.numpy() for b in p.buffers() if b.is_floating_point()]
    assert len(got) == len(q)
    for a, b in zip(got, q):
        np.testing.assert_allclose(a, np.asarray(b), atol=1e-5, rtol=0)


def _jax_tokens(engine, cfg, audio):
    """The JAX tool's decode_tokens at the tiny config's window."""
    n_frames = 2 * cfg.max_source_positions
    mel = jax_log_mel(jnp.asarray(prepare_audio(audio, n_frames=n_frames))[None],
                      n_mels=cfg.num_mel_bins, n_frames=n_frames)
    state = engine.prefill(engine.encode(mel), LANG)
    return list(engine.run_loop(state, 0.0, seed=0)[0].tokens)


def test_bf16_tokens_equal_jax_on_fitted_weights():
    """Fit to the decode sequences: the first decision (among the first
    token's allowed ids) gets real margins too, and the base engine decodes
    exactly the sequences it was fit to."""
    cfg, _, mels, targets, audios = _problem()
    pcfg, pst = port_cfg(cfg), port_st(TEST_ST)
    seqs = [afr.decode_sequence(t, TEST_ST.zero_sec) for t in targets]
    p = init_params(pcfg, seed=0)
    afr.fit(p, pcfg, torch.from_numpy(mels), seqs, steps=250, log=lambda *_: None)
    tree = params_to_numpy(p)
    ours = fuse_qkv(params_from_numpy(tree, "cpu", torch.bfloat16))
    theirs = jax_model.fuse_qkv(jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), tree))
    base = DecodeEngine(ours, pcfg, pst)
    gaps = [afr.top2_gap(base, a, LANG) for a in audios]
    assert np.median(gaps) > 3.0, gaps  # real margins, not the knife-edge
    first = afr.first_token_ids(pcfg, pst)
    first_gaps = [afr.top2_gap(base, a, LANG, allowed=first) for a in audios]
    assert np.median(first_gaps) > 3.0, first_gaps
    for seq, audio in zip(seqs, audios):
        assert afr.decode_tokens(base, audio, LANG) == seq.tolist()
    engines = {
        "base": (base, jax_engine_mod.DecodeEngine(theirs, cfg, TEST_ST)),
        "w8_decoder": (DecodeEngine(quantize_decoder(ours), pcfg, pst),
                       jax_engine_mod.DecodeEngine(jax_quant.quantize_decoder(theirs), cfg, TEST_ST)),
        "xkv_int8": (DecodeEngine(ours, pcfg, pst, quantize_cross_kv=True),
                     jax_engine_mod.DecodeEngine(theirs, cfg, TEST_ST, quantize_cross_kv=True)),
    }
    for name, (port_eng, jax_eng) in engines.items():
        for kind, audio in zip(afr.AUDIOS, audios):
            got = afr.decode_tokens(port_eng, audio, LANG)
            want = _jax_tokens(jax_eng, cfg, audio)
            assert got == want, (name, kind, afr.first_divergence(want, got), got, want)
            assert len(got) > 3  # decoded past the prefix


def test_inference_builds_no_autograd_graph(monkeypatch):
    """Params that require grad (as after a fit) meet no autograd on the
    inference paths: every model function they reach runs with grad off,
    and no result requires grad."""
    import norma_tpu_torch.decode.engine as engine_mod
    import norma_tpu_torch.decode.speculative as spec_mod
    from norma_tpu_torch.decode import LanguageState
    from norma_tpu_torch.decode.speculative import SpeculativeEngine
    from norma_tpu_torch.models.whisper.model import WhisperModel
    from helpers import ToyTokenizer

    cfg = port_cfg(tiny_config())
    st = port_st(TEST_ST)
    p = init_params(cfg, seed=1)
    for b in p.buffers():
        if b.is_floating_point():
            b.requires_grad_(True)
    seen = []
    for mod in (engine_mod, spec_mod):
        for name in ("encode", "cross_kv", "decoder_prefill", "decoder_step", "decoder_chunk"):
            if hasattr(mod, name):
                fn = getattr(mod, name)

                def spy(*a, fn=fn, name=name, **k):
                    seen.append((name, torch.is_grad_enabled()))
                    return fn(*a, **k)

                monkeypatch.setattr(mod, name, spy)
    engine = DecodeEngine(p, cfg, st, language_token_ids=TEST_LANG_IDS)
    audio = np.tile(prepare_audio(afr.make_audio("mix", WINDOW_S, 3), n_frames=64), (2, 1))
    results, _ = engine.transcribe_window(audio, [LANG, -1], seed=0)
    feats = engine.encode(afr.window_mels([audio[0]], cfg, "cpu"))
    assert not feats.requires_grad
    assert engine.detect_language(feats).shape == (1, len(TEST_LANG_IDS))
    engine.decode_with_fallback(feats, LANG, seed=0)
    engine.decode_with_fallback_windowed(audio[:1], LANG, seed=0)
    model = WhisperModel(engine, ToyTokenizer(), LanguageState(const=LANG))
    assert isinstance(model.transcribe(afr.make_audio("tone", 1.0, 0), final_chunk=True), str)
    spec = SpeculativeEngine(p, cfg, p, cfg, st, language_token_ids=TEST_LANG_IDS, spec_k=2)
    spec.transcribe_window(audio, [LANG, LANG], seed=0)
    assert {name for name, _ in seen} >= {"encode", "cross_kv", "decoder_prefill", "decoder_step", "decoder_chunk"}
    assert not [s for s in seen if s[1]], "a model function ran with grad enabled"


def test_kernel_wrappers_refuse_a_gradient():
    """The kernels have no backward: asked for one, a wrapper raises rather
    than return a result cut from the graph (on the CPU too, where it would
    run its plain version); without grad it runs as before."""
    from norma_tpu_torch.ops.quant_matmul import quantize_per_channel, w8_dense
    from norma_tpu_torch.ops.flash_encoder import flash_self_attention

    torch.manual_seed(0)
    q, s = quantize_per_channel(torch.randn(16, 8))
    x = torch.randn(3, 16, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        w8_dense(x, q, s)
    with torch.no_grad():
        assert not w8_dense(x, q, s).requires_grad
    t = torch.randn(1, 5, 2, 4, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        flash_self_attention(t, t, t)
    assert not w8_dense(x.detach(), q, s).requires_grad
