"""Port decode engine, long-form decoder and WhisperModel vs the JAX package.

  - the committed goldens (tests/golden/engine_small.json, pinned on the
    JAX engine) are reproduced by the port from the same seeded weights, at
    the golden test's own tolerances;
  - a padded B=8 window (sequential ladder) matches the JAX engine on rung
    and tokens for rows accepted at rung 0;
  - the bucketed decode chain gives the unbucketed outcome;
  - the SKILL.md end-to-end recipe drains its buffer on the port.
"""

import dataclasses
import json
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_golden_tokens as gold
from helpers import TEST_LANG_IDS, TEST_ST, ToyTokenizer, confident_params, texty_config, tiny_config
from torch_port_helpers import n, port_cfg, port_params, port_st

from norma_tpu.decode.engine import DecodeEngine as JaxEngine
from norma_tpu_torch.decode import DecodeEngine, LanguageState, LongFormDecoder, SpecialTokens
from norma_tpu_torch.frontend.mel import log_mel_spectrogram, prepare_audio
from norma_tpu_torch.model import WhisperConfig, init_params, params_from_numpy
from norma_tpu_torch.model.load import init_params_numpy
from norma_tpu_torch.models.whisper import WhisperModel

GST = SpecialTokens(
    sot=gold.SOT, eot=gold.EOT, task=gold.TASK, no_speech=gold.NO_SPEECH,
    no_timestamps=gold.NO_TS, zero_sec=gold.ZERO_SEC, one_sec=gold.ONE_SEC,
)


def golden_engine(eot_like=0, eot_scale=0.0, task=gold.TASK, language_token_ids=None):
    """tests/test_golden_tokens.py::build_engine, on the port."""
    cfg = WhisperConfig(
        num_mel_bins=80, vocab_size=51865, d_model=64,
        encoder_layers=2, encoder_attention_heads=2,
        decoder_layers=2, decoder_attention_heads=2,
        max_source_positions=gold.MSP, max_target_positions=gold.MTP,
        suppress_tokens=(),
    )
    tree = init_params_numpy(cfg, seed=0)
    if eot_scale:
        emb = tree["decoder"]["tok_emb"]
        emb[gold.EOT] = eot_scale * emb[eot_like]
    return DecodeEngine(
        params_from_numpy(tree), cfg, dataclasses.replace(GST, task=task),
        language_token_ids=language_token_ids,
    )


def window_tokens(engine, audio):
    mel = log_mel_spectrogram(
        torch.from_numpy(prepare_audio(audio, n_frames=gold.N_FRAMES))[None],
        n_mels=80, n_frames=gold.N_FRAMES,
    )
    state = engine.prefill(engine.encode(mel), gold.LANG_EN)
    dr = engine.run_loop(state, 0.0, seed=0)[0]
    return dr.tokens, dr.avg_logprob


def longform_transcript(engine, timestamps=False):
    lf = LongFormDecoder(
        engine, gold.IdsTokenizer(), LanguageState(const=gold.LANG_EN), seed=0,
        timestamps=timestamps,
    )
    chunks = np.array_split(gold.make_audio("mix", 15.0, seed=3), 4)
    return [lf.transcribe(ch, final_chunk=(i == len(chunks) - 1)) for i, ch in enumerate(chunks)]


@pytest.fixture(scope="module")
def golden():
    with open(gold.GOLDEN_PATH) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def base_engine():
    return golden_engine()


def _check_window(got, want):
    toks, alp = got
    assert toks == want["tokens"]
    if math.isnan(want["avg_logprob"]):
        assert math.isnan(alp)
    else:
        assert abs(alp - want["avg_logprob"]) < 5e-3


@pytest.mark.parametrize("kind", ["tone", "noise", "mix", "tone_natural_eot", "mix_translate"])
def test_golden_windows(golden, base_engine, kind):
    if kind == "tone_natural_eot":
        engine = golden_engine(eot_like=gold.EOT_LIKE, eot_scale=gold.EOT_SCALE)
    elif kind == "mix_translate":
        engine = golden_engine(task=gold.TRANSLATE)
    else:
        engine = base_engine
    audio = gold.make_audio("tone" if "tone" in kind else kind.split("_")[0], 6.0, seed=1)
    _check_window(window_tokens(engine, audio), golden["windows"][kind])


def test_golden_detect(golden):
    engine = golden_engine(language_token_ids=list(gold.DETECT_LANGS))
    audio = prepare_audio(gold.make_audio("mix", 6.0, seed=2), n_frames=gold.N_FRAMES)
    drs, info = engine.transcribe_window(audio[None], [-1], seed=0)
    want = golden["detect"]
    assert int(info["langs"][0]) == want["lang"]
    assert ([] if drs[0] is None else drs[0].tokens) == want["tokens"]
    np.testing.assert_allclose(info["lang_probs"][0], want["lang_probs"], atol=5e-3)


@pytest.mark.parametrize("timestamps", [False, True], ids=["text", "ts"])
def test_golden_longform(golden, base_engine, timestamps):
    key = "longform_emissions_ts" if timestamps else "longform_emissions"
    assert longform_transcript(base_engine, timestamps) == golden[key]


# -- the padded batched window vs the JAX engine ------------------------------

TCFG = texty_config()


@pytest.fixture(scope="module")
def texty():
    jp = confident_params(TCFG, seed=3)
    return jp, port_params(jp)


def _audio_batch(B, seed=0):
    rng = np.random.default_rng(seed)
    k = (2 * TCFG.max_source_positions - 1) * 160 + 400
    return np.stack([(0.1 * rng.standard_normal(k)).astype(np.float32) for _ in range(B)])


def test_padded_batch_window_matches_jax(texty):
    jp, pp = texty
    audio = _audio_batch(8)
    je = JaxEngine(jp, TCFG, TEST_ST, language_token_ids=TEST_LANG_IDS)
    pe = DecodeEngine(pp, port_cfg(TCFG), port_st(TEST_ST), language_token_ids=TEST_LANG_IDS)
    langs = [TEST_LANG_IDS[0]] * 8
    jpacked = np.asarray(je.transcribe_window_async(jnp.asarray(audio), langs, 5, n_active=5)[0])
    pending = pe.transcribe_window_async(audio, langs, 5, n_active=5)
    ppacked = n(pending[0])
    T = TCFG.max_target_positions
    rung = ppacked[:5, T + 2]
    np.testing.assert_array_equal(rung, jpacked[:5, T + 2])
    assert (rung == 0).all()  # the confident params pass the gate at rung 0
    np.testing.assert_array_equal(ppacked[:5, : T + 1], jpacked[:5, : T + 1])  # tokens and n
    np.testing.assert_allclose(ppacked[:5, T + 1 :], jpacked[:5, T + 1 :], atol=2e-4)
    drs, info = pe.transcribe_window_fetch(pending)
    assert drs[5:] == [None] * 3 and all(d is not None and d.tokens for d in drs[:5])
    jdrs, _ = je.transcribe_window(jnp.asarray(audio), langs, 5, n_active=5)
    assert [d.tokens for d in drs[:5]] == [d.tokens for d in jdrs[:5]]


def test_decode_with_fallback_matches_jax(texty):
    jp, pp = texty
    rng = np.random.default_rng(4)
    feats = rng.standard_normal((1, TCFG.max_source_positions, TCFG.d_model)).astype(np.float32)
    je = JaxEngine(jp, TCFG, TEST_ST)
    pe = DecodeEngine(pp, port_cfg(TCFG), port_st(TEST_ST))
    jd = je.decode_with_fallback(jnp.asarray(feats), TEST_LANG_IDS[0], seed=2)
    pd = pe.decode_with_fallback(torch.from_numpy(feats), TEST_LANG_IDS[0], seed=2)
    assert pd.tokens == jd.tokens
    np.testing.assert_allclose(pd.avg_logprob, jd.avg_logprob, atol=1e-4)  # NaN-equal
    assert abs(pd.no_speech_prob - jd.no_speech_prob) < 1e-5


# -- bucketed decode -----------------------------------------------------------


@pytest.mark.parametrize("impl", ["xla", "kernel"])
@pytest.mark.parametrize("B", [1, 3], ids=["speculative", "sequential"])
def test_buckets_match_unbucketed(B, impl):
    cfg = port_cfg(tiny_config()).with_(self_kv_impl=impl)
    params = init_params(cfg, seed=2)
    audio = _audio_batch(B, seed=1)
    langs = [TEST_LANG_IDS[0]] * B
    plain = DecodeEngine(params, cfg, port_st(TEST_ST))
    chained = DecodeEngine(params, cfg.with_(decode_buckets=(16, 32)), port_st(TEST_ST))
    a = n(plain.transcribe_window_async(audio, langs, 9)[0])
    b = n(chained.transcribe_window_async(audio, langs, 9)[0])
    T = cfg.max_target_positions
    np.testing.assert_array_equal(a[:, : T + 1], b[:, : T + 1])  # tokens and n
    np.testing.assert_array_equal(a[:, T + 2], b[:, T + 2])  # rung
    np.testing.assert_allclose(a[:, T + 1], b[:, T + 1], atol=1e-5)  # avg_logprob (NaN-equal)
    assert plain.decode_steps == chained.decode_steps > 0


def test_buckets_at_or_below_prefix_rejected():
    cfg = port_cfg(tiny_config()).with_(decode_buckets=(3, 32))
    e = DecodeEngine(init_params(cfg, seed=2), cfg, port_st(TEST_ST))
    with pytest.raises(ValueError, match="prefix length"):
        e.transcribe_window(_audio_batch(1), [TEST_LANG_IDS[0]], 0)
    with pytest.raises(ValueError, match="positive"):
        DecodeEngine(init_params(cfg, seed=2), cfg.with_(decode_buckets=(0,)), port_st(TEST_ST))


# -- the single-stream runtime -------------------------------------------------


def test_skill_recipe_drains():
    cfg = port_cfg(tiny_config())
    engine = DecodeEngine(init_params(cfg, seed=3), cfg, port_st(TEST_ST), language_token_ids=TEST_LANG_IDS)
    dec = LongFormDecoder(engine, ToyTokenizer(), LanguageState(const=TEST_LANG_IDS[0]))
    sr = 16000
    chunk = (0.1 * np.sin(2 * np.pi * 440 * np.arange(2 * sr) / sr)).astype(np.float32)
    assert isinstance(dec.transcribe(chunk, final_chunk=False), str)
    assert isinstance(dec.transcribe(np.zeros(100, np.float32), final_chunk=True), str)
    assert dec.buf.size == 0


def test_whisper_model_detect_mode_emits_and_drains(texty):
    _, pp = texty
    engine = DecodeEngine(pp, port_cfg(TCFG), port_st(TEST_ST), language_token_ids=TEST_LANG_IDS)
    model = WhisperModel(engine, ToyTokenizer(), LanguageState(), language_tokens=TEST_LANG_IDS)
    model.warmup()
    sr = 16000
    audio = (0.2 * np.sin(2 * np.pi * 300 * np.arange(3 * sr) / sr)).astype(np.float32)
    texts = [model.transcribe(c, final_chunk=(i == 2)) for i, c in enumerate(np.array_split(audio, 3))]
    assert "".join(texts).strip()  # confident params decode text at rung 0
    assert model.longform.buf.size == 0
    assert model.longform.lang.detected is None  # cleared by the final chunk
