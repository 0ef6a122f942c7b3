"""WhisperModel.warmup() on the port (tests/test_warmup.py's cases): it runs
the serving path without side effects, in detect mode through both window
variants, as the JAX package's does (the same calls, in the same order)."""

import numpy as np

from helpers import TEST_LANG_IDS, TEST_ST, ToyTokenizer, tiny_config
from norma_tpu.decode import DecodeEngine as JEngine
from norma_tpu.decode import LanguageState as JLanguageState
from norma_tpu.model import init_params as jinit
from norma_tpu.models.whisper.model import WhisperModel as JWhisperModel
from norma_tpu_torch.decode import DecodeEngine, LanguageState
from norma_tpu_torch.models.whisper.model import WhisperModel
from torch_port_helpers import port_cfg, port_params, port_st


def _model(lang_state):
    engine = DecodeEngine(port_params(jinit(tiny_config(), seed=0)), port_cfg(tiny_config()), port_st(TEST_ST),
                          language_token_ids=TEST_LANG_IDS)
    return WhisperModel(engine, ToyTokenizer(), lang_state, language_tokens=TEST_LANG_IDS)


def _spy(m):
    calls = []
    orig = m.engine.transcribe_window

    def spy(audio, langs, seed):
        calls.append((np.asarray(audio).shape, list(np.asarray(langs, np.int64).reshape(-1)), seed))
        return orig(audio, langs, seed=seed)

    m.engine.transcribe_window = spy
    return calls


def test_warmup_monolingual():
    m = _model(LanguageState(const=TEST_LANG_IDS[0]))
    m.warmup()
    assert m.longform.buf.size == 0  # no state leaked
    assert isinstance(m.transcribe(np.zeros(5000, np.float32), final_chunk=True), str)


def test_warmup_detect_mode():
    m = _model(LanguageState())
    m.warmup()
    assert m.longform.lang.detected is None  # warmup pins no detected language
    out = m.transcribe((0.1 * np.random.default_rng(0).standard_normal(5000)).astype(np.float32), final_chunk=True)
    assert isinstance(out, str)


def test_warmup_detect_mode_runs_both_variants():
    """Detect-mode serving uses both windows (detect on window 1, the known
    language from window 2 on): warmup runs both, with the JAX package's
    shapes, languages and seeds."""
    m = _model(LanguageState())
    calls = _spy(m)
    m.warmup()
    assert len(calls) == 2, calls
    assert calls[0][1][0] == -1  # detect variant
    assert calls[1][1][0] in TEST_LANG_IDS  # known-language variant
    jm = JWhisperModel(JEngine(jinit(tiny_config(), seed=0), tiny_config(), TEST_ST, language_token_ids=TEST_LANG_IDS),
                       ToyTokenizer(), JLanguageState(), language_tokens=TEST_LANG_IDS)
    jcalls = _spy(jm)
    jm.warmup()
    assert calls == jcalls
