"""The port's LongFormDecoder (norma_tpu_torch.decode.longform) held to the
JAX package's drain accounting.

  - the 12 cases of tests/test_longform.py, each run against the port's
    LongFormDecoder / LanguageState / DecodingResult with the same scripted
    fake engine and the same assertions (which pin the JAX behaviour);
  - a differential run: random scripts of decode results (timestamps,
    EOTs, text, quality-gate failures, no-speech) through both packages'
    decoders, chunk after chunk, giving the same emitted strings, buffer
    sizes, time offsets and requested window sizes.

Everything here is exact (strings, integers).
"""

import numpy as np
import pytest

import test_longform as jcases
from helpers import TEST_LANG_IDS, TEST_ST, ToyTokenizer

from norma_tpu.decode.engine import DecodingResult as JaxResult
from norma_tpu.decode.longform import LanguageState as JaxLanguageState
from norma_tpu.decode.longform import LongFormDecoder as JaxLongForm
from norma_tpu_torch.decode import DecodingResult, LanguageState, LongFormDecoder

CASES = [
    "test_full_window_drains_all_and_emits",
    "test_short_window_holds",
    "test_partial_drain_by_timestamp_then_stop",
    "test_partial_drain_then_next_window",
    "test_quality_gate_discards_slice",
    "test_all_temperatures_failed_discards_slice",
    "test_prefix_only_drains",
    "test_final_chunk_drains_and_emits_everything",
    "test_ts_only_segments_force_drain",
    "test_timestamped_emission_absolute_offsets",
    "test_feed_copies_ring_slot_views",
    "test_detect_language_cleared_on_final_only",
]


def test_the_cases_are_all_of_the_jax_file():
    assert sorted(CASES) == sorted(k for k in vars(jcases) if k.startswith("test_"))


@pytest.mark.parametrize("case", CASES)
def test_longform_case_on_the_port(case, monkeypatch):
    monkeypatch.setattr(jcases, "LongFormDecoder", LongFormDecoder)
    monkeypatch.setattr(jcases, "LanguageState", LanguageState)
    monkeypatch.setattr(jcases, "DecodingResult", DecodingResult)
    getattr(jcases, case)()


def _script(rng, n):
    """n random decode results over the fake engine's token layout: 0-3
    timestamped segments of text, then an EOT, an unterminated segment,
    bare text or nothing; some fail the quality gate, some are no-speech,
    some are None (every temperature failed)."""
    ts = lambda k: int(TEST_ST.zero_sec + k)  # noqa: E731
    text = lambda: [int(x) for x in rng.integers(0, 50, int(rng.integers(0, 4)))]  # noqa: E731
    out = []
    for _ in range(n):
        body, t = [], 0
        for _ in range(int(rng.integers(0, 4))):
            t0 = t + int(rng.integers(0, 10))
            t1 = t0 + int(rng.integers(1, 15))
            if t1 > 58:
                break
            body += [ts(t0)] + text() + [ts(t1)]
            t = t1
        r = rng.random()
        if r < 0.4:
            body.append(TEST_ST.eot)
        elif r < 0.6:
            body += [ts(min(t + 2, 58))] + text()
        elif r < 0.7:
            body = text()
        logprob = float(rng.choice([-0.1, -0.1, -0.1, -2.0]))
        nsp = float(rng.choice([0.0, 0.0, 0.0, 0.9]))
        out.append((body, logprob, nsp, rng.random() < 0.05))
    return out


@pytest.mark.parametrize("seed", range(8))
@pytest.mark.parametrize("timestamps", [False, True])
def test_random_scripts_match_jax(seed, timestamps):
    rng = np.random.default_rng(seed)
    script = _script(rng, 40)
    chunks = [int(rng.integers(2_000, 16_000)) for _ in range(6)]
    traces = []
    for decoder, state, result in ((JaxLongForm, JaxLanguageState, JaxResult),
                                   (LongFormDecoder, LanguageState, DecodingResult)):
        results = [None if none else result(tokens=[TEST_ST.sot, TEST_LANG_IDS[0], TEST_ST.task] + body,
                                            avg_logprob=lp, no_speech_prob=nsp)
                   for body, lp, nsp, none in script]
        eng = jcases.FakeEngine(results)
        lf = decoder(eng, ToyTokenizer(), state(const=TEST_LANG_IDS[0]), timestamps=timestamps)
        trace = []
        for i, c in enumerate(chunks):
            if not eng.results:
                break
            try:
                out = lf.transcribe(np.full(c, 0.01 * i, np.float32), final_chunk=i == len(chunks) - 1)
            except IndexError:  # the script ran out mid-call
                out = "<out of script>"
            trace.append((out, lf.buf.size, round(lf.time_offset_s, 6), list(eng.window_sizes)))
        traces.append(trace)
    assert traces[0] == traces[1]
