"""Property-based fuzzing of the port (tests/test_fuzz.py's properties),
each run through the port and the JAX package on the same drawn inputs.

  - for arbitrary (even invalid) decoder outputs, the long-form state
    machine terminates, never grows its buffer, keeps the time offset
    consistent with the consumed audio, and gives the JAX package's text,
    calls, offset and buffer;
  - inclusive_segments' properties, and the JAX package's segments;
  - the Packer conserves samples, chunk for chunk as the JAX package's;
  - the fused sampling step on arbitrary grammar states: the port's
    (its plain version on the CPU) against the JAX package's Pallas kernel
    in interpret mode: the same greedy token and deadlock flag, the chosen
    probability within rtol 1e-5 / atol 1e-7.

Examples are bounded (``max_examples``) and ``deadline=None``.
"""

import numpy as np
import pytest

pytest.importorskip("hypothesis")
from hypothesis import given, settings, strategies as st  # noqa: E402

import torch  # noqa: E402

from helpers import TEST_LANG_IDS, TEST_ST, ToyTokenizer, tiny_config  # noqa: E402
from norma_tpu.decode.engine import DecodingResult as JDecodingResult  # noqa: E402
from norma_tpu.decode.longform import LanguageState as JLanguageState  # noqa: E402
from norma_tpu.decode.longform import LongFormDecoder as JLongFormDecoder  # noqa: E402
from norma_tpu.utils import inclusive_segments as jinclusive_segments  # noqa: E402
from norma_tpu_torch.decode.engine import DecodingResult  # noqa: E402
from norma_tpu_torch.decode.longform import LanguageState, LongFormDecoder  # noqa: E402
from norma_tpu_torch.utils import inclusive_segments  # noqa: E402
from torch_port_helpers import port_cfg, port_st  # noqa: E402

S = TEST_ST
PREFIX = [S.sot, TEST_LANG_IDS[0], S.task]

token_strat = st.one_of(
    st.integers(0, 899),  # text
    st.just(S.eot),
    st.integers(S.zero_sec, 999),  # timestamps
    st.just(S.no_timestamps),
)
tokens_strat = st.lists(token_strat, min_size=0, max_size=24)


class ScriptedEngine:
    def __init__(self, results, cfg, st_):
        self.cfg, self.st = cfg, st_
        self.results = list(results)
        self.calls = 0

    def transcribe_window(self, audio, langs, seed):
        """One scripted result per window; None once the script runs out."""
        self.calls += 1
        dr = self.results.pop(0) if self.results else None
        return [dr], {"langs": np.asarray(langs), "lang_probs": None}


@settings(max_examples=100, deadline=None)
@given(data=st.data(), n_results=st.integers(0, 6), buf_samples=st.integers(1, 30_000), final=st.booleans())
def test_transcribe_always_terminates(data, n_results, buf_samples, final):
    script = [(PREFIX + data.draw(tokens_strat), data.draw(st.floats(-5, 1)), data.draw(st.floats(0, 1)))
              for _ in range(n_results)]
    out = {}
    for name, dr_cls, lf_cls, ls_cls, cfg, st_ in (
        ("port", DecodingResult, LongFormDecoder, LanguageState, port_cfg(tiny_config()), port_st(S)),
        ("jax", JDecodingResult, JLongFormDecoder, JLanguageState, tiny_config(), S),
    ):
        eng = ScriptedEngine([dr_cls(tokens=list(t), avg_logprob=a, no_speech_prob=p) for t, a, p in script],
                             cfg, st_)
        lf = lf_cls(eng, ToyTokenizer(), ls_cls(const=TEST_LANG_IDS[0]))
        text = lf.transcribe(np.zeros(buf_samples, np.float32), final_chunk=final)
        assert isinstance(text, str)
        # Termination: every decode consumes audio or pauses.
        assert eng.calls <= buf_samples // 320 + len(script) + 2
        consumed = round(lf.time_offset_s * 16_000)  # audio conservation
        assert consumed + lf.buf.size == buf_samples
        out[name] = (text, eng.calls, lf.time_offset_s, lf.buf.size)
    assert out["port"] == out["jax"]


@settings(max_examples=200, deadline=None)
@given(st.lists(st.integers(0, 30), min_size=0, max_size=40))
def test_inclusive_segments_properties(xs):
    pred = lambda v: v >= 20  # noqa: E731
    segs = [list(s) for s in inclusive_segments(xs, pred)]
    assert segs == [list(s) for s in jinclusive_segments(xs, pred)]
    for s in segs:  # each segment opens and closes on a boundary
        assert pred(s[0]) and pred(s[-1]) and len(s) >= 2
    i = 0
    for s in segs:  # non-overlapping, in-order slices of xs
        for j in range(i, len(xs) - len(s) + 1):
            if list(xs[j: j + len(s)]) == s:
                i = j + len(s)
                break
        else:
            raise AssertionError("segment is not an in-order slice")
    assert len(segs) <= sum(1 for v in xs if pred(v)) // 2  # two boundaries each


def _pack(Packer, RecycledRing, block_sizes, chunk_len):
    ring = RecycledRing(10_000, chunk_len)
    p = Packer(ring)
    val = 0.0
    for n in block_sizes:
        p.append(np.full(n, val, np.float32))
        val += 1.0
    p.close()
    ring.close()
    chunks = []
    while (c := ring.recv()) is not None:
        chunks.append((c.length, bool(c.is_final), c.data[: c.length].tolist()))
        ring.release(c)
    return chunks, ring.dropped


@settings(max_examples=60, deadline=None)
@given(st.lists(st.integers(1, 5_000), min_size=1, max_size=20), st.integers(100, 4_000))
def test_packer_conserves_samples(block_sizes, chunk_len):
    from norma_tpu.audio.pipeline import Packer as JPacker
    from norma_tpu.runtime.channels import RecycledRing as JRing
    from norma_tpu_torch.audio.pipeline import Packer
    from norma_tpu_torch.runtime.channels import RecycledRing

    chunks, dropped = _pack(Packer, RecycledRing, block_sizes, chunk_len)
    # close() pops exactly one sample; every other sample is delivered (the
    # ring is big enough that nothing drops), the last chunk is final.
    assert sum(c[0] for c in chunks) == sum(block_sizes) - 1
    assert sum(c[1] for c in chunks) >= 1 and dropped == 0
    assert (chunks, dropped) == _pack(JPacker, JRing, block_sizes, chunk_len)


_tok = st.one_of(st.integers(0, S.eot - 1), st.integers(S.eot, S.no_timestamps),
                 st.integers(S.no_timestamps + 1, 999))
_grammar_state = st.tuples(_tok, _tok, st.one_of(st.just(0), st.integers(S.no_timestamps + 1, 999)),
                           st.integers(0, 6))


@settings(max_examples=25, deadline=None)
@given(state=_grammar_state, seed=st.integers(0, 2**31 - 1))
def test_sample_step_matches_pallas_on_arbitrary_grammar_states(state, seed):
    """For arbitrary (prev1, prev2, last_ts, step) grammar states, valid or
    not, the port's greedy step equals the Pallas kernel's (interpret
    mode): token, chosen probability, deadlock flag."""
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    from norma_tpu.decode.masks import build_masks as jbuild_masks
    from norma_tpu.ops.sample_step import sample_step_pallas
    from norma_tpu_torch.decode.masks import build_masks
    from norma_tpu_torch.ops.sample_step import sample_step

    cfg = tiny_config()
    p1, p2, lts, step = state
    ll = np.random.default_rng(seed).normal(0, 2, (2, cfg.vocab_size)).astype(np.float32)
    jm = jbuild_masks(cfg.vocab_size, cfg.suppress_tokens, S)
    nk, pk, fk = sample_step_pallas(
        jnp.asarray(ll), jnp.asarray(jm.suppress), jnp.asarray(jm.non_timestamps), jnp.asarray(jm.timestamps),
        jnp.asarray(jm.first_token), jnp.full((2,), p1, jnp.int32), jnp.full((2,), p2, jnp.int32),
        jnp.full((2,), lts, jnp.int32), jnp.int32(step), jnp.zeros((2,), jnp.float32),
        jnp.asarray([1, 2], jnp.uint32), eot=S.eot, no_timestamps=S.no_timestamps,
        interpret=pltpu.InterpretParams(),
    )
    m = build_masks(cfg.vocab_size, cfg.suppress_tokens, port_st(S))
    mt = [torch.as_tensor(np.asarray(x)) for x in (m.suppress, m.non_timestamps, m.timestamps, m.first_token)]
    full = lambda v: torch.full((2,), v, dtype=torch.int32)  # noqa: E731
    no, po, fo = sample_step(torch.from_numpy(ll), *mt, full(p1), full(p2), full(lts), step,
                             torch.zeros(2), eot=S.eot, no_timestamps=S.no_timestamps, seed=1, greedy_only=True)
    np.testing.assert_array_equal(no.numpy(), np.asarray(nk))
    np.testing.assert_allclose(po.numpy(), np.asarray(pk), rtol=1e-5, atol=1e-7)
    np.testing.assert_array_equal(fo.numpy().astype(bool), np.asarray(fk, bool))
