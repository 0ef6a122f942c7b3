"""The public entry point on the port vs the JAX package: the fixture
checkpoint (tests/checkpoint_fixture.py) loaded by both packages'
Definitions at f32, on the CPU.

  - monolingual, multilingual detect, translate, MultiAsMono and the head
    tiers (quantize_logits True / "int4", quantize_decoder + "int4", the
    int8 self-KV cache) give equal greedy per-window tokens from the two
    engines, and detection picks the same language;
  - both Transcribers stream the same strings from the same audio (weights
    with a peaked softmax and EOT suppressed, so every window decodes at
    rung 0 and the strings are deterministic);
  - config_overrides, the decode_buckets default, a missing file and a bad
    quantize_logits raise or land as in the JAX package; a JAX
    Definition's to_dict() loads through the port's from_dict;
  - the GGUF q8_0 Definition, a pre-quantized params file (written by the
    JAX package's serializer, as tools/quantize_checkpoint.py does) and a
    speculative Definition (a draft checkpoint, HF or params file) give the
    JAX package's greedy tokens and transcripts; the params file is loaded
    as stored (no re-quantization, warnings for a dtype or tier it lacks);
    draft="auto" maps as in the JAX package; quantize_self_kv with a draft
    raises before any file is read; config_overrides reach the target only.
"""

import json
import shutil
import struct

import numpy as np
import pytest
import torch

pytest.importorskip("tokenizers")

from checkpoint_fixture import make_checkpoint_dir, random_hf_tensors, write_safetensors  # noqa: E402

from norma_tpu import Transcriber as JaxTranscriber  # noqa: E402
from norma_tpu.audio.sources import SyntheticSource as JaxSource  # noqa: E402
from norma_tpu.input import Settings as JaxSettings  # noqa: E402
from norma_tpu.models import SelectedDevice as JaxDevice  # noqa: E402
from norma_tpu.models.whisper import Language as JaxLanguage  # noqa: E402
from norma_tpu.models.whisper import monolingual as jmono  # noqa: E402
from norma_tpu.models.whisper import multilingual as jmulti  # noqa: E402
from norma_tpu_torch import Transcriber  # noqa: E402
from norma_tpu_torch.audio.sources import SyntheticSource  # noqa: E402
from norma_tpu_torch.errors import MelBinsError, WhisperError  # noqa: E402
from norma_tpu_torch.frontend.mel import log_mel_spectrogram, prepare_audio  # noqa: E402
from norma_tpu_torch.input import Settings  # noqa: E402
from norma_tpu_torch.models import SelectedDevice  # noqa: E402
from norma_tpu_torch.models.whisper import Language, monolingual, multilingual  # noqa: E402

CPU, JCPU = SelectedDevice.cpu(), JaxDevice.cpu()


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    d = tmp_path_factory.mktemp("ckpt")
    make_checkpoint_dir(d)
    return str(d)


@pytest.fixture(scope="module")
def texty_ckpt(tmp_path_factory, ckpt):
    """The fixture checkpoint with EOT suppressed and the decoder's final
    LayerNorm gain x8 (a peaked softmax): greedy windows decode to the
    length cap and pass the logprob gate at rung 0."""
    d = tmp_path_factory.mktemp("texty")
    shutil.copy(f"{ckpt}/tokenizer.json", d / "tokenizer.json")
    cfg = json.load(open(f"{ckpt}/config.json"))
    eot = json.load(open(f"{ckpt}/tokenizer.json"))["added_tokens"][0]
    assert eot["content"] == "<|endoftext|>"
    cfg["suppress_tokens"] = list(cfg["suppress_tokens"]) + [eot["id"]]
    json.dump(cfg, open(d / "config.json", "w"))
    t = random_hf_tensors(cfg["vocab_size"])
    t["model.decoder.layer_norm.weight"] = t["model.decoder.layer_norm.weight"] * 8.0
    write_safetensors(str(d / "model.safetensors"), t)
    return str(d)


def _audio(seed, n=12_000):
    return (0.2 * np.random.default_rng(seed).standard_normal(n)).astype(np.float32)


def _greedy(engine, audio, lang):
    """Rung-0 tokens of one window through an engine's own prefill and
    loop (the same mel for both packages)."""
    n_frames = 2 * engine.cfg.max_source_positions
    mel = log_mel_spectrogram(torch.from_numpy(prepare_audio(audio, n_frames))[None], n_frames=n_frames).numpy()
    state = engine.prefill(engine.encode(mel if engine.__module__.startswith("norma_tpu.") else torch.from_numpy(mel)),
                           lang)
    return engine.run_loop(state, 0.0, seed=0)[0].tokens


def _pair(jdef, pdef):
    return jdef.blocking_try_to_model(), pdef.blocking_try_to_model()


MONO_KNOBS = {
    "plain": {},
    "logits_int8": dict(quantize_logits=True),
    "logits_int4": dict(quantize_logits="int4"),
    "decoder_int4": dict(quantize_decoder=True, quantize_logits="int4"),
    "self_kv": dict(quantize_self_kv=True, quantize_logits="int4"),
}


@pytest.mark.parametrize("knobs", list(MONO_KNOBS), ids=list(MONO_KNOBS))
def test_monolingual_windows_match_jax(ckpt, knobs):
    kw = MONO_KNOBS[knobs]
    jm, pm = _pair(jmono.Definition(jmono.ModelType.TINY_EN, JCPU, local_dir=ckpt, **kw),
                   monolingual.Definition(monolingual.ModelType.TINY_EN, CPU, local_dir=ckpt, **kw))
    assert pm.longform.lang.const == jm.longform.lang.const == pm.tokenizer.token_to_id("<|en|>")
    assert pm.engine.st == type(pm.engine.st)(**vars(jm.engine.st))
    head = {"logits_int8": "tok_emb_q8"}.get(knobs, "tok_emb_q4" if "int4" in str(kw) else None)
    if head:
        assert head in pm.engine.params["decoder"]
    assert pm.engine.quantize_self_kv == bool(kw.get("quantize_self_kv"))
    for seed in (1, 2):
        lang = pm.longform.lang.const
        got = _greedy(pm.engine, _audio(seed), lang)
        assert got == _greedy(jm.engine, _audio(seed), lang) and len(got) > 10


def test_multilingual_detect_matches_jax(ckpt):
    jm, pm = _pair(jmulti.Definition(jmulti.ModelType.TINY, JCPU, jmulti.Task.TRANSCRIBE, local_dir=ckpt),
                   multilingual.Definition(multilingual.ModelType.TINY, CPU, multilingual.Task.TRANSCRIBE,
                                           local_dir=ckpt))
    assert pm.longform.lang.const is None and len(pm.longform.language_tokens) == 99
    assert pm.longform.language_tokens == jm.longform.language_tokens
    n_frames = 2 * pm.engine.cfg.max_source_positions
    audio = np.stack([prepare_audio(_audio(s), n_frames) for s in (3, 4)])
    (_, pinfo), (_, jinfo) = (m.engine.transcribe_window(audio, [-1, -1], seed=0) for m in (pm, jm))
    np.testing.assert_array_equal(pinfo["langs"], np.asarray(jinfo["langs"]))
    for lang, s in zip(pinfo["langs"], (3, 4)):
        assert _greedy(pm.engine, _audio(s), int(lang)) == _greedy(jm.engine, _audio(s), int(lang))
    out = pm.transcribe(_audio(5), final_chunk=True)
    assert isinstance(out, str) and pm.longform.lang.detected is None  # cleared after final


def test_translate_and_multi_as_mono_match_jax(ckpt):
    jm, pm = _pair(jmulti.Definition(jmulti.ModelType.TINY, JCPU, jmulti.Task.TRANSLATE, local_dir=ckpt),
                   multilingual.Definition(multilingual.ModelType.TINY, CPU, multilingual.Task.TRANSLATE,
                                           local_dir=ckpt))
    assert pm.engine.st.task == pm.tokenizer.token_to_id("<|translate|>") == jm.engine.st.task
    fr = pm.tokenizer.token_to_id("<|fr|>")
    assert _greedy(pm.engine, _audio(6), fr) == _greedy(jm.engine, _audio(6), fr)
    jm, pm = _pair(
        jmono.Definition(jmono.MultiAsMono(jmulti.ModelType.TINY, JaxLanguage.FRENCH), JCPU, local_dir=ckpt),
        monolingual.Definition(monolingual.MultiAsMono(multilingual.ModelType.TINY, Language.FRENCH), CPU,
                               local_dir=ckpt),
    )
    assert pm.longform.lang.const == fr == jm.longform.lang.const
    assert _greedy(pm.engine, _audio(7), fr) == _greedy(jm.engine, _audio(7), fr)


def _stream(transcriber_cls, defn, source_cls, settings_cls):
    defn.set_responsiveness(1.0)  # 16000-sample chunks
    defn.set_data_buffer_size(8)  # the ring holds every chunk: nothing dropped
    jh, th = transcriber_cls.blocking_spawn(defn)
    src = source_cls(sample_rate=16_000, channels=1, dtype=np.float32, freq=440.0, noise=0.02,
                     duration=2.5, realtime=False)
    texts = list(th.blocking_start(settings_cls(source=src)))
    th.close()
    jh.join(timeout=60)
    return texts


def test_transcribers_stream_the_same_strings(texty_ckpt):
    kw = dict(local_dir=texty_ckpt, quantize_decoder=True, quantize_logits="int4")
    want = _stream(JaxTranscriber, jmono.Definition(jmono.ModelType.TINY_EN, JCPU, **kw), JaxSource, JaxSettings)
    got = _stream(Transcriber, monolingual.Definition(monolingual.ModelType.TINY_EN, CPU, **kw),
                  SyntheticSource, Settings)
    assert got == want
    assert got and all(isinstance(s, str) and s for s in got)


def test_config_overrides_and_bucket_default(ckpt):
    d = monolingual.Definition(
        monolingual.ModelType.TINY_EN, CPU, local_dir=ckpt, quantize_cross_kv=True,
        config_overrides={"cross_kv_impl": "kernel", "self_kv_impl": "kernel", "max_target_positions": 64},
    )
    cfg = d.blocking_try_to_model().engine.cfg
    assert (cfg.cross_kv_impl, cfg.self_kv_impl, cfg.max_target_positions) == ("kernel", "kernel", 64)
    with pytest.raises(ValueError, match="encoder_atn_impl"):
        monolingual.Definition(monolingual.ModelType.TINY_EN, CPU, local_dir=ckpt,
                               config_overrides={"encoder_atn_impl": "jax_flash"}).blocking_try_to_model()
    buckets = lambda **o: monolingual.Definition(  # noqa: E731
        monolingual.ModelType.TINY_EN, CPU, local_dir=ckpt, config_overrides=o or None
    ).blocking_try_to_model().engine.cfg.decode_buckets
    assert buckets() == ()  # the fixture decodes at mtp=48
    assert buckets(max_target_positions=448) == (128, 256)
    assert buckets(max_target_positions=448, decode_buckets=()) == ()


def test_loader_errors(ckpt, tmp_path):
    """A missing file and a bad quantize_logits raise as in the JAX
    package; a num_mel_bins other than 80 / 128 raises MelBinsError, as
    the reference does (the JAX loader never raises it: ROADMAP queue 3)."""
    with pytest.raises(WhisperError, match="not found"):
        monolingual.Definition(monolingual.ModelType.TINY_EN, CPU, local_dir=str(tmp_path)).blocking_try_to_model()
    with pytest.raises(ValueError, match="quantize_logits"):
        monolingual.Definition(monolingual.ModelType.TINY_EN, CPU, local_dir=ckpt,
                               quantize_logits="INT4").blocking_try_to_model()
    for f in ("tokenizer.json", "model.safetensors"):
        shutil.copy(f"{ckpt}/{f}", tmp_path / f)
    cfg = json.load(open(f"{ckpt}/config.json"))
    json.dump(dict(cfg, num_mel_bins=64), open(tmp_path / "config.json", "w"))
    with pytest.raises(MelBinsError):
        monolingual.Definition(monolingual.ModelType.TINY_EN, CPU, local_dir=str(tmp_path)).blocking_try_to_model()


def test_unported_branches_raise(ckpt, tmp_path):
    """The loader's former NotImplementedError branches now build models:
    a GGUF checkpoint, a draft checkpoint and a params file."""
    from norma_tpu.model.load import load_safetensors as jload
    from norma_tpu.model.serialize import save_params
    from norma_tpu.models.whisper.loader import WhisperConfig as JaxConfig
    from norma_tpu_torch.decode import DecodeEngine, SpeculativeEngine

    g = tmp_path / "gguf"
    g.mkdir()
    make_checkpoint_dir(g, quantized_ext="tiny-en")
    m = monolingual.Definition(monolingual.ModelType.QUANTIZED_TINY_EN, CPU, local_dir=str(g)).blocking_try_to_model()
    assert type(m.engine) is DecodeEngine
    m = monolingual.Definition(monolingual.ModelType.TINY_EN, CPU, local_dir=ckpt, draft="x",
                               draft_local_dir=ckpt).blocking_try_to_model()
    assert isinstance(m.engine, SpeculativeEngine)
    pf = tmp_path / "pf"
    pf.mkdir()
    for f in ("config.json", "tokenizer.json"):
        shutil.copy(f"{ckpt}/{f}", pf / f)
    save_params(str(pf / "model.safetensors"), jload(f"{ckpt}/model.safetensors",
                                                     JaxConfig.from_json(f"{ckpt}/config.json")))
    m = monolingual.Definition(monolingual.ModelType.TINY_EN, CPU, local_dir=str(pf)).blocking_try_to_model()
    assert "q_w" in m.engine.params["decoder"]["layers"]  # as stored: not fused


def test_gguf_definition_matches_jax(tmp_path):
    make_checkpoint_dir(tmp_path, quantized_ext="tiny-en")
    kw = dict(local_dir=str(tmp_path), quantize_decoder=True)
    jm, pm = _pair(jmono.Definition(jmono.ModelType.QUANTIZED_TINY_EN, JCPU, **kw),
                   monolingual.Definition(monolingual.ModelType.QUANTIZED_TINY_EN, CPU, **kw))
    assert "qkv_w_q" in pm.engine.params["decoder"]["layers"]
    lang = pm.longform.lang.const
    for seed in (1, 2):
        got = _greedy(pm.engine, _audio(seed), lang)
        assert got == _greedy(jm.engine, _audio(seed), lang) and len(got) > 10


@pytest.fixture(scope="module")
def params_file_ckpt(tmp_path_factory, ckpt):
    """The fixture checkpoint converted the way tools/quantize_checkpoint.py
    converts (JAX: fuse_qkv, int8 decoder + int4 head, f32), beside its
    config and tokenizer."""
    from norma_tpu.model import fuse_qkv as jfuse
    from norma_tpu.model.load import load_safetensors as jload
    from norma_tpu.model.quant import quantize_decoder as jqd
    from norma_tpu.model.serialize import save_params
    from norma_tpu.models.whisper.loader import WhisperConfig as JaxConfig

    d = tmp_path_factory.mktemp("params_file")
    for f in ("config.json", "tokenizer.json"):
        shutil.copy(f"{ckpt}/{f}", d / f)
    p = jqd(jfuse(jload(f"{ckpt}/model.safetensors", JaxConfig.from_json(f"{ckpt}/config.json"))), logits="int4")
    save_params(str(d / "model.safetensors"), p, metadata={"quant": "decoder-w8+logits-int4", "dtype": "f32"})
    return str(d)


def test_params_file_definition_matches_jax(params_file_ckpt, caplog):
    """A params file loads as stored (its tiers, no re-quantization) and
    decodes as the JAX package does; asking for a dtype or a tier the file
    lacks warns, as in the JAX package."""
    import logging

    kw = dict(local_dir=params_file_ckpt)
    jm, pm = _pair(jmono.Definition(jmono.ModelType.TINY_EN, JCPU, **kw),
                   monolingual.Definition(monolingual.ModelType.TINY_EN, CPU, **kw))
    dec = pm.engine.params["decoder"]
    assert "tok_emb_q4" in dec and "qkv_w_q" in dec["layers"] and "qkv_w" not in dec["layers"]
    lang = pm.longform.lang.const
    for seed in (1, 2):
        got = _greedy(pm.engine, _audio(seed), lang)
        assert got == _greedy(jm.engine, _audio(seed), lang) and len(got) > 10
    with caplog.at_level(logging.WARNING, logger="norma_tpu_torch.loader"):
        monolingual.Definition(monolingual.ModelType.TINY_EN, CPU, local_dir=params_file_ckpt, dtype=torch.bfloat16,
                               quantize_encoder=True).blocking_try_to_model()
    text = caplog.text
    assert "dtype=f32" in text and "dtype=bf16 is ignored" in text and "encoder-w8a8" in text


def test_speculative_definitions_match_jax(ckpt, params_file_ckpt):
    """draft_local_dir selects the speculative engine through the public
    path; a self-draft (every proposal accepted) and a params-file draft
    both transcribe exactly as the plain model and as the JAX package's
    speculative model."""
    from norma_tpu_torch.decode import SpeculativeEngine

    base = monolingual.Definition(monolingual.ModelType.TINY_EN, CPU, local_dir=ckpt).blocking_try_to_model()
    audio = _audio(5)
    want = base.transcribe(audio, final_chunk=True)
    for draft_dir in (ckpt, params_file_ckpt):
        kw = dict(local_dir=ckpt, draft=None, draft_local_dir=draft_dir, spec_k=3)
        jm, pm = _pair(jmono.Definition(jmono.ModelType.TINY_EN, JCPU, **kw),
                       monolingual.Definition(monolingual.ModelType.TINY_EN, CPU, **kw))
        assert isinstance(pm.engine, SpeculativeEngine) and pm.engine.spec_k == 3
        got = pm.transcribe(audio, final_chunk=True)
        assert got == want == jm.transcribe(audio, final_chunk=True)
        assert pm.engine.last_spec_rounds is not None


def test_speculative_auto_draft_mapping_and_guards(ckpt, tmp_path):
    assert multilingual.Definition(multilingual.ModelType.LARGE_V3, CPU, draft="auto").draft == \
        "distil-whisper/distil-large-v3"
    assert monolingual.Definition(monolingual.ModelType.MEDIUM_EN, CPU, draft="auto").draft == \
        "distil-whisper/distil-medium.en"
    for bad in (lambda: multilingual.Definition(multilingual.ModelType.TINY, CPU, draft="auto"),
                lambda: monolingual.Definition(monolingual.ModelType.TINY_EN, CPU, draft="auto")):
        with pytest.raises(ValueError, match="no official distil draft"):
            bad()
    # quantize_self_kv with a draft: refused before any file is read (the
    # directory does not even exist).
    with pytest.raises(ValueError, match="quantize_self_kv"):
        monolingual.Definition(monolingual.ModelType.TINY_EN, CPU, local_dir=str(tmp_path / "missing"), draft="x",
                               draft_local_dir=str(tmp_path / "missing"), quantize_self_kv=True
                               ).blocking_try_to_model()
    # config_overrides reach the target's config only.
    m = monolingual.Definition(monolingual.ModelType.TINY_EN, CPU, local_dir=ckpt, draft_local_dir=ckpt,
                               config_overrides={"cross_kv_impl": "chunked"}).blocking_try_to_model()
    assert m.engine.cfg.cross_kv_impl == "chunked" and m.engine.draft_cfg.cross_kv_impl == "einsum"


def test_jax_definition_payload_round_trips(ckpt):
    j = jmono.Definition(jmono.MultiAsMono(jmulti.ModelType.LARGE_V3, JaxLanguage.GERMAN), JCPU, local_dir=ckpt,
                         quantize_decoder=True, quantize_logits="int4", quantize_self_kv=True,
                         config_overrides={"self_kv_impl": "kernel"})
    j.set_responsiveness(5.0)
    p = monolingual.Definition.from_dict(j.to_dict())
    assert p.to_dict() == j.to_dict()
    assert p.dtype == torch.float32 and p.model.lang is Language.GERMAN
    assert p.common_params().max_chunk_len == j.common_params().max_chunk_len
    jm = jmulti.Definition(jmulti.ModelType.LARGE_V3, JCPU, jmulti.Task.TRANSLATE, quantize_encoder=True)
    pmd = multilingual.Definition.from_dict(jm.to_dict())
    assert pmd.to_dict() == jm.to_dict() and pmd.task is multilingual.Task.TRANSLATE
    b = monolingual.Definition(monolingual.ModelType.DISTIL_LARGE_EN_V3, CPU, dtype=torch.bfloat16)
    assert b.to_dict()["dtype"] == "bf16" and monolingual.Definition.from_dict(b.to_dict()).dtype == torch.bfloat16
