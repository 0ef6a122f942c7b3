"""The port's model registry (norma_tpu_torch/models) against the JAX
package's (tests/test_registry.py's cases): params clamps, languages,
the Definitions' metadata and round trips, the GGUF reader, device
selection.  Each case checks the port's values and that the JAX
package's agree; the last case becomes "SelectedDevice.cuda() raises
without CUDA" (the JAX one asks for a TPU)."""

import struct

import numpy as np
import pytest
import torch

import norma_tpu.models as jmodels
from norma_tpu.model import PRESETS as JPRESETS
from norma_tpu.model.gguf import read_gguf as jread_gguf
from norma_tpu.models.whisper import monolingual as jmono
from norma_tpu.models.whisper import multilingual as jmulti
from norma_tpu.models.whisper.languages import ALL_LANGUAGES as JALL
from norma_tpu_torch.errors import ResponsivenessError
from norma_tpu_torch.model import PRESETS
from norma_tpu_torch.model.gguf import read_gguf
from norma_tpu_torch.models import MIN_CHUNK_LEN, CommonModelParams, SelectedDevice
from norma_tpu_torch.models.whisper import Language, VocabVersion, monolingual, multilingual
from norma_tpu_torch.models.whisper.languages import ALL_LANGUAGES


def test_common_params_clamps():
    for cls in (CommonModelParams, jmodels.CommonModelParams):
        p = cls(10, 3, 0)
        assert p.get_max_chunk_len() == 100  # MIN_CHUNK_LEN floor
        assert p.data_buffer_size == 5  # +2 ring slack
        assert p.string_buffer_size == 1  # floor at 1
        p.set_max_chunk_len(50)
        assert p.get_max_chunk_len() == 100
        p.set_max_chunk_len(5000)
        assert p.get_max_chunk_len() == 5000
        p.set_data_buffer_size(10)
        assert p.data_buffer_size == 12
        p.set_string_buffer_size(0)
        assert p.string_buffer_size == 1


def test_language_count_and_order():
    assert len(ALL_LANGUAGES) == 99
    assert [lang.code for lang in ALL_LANGUAGES[:10]] == ["en", "zh", "de", "es", "ru", "ko", "fr", "ja", "pt", "tr"]
    assert ALL_LANGUAGES[-1] is Language.SUNDANESE
    assert [(lang.code, str(lang)) for lang in ALL_LANGUAGES] == [(lang.code, str(lang)) for lang in JALL]


def test_language_token_and_display():
    assert Language.ENGLISH.token() == "<|en|>"
    assert str(Language.HAITIAN_CREOLE) == "Haitian Creole"
    assert Language.HAWAIIAN.token() == "<|haw|>"
    assert [lang.token() for lang in ALL_LANGUAGES] == [lang.token() for lang in JALL]


def test_monolingual_repo_metadata():
    MT = monolingual.ModelType
    assert MT.DISTIL_LARGE_EN_V3.id() == "distil-whisper/distil-large-v3"
    assert MT.TINY_EN.rev() == "refs/pr/15"
    assert MT.BASE_EN.rev() == "refs/pr/13"
    assert MT.SMALL_EN.rev() == "refs/pr/10"
    assert MT.MEDIUM_EN.rev() == "main"
    assert MT.QUANTIZED_TINY_EN.quantized_ext() == "tiny-en"
    assert MT.TINY_EN.quantized_ext() is None
    assert MT.TINY_EN.vocab_version() is VocabVersion.EN_V1
    assert MT.DISTIL_MEDIUM_EN.vocab_version() is VocabVersion.V1
    assert MT.DISTIL_LARGE_EN_V3.vocab_version() is VocabVersion.V2
    assert MT.TINY_EN.language() is Language.ENGLISH
    for m in MT:
        j = jmono.ModelType(m.value)
        assert (m.id(), m.rev(), m.quantized_ext(), m.vocab_version().name, m.language().code) == (
            j.id(), j.rev(), j.quantized_ext(), j.vocab_version().name, j.language().code)


def test_multi_as_mono():
    mm = monolingual.MultiAsMono(model=multilingual.ModelType.LARGE_V3, lang=Language.FRENCH)
    assert mm.id() == "openai/whisper-large-v3"
    assert mm.language() is Language.FRENCH
    assert mm.vocab_version() is VocabVersion.V2


def test_multilingual_repo_metadata():
    MT = multilingual.ModelType
    assert MT.LARGE_V2.rev() == "refs/pr/57"
    assert MT.BASE.rev() == "refs/pr/22"
    assert MT.LARGE.rev() == "refs/pr/36"
    assert MT.QUANTIZED_TINY.quantized_ext() == "tiny"
    assert MT.LARGE_V3.vocab_version() is VocabVersion.V2
    assert multilingual.Task.TRANSCRIBE.token() == "<|transcribe|>"
    assert multilingual.Task.TRANSLATE.token() == "<|translate|>"
    assert MT.LARGE_V3_TURBO.id() == "openai/whisper-large-v3-turbo"
    assert MT.LARGE_V3_TURBO.rev() == "main"
    assert MT.LARGE_V3_TURBO.vocab_version() is VocabVersion.V2
    assert MT.LARGE_V3_TURBO.quantized_ext() is None
    p = PRESETS["large-v3-turbo"]
    assert (p.encoder_layers, p.decoder_layers) == (32, 4)
    assert (p.num_mel_bins, p.vocab_size) == (128, 51866)
    for m in MT:
        j = jmulti.ModelType(m.value)
        assert (m.id(), m.rev(), m.quantized_ext(), m.vocab_version().name) == (
            j.id(), j.rev(), j.quantized_ext(), j.vocab_version().name)
    for name, cfg in PRESETS.items():
        jc = JPRESETS[name]
        assert (cfg.d_model, cfg.encoder_layers, cfg.decoder_layers, cfg.num_mel_bins, cfg.vocab_size) == (
            jc.d_model, jc.encoder_layers, jc.decoder_layers, jc.num_mel_bins, jc.vocab_size), name


def test_set_responsiveness():
    d = monolingual.Definition(monolingual.ModelType.TINY_EN, SelectedDevice.cpu())
    assert d.common_params().get_max_chunk_len() == 16_000 * 25  # default: 25 s chunks
    d.set_responsiveness(10.0)
    assert d.common_params().get_max_chunk_len() == 16_000 * 10
    with pytest.raises(ResponsivenessError):
        d.set_responsiveness(0.5)
    with pytest.raises(ResponsivenessError):
        d.set_responsiveness(31.0)


def _gguf_file(path):
    """A GGUF v3 file with f32, f16 and q8_0 tensors; returns the expected
    arrays."""
    rng = np.random.default_rng(0)

    def gstr(s):
        b = s.encode()
        return struct.pack("<Q", len(b)) + b

    f32_t = rng.standard_normal((4, 8)).astype(np.float32)
    f16_t = rng.standard_normal((2, 16)).astype(np.float16)
    scales = np.array([0.05, 0.1], np.float16)  # q8_0: 64 elements = 2 blocks
    qs = rng.integers(-127, 127, size=(2, 32)).astype(np.int8)
    q8_blocks = b"".join(scales[i].tobytes() + qs[i].tobytes() for i in range(2))
    q8_expected = (qs.astype(np.float32) * scales.astype(np.float32)[:, None]).reshape(-1)
    datas = [f32_t.tobytes(), f16_t.tobytes(), q8_blocks]
    offsets, off = [], 0
    for d in datas:  # 32-byte aligned offsets
        offsets.append(off)
        off = (off + len(d) + 31) // 32 * 32
    header = struct.pack("<IIQQ", 0x46554747, 3, 3, 1)
    meta = gstr("general.alignment") + struct.pack("<I", 4) + struct.pack("<I", 32)
    # dims in ggml order (the numpy shape reversed)
    infos = gstr("a") + struct.pack("<I", 2) + struct.pack("<QQ", 8, 4) + struct.pack("<IQ", 0, offsets[0])
    infos += gstr("b") + struct.pack("<I", 2) + struct.pack("<QQ", 16, 2) + struct.pack("<IQ", 1, offsets[1])
    infos += gstr("c") + struct.pack("<I", 1) + struct.pack("<Q", 64) + struct.pack("<IQ", 8, offsets[2])
    head = header + meta + infos
    pad = (-len(head)) % 32
    body = bytearray(head + b"\0" * pad)
    for d, o in zip(datas, offsets):
        need = len(head) + pad + o + len(d)
        body.extend(b"\0" * max(0, need - len(body)))
        body[len(head) + pad + o: need] = d
    path.write_bytes(bytes(body))
    return f32_t, f16_t, q8_expected


def test_gguf_roundtrip(tmp_path):
    """A synthetic GGUF v3 file with f32/f16/q8_0 tensors reads back through
    the port as through the JAX package."""
    path = tmp_path / "t.gguf"
    f32_t, f16_t, q8_expected = _gguf_file(path)
    meta, tensors = read_gguf(str(path))
    assert meta["general.alignment"] == 32
    np.testing.assert_array_equal(tensors["a"], f32_t)
    np.testing.assert_allclose(tensors["b"], f16_t.astype(np.float32))
    np.testing.assert_allclose(tensors["c"], q8_expected, rtol=1e-3)
    jmeta, jtensors = jread_gguf(str(path))
    assert meta == jmeta and list(tensors) == list(jtensors)
    for k in tensors:
        np.testing.assert_array_equal(tensors[k], jtensors[k])


def test_definition_roundtrip_preserves_extensions():
    """to_dict/from_dict cover every constructor knob; the payload is the
    JAX package's, so each package's Definition loads the other's."""
    import jax.numpy as jnp

    kw = dict(quantize_decoder=True, quantize_cross_kv=True, quantize_self_kv=True, timestamps=True,
              draft="distil-whisper/distil-small.en", spec_k="auto", local_dir="/tmp/ckpt",
              config_overrides={"encoder_attn_impl": "jax_flash", "cross_kv_impl": "chunked"})
    d = monolingual.Definition(monolingual.ModelType.DISTIL_LARGE_EN_V3, dtype=torch.bfloat16, **kw)
    r = monolingual.Definition.from_dict(d.to_dict())
    assert r.config_overrides == {"encoder_attn_impl": "jax_flash", "cross_kv_impl": "chunked"}
    assert r.dtype == torch.bfloat16
    assert r.quantize_decoder and r.quantize_cross_kv and r.timestamps and r.quantize_self_kv
    assert r.draft == "distil-whisper/distil-small.en" and r.spec_k == "auto" and r.local_dir == "/tmp/ckpt"
    assert not r.quantize_encoder and not r.mel_center
    jd = jmono.Definition(jmono.ModelType.DISTIL_LARGE_EN_V3, dtype=jnp.bfloat16, **kw)
    assert monolingual.Definition.from_dict(jd.to_dict()).to_dict() == d.to_dict()
    assert jmono.Definition.from_dict(d.to_dict()).dtype == jnp.bfloat16

    m = multilingual.Definition(multilingual.ModelType.LARGE_V3, task=multilingual.Task.TRANSLATE,
                                quantize_encoder=True, mel_center=True)
    r2 = multilingual.Definition.from_dict(m.to_dict())
    assert r2.task == multilingual.Task.TRANSLATE
    assert r2.quantize_encoder and r2.mel_center and not r2.quantize_decoder

    # Old payloads (before the extensions) load with defaults.
    legacy = {"model": monolingual.ModelType.TINY_EN.value, "device": {"kind": "auto", "ordinal": 0},
              "common_params": d.common_params().to_dict()}
    r3 = monolingual.Definition.from_dict(legacy)
    assert not r3.quantize_decoder and r3.spec_k == 4 and r3.draft is None
    assert r3.config_overrides is None


def test_common_model_params_defaults_construct():
    p = CommonModelParams()
    assert p.max_chunk_len == MIN_CHUNK_LEN
    assert p.data_buffer_size == 3  # 1 + ring slack
    assert p.string_buffer_size == 1
    assert p.to_dict() == jmodels.CommonModelParams().to_dict()


def test_selected_device_rejects_unknown_kind():
    with pytest.raises(ValueError, match="unknown device kind"):
        SelectedDevice("gpu", 0).to_torch_device()
    assert SelectedDevice.cpu().to_torch_device() == torch.device("cpu")


def test_selected_device_cuda_raises_without_cuda(monkeypatch):
    """An explicit CUDA choice never lands on the CPU: without CUDA it
    raises (auto falls back to the CPU)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        SelectedDevice.cuda(0).to_torch_device()
    assert SelectedDevice.auto().to_torch_device() == torch.device("cpu")
