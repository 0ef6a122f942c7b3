"""The port's offline quantizer (python -m norma_tpu_torch.tools.quantize_checkpoint)
against the JAX package's (tools/quantize_checkpoint.py), on the CPU.

Both tools convert the same input directory with the same flags: the
fixture's HF checkpoint (tests/checkpoint_fixture.py) and its GGUF q8_0
form (the suffixed sidecars of tests/test_serialize.py's GGUF case), for
every flag set at bf16 and f32.  The outputs are equal byte for byte: the
params file and the two copied sidecars.  The port's loader serves each
output.  Also: the sidecar search (plain names first, then the suffixed
glob, never tokenizer_config.json) and the loader's warnings naming the
port's tool.
"""

import importlib.util
import logging
import os
import pathlib
import sys

import numpy as np
import pytest

from checkpoint_fixture import make_checkpoint_dir
from norma_tpu_torch.models import SelectedDevice
from norma_tpu_torch.models.whisper import monolingual
from norma_tpu_torch.tools import quantize_checkpoint as pq

ROOT = pathlib.Path(__file__).parent.parent
FLAGS = {
    "none": [], "decoder": ["--decoder"], "decoder_logits_int4": ["--decoder", "--logits", "int4"],
    "logits_int8": ["--logits", "int8"], "logits_int4": ["--logits", "int4"], "encoder": ["--encoder"],
    "all": ["--decoder", "--logits", "int4", "--encoder"],
}
TIERS = {
    "none": "none", "decoder": "decoder-w8", "decoder_logits_int4": "decoder-w8+logits-int4",
    "logits_int8": "logits-w8", "logits_int4": "logits-int4", "encoder": "encoder-w8a8",
    "all": "decoder-w8+logits-int4+encoder-w8a8",
}
OUTPUTS = ("model.safetensors", "config.json", "tokenizer.json")


def _jax_tool():
    spec = importlib.util.spec_from_file_location("jax_quantize_checkpoint", ROOT / "tools" / "quantize_checkpoint.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def sources(tmp_path_factory):
    hf = tmp_path_factory.mktemp("hf")
    make_checkpoint_dir(str(hf))
    gg = tmp_path_factory.mktemp("gguf")
    make_checkpoint_dir(str(gg), quantized_ext="-q80.gguf")
    assert not (gg / "model.safetensors").exists()
    return {"hf": hf, "gguf": gg}


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
@pytest.mark.parametrize("flags", list(FLAGS))
@pytest.mark.parametrize("src", ["hf", "gguf"])
def test_outputs_byte_equal_and_served(sources, tmp_path, monkeypatch, caplog, src, flags, dtype):
    argv = [str(sources[src]), "", "--dtype", dtype] + FLAGS[flags]
    argv[1] = str(tmp_path / "jax")
    monkeypatch.setattr(sys, "argv", ["quantize_checkpoint.py"] + argv)
    _jax_tool().main()
    argv[1] = str(tmp_path / "port")
    out = pq.main(argv)
    assert out == str(tmp_path / "port" / "model.safetensors")
    for f in OUTPUTS:
        assert (tmp_path / "port" / f).read_bytes() == (tmp_path / "jax" / f).read_bytes(), f
    from norma_tpu_torch.model.serialize import peek_format

    assert peek_format(out) == {"norma_tpu_format": "params-v1", "quant": TIERS[flags], "dtype": dtype}
    # The port's loader serves it as stored: no warning when the Definition
    # asks for what the file holds.
    kw = dict(quantize_decoder="decoder" in flags or flags == "all", quantize_encoder=flags in ("encoder", "all"),
              quantize_logits={"logits_int8": "int8", "logits_int4": "int4"}.get(
                  flags, "int4" if flags in ("decoder_logits_int4", "all") else None))
    import torch

    with caplog.at_level(logging.WARNING):
        model = monolingual.Definition(monolingual.ModelType.TINY_EN, SelectedDevice.cpu(),
                                       local_dir=str(tmp_path / "port"),
                                       dtype=torch.bfloat16 if dtype == "bf16" else torch.float32,
                                       **kw).blocking_try_to_model()
    assert "pre-quantized" not in caplog.text
    audio = (0.1 * np.random.default_rng(8).standard_normal(8000)).astype(np.float32)
    assert isinstance(model.transcribe(audio, final_chunk=True), str)
    assert model.longform.buf.size == 0


def test_sidecar_search(tmp_path):
    """Plain names win; else the first suffixed match; tokenizer_config.json
    never stands in for tokenizer.json; none found exits."""
    (tmp_path / "tokenizer_config.json").write_text("{}")
    (tmp_path / "tokenizer-tiny.json").write_text("{}")
    (tmp_path / "config-tiny.json").write_text("{}")
    assert pq.find_sidecar(str(tmp_path), "tokenizer") == str(tmp_path / "tokenizer-tiny.json")
    assert pq.find_sidecar(str(tmp_path), "config") == str(tmp_path / "config-tiny.json")
    (tmp_path / "config.json").write_text("{}")
    assert pq.find_sidecar(str(tmp_path), "config") == str(tmp_path / "config.json")
    os.remove(tmp_path / "tokenizer-tiny.json")
    with pytest.raises(SystemExit, match="no tokenizer"):
        pq.find_sidecar(str(tmp_path), "tokenizer")


def test_loader_warnings_name_the_ports_tool(sources, tmp_path, caplog):
    """A params file lacking the asked dtype or tiers warns, and the
    warning tells the user to re-run the port's tool."""
    import torch

    pq.main([str(sources["hf"]), str(tmp_path), "--dtype", "bf16"])
    with caplog.at_level(logging.WARNING):
        monolingual.Definition(monolingual.ModelType.TINY_EN, SelectedDevice.cpu(), local_dir=str(tmp_path),
                               dtype=torch.float32, quantize_decoder=True).blocking_try_to_model()
    msgs = [r.getMessage() for r in caplog.records if "pre-quantized" in r.getMessage()]
    assert len(msgs) == 2
    assert all("python -m norma_tpu_torch.tools.quantize_checkpoint" in m for m in msgs)
    assert not any("tools/quantize_checkpoint.py" in m for m in msgs)
