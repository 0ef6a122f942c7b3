"""The port's params files (norma_tpu_torch/model/serialize.py) and GGUF
reader (model/gguf.py) against the JAX package's, on the CPU.

  - a params file written by the JAX package reads through the port to
    arrays equal to the JAX reader's (dtypes kept, bf16 included);
  - a params file the port writes is byte-equal to the JAX package's from
    the same params: the port's own pipeline (init, fuse_qkv, quantizers)
    at f32, and any JAX tree carried over leaf for leaf;
  - the heads' pitched codes and the engine's K-major encoder codes are
    stored in their logical layout;
  - ``peek_format`` tells an HF checkpoint from a params file, and refuses
    a file that is not safetensors;
  - the GGUF fixture checkpoint reads to equal arrays through both
    packages.

Every comparison here is exact (np.testing.assert_array_equal or bytes).
"""

import numpy as np
import pytest
import torch

from checkpoint_fixture import make_checkpoint_dir
from helpers import tiny_config
from torch_port_helpers import port_cfg

from norma_tpu.model import fuse_qkv as jfuse
from norma_tpu.model import gguf as jgguf
from norma_tpu.model import init_params as jinit
from norma_tpu.model import serialize as jser
from norma_tpu.model.quant import quantize_decoder as jqd
from norma_tpu.model.quant import quantize_encoder as jqe
from norma_tpu.model.quant import quantize_logits_head as jqh8
from norma_tpu.model.quant import quantize_logits_head_int4 as jqh4
from norma_tpu_torch.model import WhisperConfig, fuse_qkv, gguf, init_params, serialize
from norma_tpu_torch.model.load import Params, params_from_numpy
from norma_tpu_torch.model.quant import (
    prep_encoder_q8_kernel,
    quantize_decoder,
    quantize_encoder,
    quantize_logits_head,
    quantize_logits_head_int4,
)

CFG = port_cfg(tiny_config())
META = {"quant": "decoder-w8", "dtype": "f32"}

# (JAX pipeline, port pipeline) on init_params(seed=2) -> fuse_qkv.
PIPELINES = {
    "fused": (lambda p: p, lambda p: p),
    "decoder_int8": (jqd, quantize_decoder),
    "decoder_int4": (lambda p: jqd(p, logits="int4"), lambda p: quantize_decoder(p, logits="int4")),
    "head_int8": (jqh8, quantize_logits_head),
    "head_int4": (jqh4, quantize_logits_head_int4),
    "all": (lambda p: jqe(jqd(p, logits="int4")), lambda p: quantize_encoder(quantize_decoder(p, logits="int4"))),
}


def _jax_tree(name, dtype=None):
    import jax.numpy as jnp

    p = jinit(tiny_config(), seed=2, dtype=dtype or jnp.float32)
    return PIPELINES[name][0](jfuse(p))


def _carry(tree) -> Params:
    """A JAX tree as the port's Params leaf for leaf: the dict order and
    every leaf's dtype kept (bf16 bits included)."""

    def conv(v):
        return {k: conv(x) for k, x in v.items()} if isinstance(v, dict) else np.asarray(v)

    return params_from_numpy(conv(tree), "cpu", None)


def _np(x):
    if isinstance(x, torch.Tensor):
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    a = np.asarray(x)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


@pytest.mark.parametrize("name", list(PIPELINES))
def test_port_written_file_is_byte_equal(tmp_path, name):
    """The port's own pipeline from the same seed (f32), saved by the port,
    is byte for byte the JAX package's file."""
    jser.save_params(str(tmp_path / "j.safetensors"), _jax_tree(name), metadata=META)
    port = PIPELINES[name][1](fuse_qkv(init_params(CFG, seed=2)))
    serialize.save_params(str(tmp_path / "p.safetensors"), port, metadata=META)
    assert (tmp_path / "p.safetensors").read_bytes() == (tmp_path / "j.safetensors").read_bytes()


@pytest.mark.parametrize("name", ["fused", "all"])
def test_carried_bf16_tree_is_byte_equal(tmp_path, name):
    """A bf16 JAX tree carried leaf for leaf (the encoder positions stay
    f32, the int4 scales bf16) writes the same bytes."""
    import jax.numpy as jnp

    jp = _jax_tree(name, jnp.bfloat16)
    jser.save_params(str(tmp_path / "j.safetensors"), jp, metadata={"dtype": "bf16"})
    serialize.save_params(str(tmp_path / "p.safetensors"), _carry(jp), metadata={"dtype": "bf16"})
    assert (tmp_path / "p.safetensors").read_bytes() == (tmp_path / "j.safetensors").read_bytes()


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_jax_written_file_reads_equal(tmp_path, dtype):
    """A JAX-written file (every tier) loads through the port to the JAX
    reader's arrays: same keys in the same order, dtypes and values."""
    import jax
    import jax.numpy as jnp

    jp = _jax_tree("all", jnp.bfloat16 if dtype == "bf16" else jnp.float32)
    path = str(tmp_path / "m.safetensors")
    jser.save_params(path, jp, metadata={"quant": "decoder-w8+logits-int4+encoder-w8a8", "dtype": dtype})
    want, jmeta = jser.load_params_file(path)
    got, meta = serialize.load_params_file(path)
    assert meta == jmeta
    flat_j = {"/".join(str(k.key) for k in kp): v for kp, v in jax.tree_util.tree_flatten_with_path(want)[0]}
    flat_p = serialize.flatten_params(got)
    assert list(flat_p) == list(jser.flatten_params(jp))  # the file's order
    assert set(flat_p) == set(flat_j)
    for k, v in flat_p.items():
        assert str(v.dtype).split(".")[-1] == str(flat_j[k].dtype), k
        np.testing.assert_array_equal(_np(v), _np(flat_j[k]), err_msg=k)


def test_kernel_layouts_are_stored_logical(tmp_path):
    """Pitched head codes and K-major encoder codes are views of the
    logical values: the file equals the one from contiguous codes."""
    p = quantize_encoder(quantize_decoder(fuse_qkv(init_params(CFG, seed=2))))
    kern = prep_encoder_q8_kernel(p)
    assert kern["encoder"]["layers"]["fc1_w_q"].stride(1) == 1  # K-major storage
    head = p["decoder"]["tok_emb_q8"]["q"]
    assert head.stride(0) >= head.shape[1]
    flat = {k: v.contiguous().clone() for k, v in serialize.flatten_params(p).items()}
    serialize.save_params(str(tmp_path / "a.safetensors"), kern)
    serialize.write_safetensors(str(tmp_path / "b.safetensors"), flat, {serialize.FORMAT_KEY: serialize.FORMAT_V1})
    assert (tmp_path / "a.safetensors").read_bytes() == (tmp_path / "b.safetensors").read_bytes()


def test_round_trip_keeps_order_dtypes_and_values(tmp_path):
    p = quantize_decoder(fuse_qkv(init_params(CFG, seed=4, dtype=torch.bfloat16)), logits="int4")
    path = str(tmp_path / "m.safetensors")
    serialize.save_params(path, p, metadata={"dtype": "bf16"})
    q, meta = serialize.load_params_file(path)
    assert meta[serialize.FORMAT_KEY] == serialize.FORMAT_V1 and meta["dtype"] == "bf16"
    a, b = serialize.flatten_params(p), serialize.flatten_params(q)
    assert list(a) == list(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k


def test_peek_format_and_bad_files(tmp_path):
    """An HF checkpoint is not a params file (None; loading it raises); a
    GGUF file is not safetensors (a clean ValueError, no giant read); a key
    with the path separator is refused."""
    make_checkpoint_dir(str(tmp_path))
    hf = str(tmp_path / "model.safetensors")
    assert serialize.peek_format(hf) is None and jser.peek_format(hf) is None
    with pytest.raises(ValueError, match="not a norma-tpu params file"):
        serialize.load_params_file(hf)
    g = tmp_path / "g"
    g.mkdir()
    make_checkpoint_dir(str(g), quantized_ext="tiny-en")
    with pytest.raises(ValueError, match="not a safetensors file"):
        serialize.peek_format(str(g / "model-tiny-en-q80.gguf"))
    with pytest.raises(ValueError, match="separator"):
        serialize.flatten_params({"a/b": torch.zeros(1)})


def test_gguf_fixture_reads_equal(tmp_path):
    """The fixture's GGUF q8_0 checkpoint: the same metadata and dequantized
    arrays from both readers, and the same params tree from both loaders."""
    import jax
    import jax.numpy as jnp

    make_checkpoint_dir(str(tmp_path), quantized_ext="tiny-en")
    path = str(tmp_path / "model-tiny-en-q80.gguf")
    jm, jt = jgguf.read_gguf(path)
    pm, pt = gguf.read_gguf(path)
    assert pm == jm and list(pt) == list(jt)
    for k in jt:
        np.testing.assert_array_equal(pt[k], jt[k], err_msg=k)
    assert any(np.unique(v).size > 1 for v in pt.values())
    jcfg = type(tiny_config()).from_json(str(tmp_path / "config-tiny-en.json"))
    pcfg = WhisperConfig.from_json(str(tmp_path / "config-tiny-en.json"))
    want = jgguf.load_gguf_q8(path, jcfg, jnp.float32)
    got = gguf.load_gguf_q8(path, pcfg, torch.float32)
    flat_j = {"/".join(str(k.key) for k in kp): v for kp, v in jax.tree_util.tree_flatten_with_path(want)[0]}
    flat_p = serialize.flatten_params(got)
    assert set(flat_p) == set(flat_j)
    for k, v in flat_p.items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(flat_j[k]), err_msg=k)
    raw = np.arange(68, dtype=np.uint8).tobytes()
    np.testing.assert_array_equal(gguf.dequant_q8_0(raw, 64), jgguf.dequant_q8_0(raw, 64))
    assert gguf.GGUF_MAGIC == jgguf.GGUF_MAGIC
