"""The port's public surface against the JAX package's, on the CPU.

  - every name in every ``__all__`` of ``norma_tpu/`` (read with ``ast``,
    without importing the module) is in the ``__all__`` of the port's
    counterpart, and every public module-level function and class of
    ``norma_tpu/`` has a counterpart of the same name, or of the name that
    ``RENAMED`` gives it; ``TPU_ONLY`` lists the modules with none;
  - the three helpers that closed the last gaps: ``param_count`` (plain,
    quantized and sharded trees), ``pcm_to_mel`` and ``log_mel_reference``
    against the JAX package's;
  - the parameter constructors and ``pcm_to_mel`` place their output on
    the card where there is one (``torch.cuda.is_available`` patched), on
    the CPU when asked.

Tolerance: counts equal; ``log_mel_reference`` equal bit for bit (both are
the same float64 numpy arithmetic); ``pcm_to_mel`` within 2e-4 of JAX's
and of the reference (f32 rFFT in two libraries, then log10 of the mel
power: tests/test_torch_mel.py's tolerance).
"""

import ast
import importlib
import pathlib

import numpy as np
import pytest
import torch

from checkpoint_fixture import make_checkpoint_dir
from helpers import tiny_config
from torch_port_helpers import port_cfg, port_params

from norma_tpu.frontend import log_mel_reference as jax_log_mel_reference
from norma_tpu.frontend import pcm_to_mel as jax_pcm_to_mel
from norma_tpu.model import init_params as jax_init
from norma_tpu.model import param_count as jax_param_count
from norma_tpu.model.quant import quantize_decoder as jax_quantize_decoder
from norma_tpu.model.quant import quantize_logits_head as jax_quantize_head
from norma_tpu_torch import frontend
from norma_tpu_torch.frontend import mel as port_mel
from norma_tpu_torch.model import WhisperConfig, param_count
from norma_tpu_torch.model import gguf, load, serialize
from norma_tpu_torch.parallel import make_mesh, shard_params
from norma_tpu_torch.parallel.collectives import LocalGroup, TPParams

ROOT = pathlib.Path(__file__).resolve().parents[1]
JAX_PKG = ROOT / "norma_tpu"

# Public names of the JAX package that the port carries under another name,
# on purpose: (module, name) -> the port's name in the same module.
RENAMED = {
    # The plain versions of the kernels: *_jnp -> *_torch.
    ("ops/quant_matmul.py", "w8_matmul_jnp"): "w8_matmul_torch",
    ("ops/quant_matmul.py", "w4_matmul_jnp"): "w4_matmul_torch",
    ("ops/sample_step.py", "sample_step_jnp"): "sample_step_torch",
    # The Pallas kernels: *_pallas -> the wrapper that launches the CUDA
    # kernel on the card and runs the plain version on the CPU.
    ("ops/quant_matmul.py", "w8_matmul_pallas"): "w8_matmul",
    ("ops/quant_matmul.py", "w4_matmul_pallas"): "w4_matmul",
    ("ops/quant_matmul.py", "q8a8_dense_pallas"): "q8a8_dense",
    ("ops/sample_step.py", "sample_step_pallas"): "sample_step",
    # The TPU's online-softmax flash form in plain JAX -> the flash kernel.
    ("ops/flash_encoder.py", "jax_flash_self_attention"): "flash_self_attention",
    # TPU forms of one function, chunked to fit the TPU's memory: the same
    # math as the plain form, only a sum taken in another order.
    ("model/whisper.py", "attention_chunked"): "attention",
    ("model/whisper.py", "attention_cross_q8_chunked"): "attention_cross_q8",
}
# Modules of the JAX package with no counterpart: TPU tiling helpers.
TPU_ONLY = {"ops/tiling.py"}


def _module_name(rel: pathlib.PurePath) -> str:
    parts = rel.with_suffix("").parts
    if parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join(("norma_tpu_torch",) + parts)


def _jax_modules():
    """(path relative to norma_tpu/, its ast) for every module of the JAX
    package, read as source: nothing of it is imported."""
    return [(f.relative_to(JAX_PKG), ast.parse(f.read_text())) for f in sorted(JAX_PKG.rglob("*.py"))]


def _all(tree):
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(getattr(t, "id", None) == "__all__" for t in node.targets):
            return ast.literal_eval(node.value)
    return None


def test_every_all_is_in_the_ports():
    seen = 0
    for rel, tree in _jax_modules():
        names = _all(tree)
        if names is None or rel.as_posix() in TPU_ONLY:
            continue
        mod = importlib.import_module(_module_name(rel))
        port_all = getattr(mod, "__all__", None)
        assert port_all is not None, f"{mod.__name__} has no __all__"
        missing = sorted(set(names) - set(port_all))
        assert not missing, f"{rel}: {missing} not in {mod.__name__}.__all__"
        seen += 1
    assert seen >= 10


def test_every_public_function_has_a_counterpart():
    renamed_used = set()
    for rel, tree in _jax_modules():
        key = rel.as_posix()
        if key in TPU_ONLY:
            with pytest.raises(ModuleNotFoundError):
                importlib.import_module(_module_name(rel))
            continue
        mod = importlib.import_module(_module_name(rel))
        for node in tree.body:
            if not isinstance(node, (ast.FunctionDef, ast.ClassDef)) or node.name.startswith("_"):
                continue
            name = RENAMED.get((key, node.name), node.name)
            if (key, node.name) in RENAMED:
                renamed_used.add((key, node.name))
            assert hasattr(mod, name), f"{key}::{node.name} has no counterpart {mod.__name__}.{name}"
    assert renamed_used == set(RENAMED), f"stale entries: {set(RENAMED) - renamed_used}"


# ---- param_count ------------------------------------------------------------

CFG = tiny_config(d_model=64, encoder_attention_heads=4, decoder_attention_heads=4, vocab_size=1002)


@pytest.mark.parametrize("tree", ["f32", "int8 decoder and head"])
def test_param_count_matches_jax(tree):
    jp = jax_init(CFG, seed=0)
    if tree != "f32":
        jp = jax_quantize_head(jax_quantize_decoder(jp))
    p = port_params(jp)
    want = jax_param_count(jp)
    assert param_count(p) == want
    assert param_count(load.params_to_numpy(p)) == want
    for tp in (2, 4):  # tp=4 splits the int8 head's 1002 rows raggedly
        sp = shard_params(p, make_mesh(dp=2, tp=tp, devices=["cpu"] * (2 * tp)))
        assert param_count(sp) == want
        assert param_count(TPParams(sp.ranks(1), list(range(tp)), LocalGroup(["cpu"] * tp))) == want
    with pytest.raises(ValueError, match="ranks are in this process"):
        param_count(TPParams(sp.ranks(0)[:1], [0], LocalGroup(["cpu"] * 4)))


# ---- the frontend's helpers -------------------------------------------------


def _audio(seconds, seed):
    t = np.arange(int(seconds * 16_000)) / 16_000
    noise = 0.01 * np.random.default_rng(seed).standard_normal(t.size)
    return (0.5 * np.sin(2 * np.pi * 440.0 * t) + noise).astype(np.float32)


@pytest.mark.parametrize("n_mels", [80, 128])
def test_log_mel_reference_is_jaxs(n_mels):
    audio = _audio(1.5, n_mels)
    got = frontend.log_mel_reference(audio, n_mels=n_mels)
    assert got.dtype == np.float32 and got.shape == (n_mels, 3000)
    np.testing.assert_array_equal(got, jax_log_mel_reference(audio, n_mels=n_mels))


@pytest.mark.parametrize("n_mels", [80, 128])
def test_pcm_to_mel_matches_jax(n_mels):
    audio = _audio(2.0, 10 + n_mels)
    got = frontend.pcm_to_mel(audio, n_mels=n_mels, device="cpu")
    assert got.device.type == "cpu" and tuple(got.shape) == (1, n_mels, 3000)
    np.testing.assert_allclose(got.numpy(), np.asarray(jax_pcm_to_mel(audio, n_mels=n_mels)), atol=2e-4)
    np.testing.assert_allclose(got[0].numpy(), frontend.log_mel_reference(audio, n_mels=n_mels), atol=2e-4)


# ---- where the constructors put their output -------------------------------


@pytest.fixture
def placed(monkeypatch):
    """With a card reported present: record the device each module's
    ``default_device`` resolves, and place on the CPU all the same."""
    from norma_tpu_torch import utils

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    seen = []

    def spy(device=None):
        seen.append(utils.default_device(device).type)
        return torch.device("cpu")

    for mod in (load, serialize, port_mel):
        monkeypatch.setattr(mod, "default_device", spy)
    return seen


def _constructors(tmp):
    """Each parameter constructor, called with ``device`` as given."""
    pcfg = port_cfg(tiny_config())
    make_checkpoint_dir(str(tmp))
    make_checkpoint_dir(str(tmp), quantized_ext="tiny-en")
    ccfg = WhisperConfig.from_json(str(tmp / "config.json"))
    serialize.save_params(str(tmp / "p.safetensors"), load.init_params(pcfg, seed=0, device="cpu"))
    tree = load.params_to_numpy(load.init_params(pcfg, seed=0, device="cpu"))
    return {
        "init_params": lambda **kw: load.init_params(pcfg, seed=0, **kw),
        "params_from_numpy": lambda **kw: load.params_from_numpy(tree, **kw),
        "params_from_hf_tensors": lambda **kw: load.params_from_hf_tensors(
            load.read_safetensors(str(tmp / "model.safetensors")), ccfg, **kw),
        "load_safetensors": lambda **kw: load.load_safetensors(str(tmp / "model.safetensors"), ccfg, **kw),
        "load_params_file": lambda **kw: serialize.load_params_file(str(tmp / "p.safetensors"), **kw)[0],
        "load_gguf_q8": lambda **kw: gguf.load_gguf_q8(str(tmp / "model-tiny-en-q80.gguf"), ccfg,
                                                       torch.float32, **kw),
    }


def test_constructors_default_to_the_card(tmp_path, placed):
    for name, make in _constructors(tmp_path).items():
        del placed[:]
        make()
        assert placed == ["cuda"], name
        del placed[:]
        p = make(device="cpu")
        assert placed == ["cpu"] and p.device.type == "cpu", name
    del placed[:]
    frontend.pcm_to_mel(_audio(0.5, 0))
    assert placed == ["cuda"]


def test_default_device_rule(monkeypatch):
    from norma_tpu_torch.utils import default_device, params_platform

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert default_device() == torch.device("cpu") and params_platform({"w": np.zeros(2)}) == "cpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert default_device().type == "cuda" and params_platform({"w": np.zeros(2)}) == "cuda"
    assert default_device("cpu") == torch.device("cpu")
