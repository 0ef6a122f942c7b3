"""The port imports neither jax nor norma_tpu, nor ``tokenizers`` or
``optax``, nor anything from ``tests/``.

A static scan of every import statement under norma_tpu_torch/ (a
``sys.modules`` check cannot show this: the test process has jax loaded
already), its tools (``tools/``), native audio runtime (``audio/native/``)
and WER metric (``eval/``) included.  ``norma_tpu/__init__.py`` imports
jax, so importing any ``norma_tpu`` module would pull it in.  The port
reads tokenizer.json itself, so it needs no ``tokenizers``; its fit runs
``torch.optim``, so it needs no ``optax``; its tools build their own
models, so they need none of the tests' helpers.  ``huggingface_hub`` (an
optional download) is imported only inside the loader's hub-download
function.
"""

import ast
import os

import pytest

PKG = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "norma_tpu_torch")
TESTS = os.path.join(os.path.dirname(PKG), "tests")
# The tests' own modules (helpers, checkpoint_fixture, ...) and the package
# name a checkout's tests/ would import as.
TEST_MODULES = ("tests",) + tuple(sorted(f[:-3] for f in os.listdir(TESTS) if f.endswith(".py")))
FORBIDDEN = ("jax", "jaxlib", "norma_tpu", "tokenizers", "optax") + TEST_MODULES
LAZY = {"huggingface_hub": ("models/whisper/loader.py", "_hub_download")}


def _py_files():
    out = []
    for root, _, files in os.walk(PKG):
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _imports(path):
    """(root module, enclosing function name or None) of every absolute
    import in the file."""
    tree = ast.parse(open(path).read(), path)

    def walk(node, fn):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                yield from walk(child, child.name)
                continue
            if isinstance(child, ast.Import):
                for a in child.names:
                    yield a.name.split(".")[0], fn
            elif isinstance(child, ast.ImportFrom) and child.level == 0 and child.module:
                yield child.module.split(".")[0], fn
            yield from walk(child, fn)

    yield from walk(tree, None)


def _imported_roots(path):
    for root, _ in _imports(path):
        yield root


def test_package_has_modules():
    names = {os.path.relpath(p, PKG) for p in _py_files()}
    for want in ("model/whisper.py", "ops/sample_step.py", "ops/self_decode.py",
                 "decode/engine.py", "decode/longform.py", "models/whisper/model.py",
                 "models/whisper/loader.py", "models/whisper/tokenizer.py", "runtime/transcriber.py",
                 "ops/mel_pallas.py", "dtype.py", "audio/device.py", "audio/native/__init__.py",
                 "audio/native/alsa.py", "audio/native/wrappers.py", "eval/wer.py", "tools/eval_wer.py",
                 "tools/accuracy_flip_rate.py", "tools/soak_serving.py", "utils.py", "parallel/__init__.py",
                 "parallel/sharding.py", "parallel/data_parallel.py", "parallel/dryrun.py",
                 "tools/make_golden.py", "tools/coverage_gate.py"):
        assert want in names


@pytest.mark.parametrize("path", _py_files(), ids=lambda p: os.path.relpath(p, PKG))
def test_no_jax_or_reference_import(path):
    bad = sorted({r for r in _imported_roots(path) if r in FORBIDDEN})
    assert not bad, f"{os.path.relpath(path, PKG)} imports {bad}"


@pytest.mark.parametrize("path", _py_files(), ids=lambda p: os.path.relpath(p, PKG))
def test_lazy_imports_stay_in_their_function(path):
    rel = os.path.relpath(path, PKG)
    for root, fn in _imports(path):
        if root in LAZY:
            assert (rel, fn) == LAZY[root], f"{rel} imports {root} in {fn or 'module scope'}"


def test_scan_catches_a_forbidden_import(tmp_path):
    p = tmp_path / "m.py"
    p.write_text("def f():\n    from norma_tpu.model import encode\n    import jax.numpy as jnp\n"
                 "import tokenizers\nimport optax\nfrom helpers import tiny_config\n")
    assert set(_imported_roots(str(p))) == {"norma_tpu", "jax", "tokenizers", "optax", "helpers"}
    assert set(_imports(str(p))) == {("norma_tpu", "f"), ("jax", "f"), ("tokenizers", None), ("optax", None),
                                     ("helpers", None)}
    assert {"helpers", "checkpoint_fixture", "torch_port_helpers", "tests"} <= set(TEST_MODULES)
    assert set(_imported_roots(str(p))) <= set(FORBIDDEN)
