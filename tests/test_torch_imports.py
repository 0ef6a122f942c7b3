"""The port imports neither jax nor norma_tpu.

A static scan of every import statement under norma_tpu_torch/ (a
``sys.modules`` check cannot show this: the test process has jax loaded
already).  ``norma_tpu/__init__.py`` imports jax, so importing any
``norma_tpu`` module would pull it in.
"""

import ast
import os

import pytest

PKG = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "norma_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "norma_tpu")


def _py_files():
    out = []
    for root, _, files in os.walk(PKG):
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _imported_roots(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_package_has_modules():
    names = {os.path.relpath(p, PKG) for p in _py_files()}
    for want in ("model/whisper.py", "ops/sample_step.py", "ops/self_decode.py",
                 "decode/engine.py", "decode/longform.py", "models/whisper/model.py"):
        assert want in names


@pytest.mark.parametrize("path", _py_files(), ids=lambda p: os.path.relpath(p, PKG))
def test_no_jax_or_reference_import(path):
    bad = sorted({r for r in _imported_roots(path) if r in FORBIDDEN})
    assert not bad, f"{os.path.relpath(path, PKG)} imports {bad}"


def test_scan_catches_a_forbidden_import(tmp_path):
    p = tmp_path / "m.py"
    p.write_text("def f():\n    from norma_tpu.model import encode\n    import jax.numpy as jnp\n")
    assert set(_imported_roots(str(p))) == {"norma_tpu", "jax"}
