"""What the benchmark's modules import, by whole top-level module names:
nothing of JAX, of the JAX package, of the repository's tests or of its
older scripts; and the reference nothing of the program."""

import ast
import glob
import os
import sys

import pytest

from benchmark import run
from benchmark.tests.conftest import ROOT

NEVER = {"jax", "jaxlib", "flax", "norma_tpu", "tests", "bench", "chip_smoke"}


def top_level_imports(path):
    tree = ast.parse(open(path).read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def modules():
    return sorted(glob.glob(os.path.join(ROOT, "benchmark", "**", "*.py"), recursive=True))


def test_no_module_imports_jax_or_the_jax_package():
    for path in modules():
        bad = top_level_imports(path) & NEVER
        assert not bad, f"{path} imports {bad}"


def test_the_reference_imports_nothing_of_the_program():
    for path in glob.glob(os.path.join(ROOT, "benchmark", "reference", "*.py")):
        tree = ast.parse(open(path).read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.ImportFrom):
                assert node.level == 0 or node.module in ("grammar", "whisper_ref"), (path, node.module)
        assert top_level_imports(path) <= {"__future__", "dataclasses", "typing", "math", "numpy", "torch"}, path


@pytest.mark.parametrize("loaded,found", [
    (["norma_tpu_torch", "norma_tpu_torch.model", "torch"], []),
    (["norma_tpu.model", "norma_tpu_torch"], ["norma_tpu"]),
    (["jaxlib.xla_client", "jax", "flax.linen"], ["flax", "jax", "jaxlib"]),
    (["jaxtyping", "flaxen"], []),
])
def test_forbidden_modules_compare_whole_names(monkeypatch, loaded, found):
    fake = {m: None for m in loaded}
    monkeypatch.setattr(sys, "modules", fake)
    assert run.forbidden_modules() == found
