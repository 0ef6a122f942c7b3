"""The port's examples (norma_tpu_torch/examples/*.py) stay API-correct
(tests/test_examples.py's checks): each compiles, imports only the port,
and passes only keywords the port's Definitions accept.  With them, the
README quick start's shape (tests/test_readme_example.py) runs on the
port's mock Definition: blocking_spawn -> blocking_start -> strings ->
close."""

import ast
import inspect
import pathlib
import py_compile
import threading
import time

import numpy as np
import pytest

EXAMPLES = sorted(
    p for p in (pathlib.Path(__file__).parent.parent / "norma_tpu_torch" / "examples").glob("*.py")
    if p.name != "__init__.py"
)
NAMES = ("async_transcribe.py", "eval_wer.py", "file_transcribe.py", "multi_stream.py",
         "speculative_serving.py", "whisper_mic.py")


def test_every_example_is_ported():
    assert tuple(p.name for p in EXAMPLES) == NAMES
    assert sorted(p.name for p in (pathlib.Path(__file__).parent.parent / "examples").glob("*.py")) == list(NAMES)


@pytest.mark.parametrize("path", EXAMPLES, ids=lambda p: p.name)
def test_example_compiles(path, tmp_path):
    py_compile.compile(str(path), cfile=str(tmp_path / "c.pyc"), doraise=True)


def _definition_kwargs(path):
    """Keyword names passed to any ``<mod>.Definition(...)`` call, and the
    root of every import."""
    kwargs, roots = set(), set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Call):
            f = node.func
            if getattr(f, "attr", getattr(f, "id", None)) == "Definition":
                kwargs.update(k.arg for k in node.keywords if k.arg)
        elif isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            roots.add(node.module.split(".")[0])
    return kwargs, roots


@pytest.mark.parametrize("path", EXAMPLES, ids=lambda p: p.name)
def test_example_definition_kwargs_exist(path):
    from norma_tpu_torch.models.whisper import monolingual, multilingual

    accepted = set()
    for mod in (monolingual, multilingual):
        accepted |= set(inspect.signature(mod.Definition.__init__).parameters)
    used, roots = _definition_kwargs(path)
    assert used <= accepted, f"{path.name} passes unknown kwargs: {used - accepted}"
    assert "norma_tpu_torch" in roots and not roots & {"jax", "norma_tpu"}, roots


def test_readme_quickstart_shape():
    from norma_tpu_torch import Transcriber
    from norma_tpu_torch.audio.sources import SyntheticSource
    from norma_tpu_torch.input import Settings
    from norma_tpu_torch.models.mock import MockDef

    jh, th = Transcriber.blocking_spawn(MockDef())
    stream = th.blocking_start(Settings(source=SyntheticSource(sample_rate=48_000, channels=2, dtype=np.int16,
                                                               realtime=False)))
    seen = []
    t = threading.Thread(target=lambda: [seen.append(seg) for seg in stream], daemon=True)
    t.start()
    time.sleep(0.4)
    th.stop()
    th.close()
    t.join(timeout=10)
    assert seen and all(isinstance(s, str) for s in seen)
    jh.join(timeout=10)
