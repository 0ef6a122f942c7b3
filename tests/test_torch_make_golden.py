"""The port's golden-token tool (norma_tpu_torch.tools.make_golden) against
the JAX package's (tools/make_golden.py) on tests/checkpoint_fixture.py's
checkpoint, both on the CPU at f32: the same JSON keys, and equal
``greedy_tokens`` and ``text`` for the three synthetic cases.

Tolerance: ``no_speech_prob`` within 1e-5 and ``avg_logprob`` within 1e-4
(f32, JAX matmul precision "highest"; sums of per-token logs in other
orders)."""

import importlib.util
import json
import os
import sys

import pytest

from checkpoint_fixture import make_checkpoint_dir

from norma_tpu_torch.tools import make_golden

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_tool():
    spec = importlib.util.spec_from_file_location("jax_make_golden", os.path.join(REPO, "tools", "make_golden.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("lang", ["en", None])
def test_goldens_match_jax(tmp_path, monkeypatch, lang):
    ckpt = tmp_path / "ckpt"
    ckpt.mkdir()
    make_checkpoint_dir(str(ckpt))
    flags = ["--local-dir", str(ckpt)] + (["--lang", lang] if lang else [])
    port_out, jax_out = tmp_path / "port.json", tmp_path / "jax.json"
    make_golden.main([str(port_out), *flags, "--cpu"])
    monkeypatch.setattr(sys, "argv", ["make_golden.py", str(jax_out), *flags])
    _jax_tool().main()
    got, want = json.loads(port_out.read_text()), json.loads(jax_out.read_text())
    assert set(got) == set(want) == {"source", "revision", "cases"}
    assert set(got["cases"]) == set(want["cases"]) == {"tone220", "noise", "mix440"}
    for name, w in want["cases"].items():
        g = got["cases"][name]
        assert set(g) == set(w)
        assert g["greedy_tokens"] == w["greedy_tokens"], name
        assert g["text"] == w["text"], name
        assert g["no_speech_prob"] == pytest.approx(w["no_speech_prob"], abs=1e-5)
        assert g["avg_logprob"] == pytest.approx(w["avg_logprob"], abs=1e-4, nan_ok=True)


def test_needs_a_checkpoint(tmp_path):
    with pytest.raises(SystemExit, match="need --repo or --local-dir"):
        make_golden.main([str(tmp_path / "out.json"), "--cpu"])
