"""The port's coverage gate (norma_tpu_torch.tools.coverage_gate, the port of
tools/coverage_gate.py): it scores files under norma_tpu_torch/ only, and
exits non-zero below its bar."""

import os
import subprocess
import sys

from norma_tpu_torch.tools import coverage_gate

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_gate_scores_the_port_only_and_fails_under_100():
    r = subprocess.run(
        [sys.executable, "-m", "norma_tpu_torch.tools.coverage_gate", "--fail-under", "100",
         "tests/test_torch_utils.py", "tests/test_torch_wer.py", "-q", "-p", "no:cacheprovider", "-p", "no:xdist"],
        capture_output=True, text=True, timeout=300, cwd=REPO,
    )
    sys.stdout.write(r.stdout[-3000:])
    rows = [ln for ln in r.stdout.splitlines() if ln.strip().endswith(".py") and "%" in ln]
    assert rows and all(ln.split()[-1].startswith("norma_tpu_torch/") for ln in rows)
    assert any(ln.split()[-1] == "norma_tpu_torch/utils.py" and not ln.strip().startswith("0.0%") for ln in rows)
    total = [ln for ln in r.stdout.splitlines() if ln.startswith("TOTAL")]
    assert len(total) == 1 and "coverage gate FAILED" in r.stdout
    assert r.returncode == 2


def test_report_counts_executable_lines(capsys, monkeypatch):
    path = os.path.join(coverage_gate.PKG, "errors.py")
    lines = coverage_gate.executable_lines(path)
    assert lines
    monkeypatch.setattr(coverage_gate, "_hits", {(path, ln) for ln in lines})
    assert coverage_gate.report(0.0) == 0
    out = capsys.readouterr().out
    assert any(ln.strip().startswith("100.0%") and ln.endswith("norma_tpu_torch/errors.py") for ln in out.splitlines())
    assert coverage_gate.report(100.0) == 2
