"""Line-coverage gate for norma_tpu_torch (the port of
``tools/coverage_gate.py``).

Dependency-free: PEP 669 ``sys.monitoring`` LINE events with first-hit
DISABLE (near-zero steady-state overhead), measured against the
executable lines of each module's compiled code objects (Python >= 3.12,
which both the CPU and the card's machines run).  Only files under
``norma_tpu_torch/`` are scored.

  python -m norma_tpu_torch.tools.coverage_gate [--fail-under PCT] [pytest args...]

Exits non-zero when the test run fails, or when the total coverage of
``norma_tpu_torch/`` falls below the bar.
"""

from __future__ import annotations

import argparse
import os
import sys

PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(PKG)

_hits: set = set()


def _in_pkg(filename: str) -> bool:
    return filename.startswith(PKG + os.sep)


def _on_line(code, line):
    if _in_pkg(code.co_filename):
        _hits.add((code.co_filename, line))
    return sys.monitoring.DISABLE


def executable_lines(path: str) -> set:
    """All line numbers with executable bytecode in a source file."""
    with open(path, "r") as f:
        src = f.read()
    try:
        top = compile(src, path, "exec")
    except SyntaxError:
        return set()
    lines = set()
    stack = [top]
    while stack:
        code = stack.pop()
        for _, _, line in code.co_lines():
            if line is not None and line > 0:
                lines.add(line)
        for const in code.co_consts:
            if hasattr(const, "co_lines"):
                stack.append(const)
    return lines


def iter_sources():
    for dirpath, _, files in os.walk(PKG):
        for f in sorted(files):
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def report(fail_under: float) -> int:
    """Print per-file and total coverage of the package; 2 below the bar."""
    by_file: dict = {}
    for f, ln in _hits:
        by_file.setdefault(f, set()).add(ln)
    total_exec = total_hit = 0
    rows = []
    for path in iter_sources():
        ex = executable_lines(path)
        if not ex:
            continue
        hit = by_file.get(path, set()) & ex
        total_exec += len(ex)
        total_hit += len(hit)
        rows.append((100.0 * len(hit) / len(ex), len(hit), len(ex), os.path.relpath(path, REPO)))
    rows.sort()
    for pct, hit, ex, rel in rows:
        print(f"{pct:6.1f}%  {hit:4d}/{ex:<4d}  {rel}")
    total = 100.0 * total_hit / max(total_exec, 1)
    print(f"TOTAL  {total:.1f}%  ({total_hit}/{total_exec} lines)")
    if total < fail_under:
        print(f"coverage gate FAILED: {total:.1f}% < {fail_under}%")
        return 2
    print(f"coverage gate OK: {total:.1f}% >= {fail_under}%")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--fail-under", type=float, default=85.0)
    args, pytest_args = ap.parse_known_args(argv)

    tool = sys.monitoring.COVERAGE_ID
    sys.monitoring.use_tool_id(tool, "norma-torch-coverage-gate")
    sys.monitoring.register_callback(tool, sys.monitoring.events.LINE, _on_line)
    sys.monitoring.set_events(tool, sys.monitoring.events.LINE)

    # ``python -m`` imported the package before the monitor started, so
    # its module-level lines ran unseen: drop it, and the tests import it
    # afresh under the monitor, as in a fresh process.
    for name in [m for m in sys.modules if m == "norma_tpu_torch" or m.startswith("norma_tpu_torch.")]:
        del sys.modules[name]

    import pytest

    try:
        rc = pytest.main(pytest_args or ["tests/", "-q", "-k", "torch"])
    finally:
        sys.monitoring.set_events(tool, 0)
        sys.monitoring.free_tool_id(tool)

    if rc != 0:
        print(f"coverage gate: test run failed (rc={rc}); not scoring")
        return int(rc)
    return report(args.fail_under)


if __name__ == "__main__":
    sys.exit(main())
