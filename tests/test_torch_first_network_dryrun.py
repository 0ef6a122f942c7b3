"""The port's first-network runbook (norma_tpu_torch/tools/first_network_run.sh,
the twin of tests/test_first_network_dryrun.py): its --dry-run runs the
offline prefix -- the API constructions and every tool flag the networked
steps use -- and must stay green.  A tool whose ``--help`` fails is named
as that failure, not as a lost flag."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _dry_run(root):
    return subprocess.run(
        ["bash", os.path.join(root, "norma_tpu_torch", "tools", "first_network_run.sh"), "--dry-run"],
        capture_output=True, text=True, timeout=300, cwd=root,
    )


def test_first_network_dry_run():
    r = _dry_run(REPO)
    sys.stdout.write(r.stdout[-2000:])
    sys.stderr.write(r.stderr[-2000:])
    assert r.returncode == 0
    assert "DRY RUN OK" in r.stdout
    for tool in ("make_golden", "quantize_checkpoint", "eval_wer"):
        assert f"norma_tpu_torch.tools.{tool} flags OK" in r.stdout


def test_dry_run_names_a_failing_help(tmp_path):
    """The package seen through symlinks, with ``tools/quantize_checkpoint.py``
    replaced by a module that exits 2: the dry run stops there, names the
    tool and its exit status and shows its output's end."""
    pkg = os.path.join(REPO, "norma_tpu_torch")
    fake = tmp_path / "norma_tpu_torch"
    (fake / "tools").mkdir(parents=True)
    for name in os.listdir(pkg):
        if name not in ("tools", "__pycache__"):
            (fake / name).symlink_to(os.path.join(pkg, name))
    for name in os.listdir(os.path.join(pkg, "tools")):
        if name not in ("quantize_checkpoint.py", "__pycache__"):
            (fake / "tools" / name).symlink_to(os.path.join(pkg, "tools", name))
    (fake / "tools" / "quantize_checkpoint.py").write_text('import sys\nprint("broken on purpose")\nsys.exit(2)\n')
    r = _dry_run(str(tmp_path))
    sys.stdout.write(r.stdout[-2000:])
    assert r.returncode != 0
    assert "norma_tpu_torch.tools.make_golden flags OK" in r.stdout  # the tool before it ran
    assert "FAILED: python -m norma_tpu_torch.tools.quantize_checkpoint --help exited 2" in r.stdout
    assert "broken on purpose" in r.stdout
    assert "lost flag" not in r.stdout and "DRY RUN OK" not in r.stdout
