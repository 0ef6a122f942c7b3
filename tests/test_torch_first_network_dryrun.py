"""The port's first-network runbook (norma_tpu_torch/tools/first_network_run.sh,
the twin of tests/test_first_network_dryrun.py): its --dry-run runs the
offline prefix -- the API constructions and every tool flag the networked
steps use -- and must stay green."""

import os
import subprocess
import sys


def test_first_network_dry_run():
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run(
        ["bash", os.path.join(repo, "norma_tpu_torch", "tools", "first_network_run.sh"), "--dry-run"],
        capture_output=True, text=True, timeout=300, cwd=repo,
    )
    sys.stdout.write(r.stdout[-2000:])
    sys.stderr.write(r.stderr[-2000:])
    assert r.returncode == 0
    assert "DRY RUN OK" in r.stdout
    for tool in ("make_golden", "quantize_checkpoint", "eval_wer"):
        assert f"norma_tpu_torch.tools.{tool} flags OK" in r.stdout
