"""The tp parts of the port's multi-device dry run
(norma_tpu_torch.parallel.dryrun.dryrun_tp, the tp mesh of
__graft_entry__.py's dryrun_multichip) on virtual CPU devices: tp=4 where
4 divides the device count, else 2; with the JAX dry run's draft/verify
part on a tp-sharded draft."""

import re

import pytest

from norma_tpu_torch.parallel.dryrun import dryrun_tp


@pytest.mark.parametrize("n,dp,tp", [(4, 1, 4), (8, 2, 4), (2, 1, 2), (6, 3, 2)])
def test_dryrun_tp_on_cpu_devices(n, dp, tp):
    line = dryrun_tp(n, ["cpu"] * n)
    assert line.startswith(f"tp mesh dp={dp} tp={tp} over {['cpu'] * n}")
    assert "fused ladder" in line and "kernel config" in line
    m = re.search(r"draft/verify \[([0-9, ]+)\] tokens over (\d+) rounds$", line)
    assert m, line
    toks = [int(x) for x in m.group(1).split(",")]
    assert len(toks) == max(2 * dp, 2) and int(m.group(2)) >= 1
