"""The port's multi-device dry run (norma_tpu_torch.parallel.dryrun, the dp
parts of __graft_entry__.py's dryrun_multichip) on 4 virtual CPU devices."""

import pytest
import torch

from norma_tpu_torch.parallel.dryrun import dryrun_multichip


def test_dryrun_multichip_on_four_cpu_devices(capsys):
    line = dryrun_multichip(4, devices=["cpu"] * 4)
    assert line.startswith("dryrun_multichip OK: mesh dp=4 tp=1") and "B=8" in line
    assert line in capsys.readouterr().out


def test_dryrun_defaults_to_the_cards(monkeypatch):
    # Without devices it takes the cards; with none it says how to ask for the CPU.
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="devices=\\['cpu'\\]"):
        dryrun_multichip(2)
