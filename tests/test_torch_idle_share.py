"""The idle share over overlapping device work (norma_tpu_torch.tracing.
busy_union_ms / idle_share): data-parallel replicas on one card run on
several streams at once, so their kernels overlap and a sum of device
time can exceed the wall; the union counts overlapping time once."""

import json

import pytest

from norma_tpu_torch import tracing


def _trace(path, events):
    path.write_text(json.dumps({"traceEvents": [dict(ph="X", **e) for e in events]}))


def test_busy_union_counts_overlap_once(tmp_path):
    _trace(tmp_path / "h.1.pt.trace.json", [
        dict(cat="kernel", name="a", ts=0.0, dur=1000.0, args={"device": 0}),
        dict(cat="kernel", name="b", ts=500.0, dur=1000.0, args={"device": 0}),  # overlaps a by 0.5 ms
        dict(cat="gpu_memcpy", name="c", ts=3000.0, dur=250.0, args={"device": 0}),
        dict(cat="kernel", name="d", ts=3100.0, dur=50.0, args={"device": 0}),  # inside c
        dict(cat="gpu_user_annotation", name="region", ts=0.0, dur=9000.0, args={"device": 0}),  # not busy time
        dict(cat="cpu_op", name="host", ts=0.0, dur=9000.0),
    ])
    assert tracing.busy_union_ms(str(tmp_path)) == pytest.approx(1.5 + 0.25)
    # The per-name report sums: the overlap counts twice there.
    rep = tracing.device_time_report(str(tmp_path))
    assert sum(t for t, _ in rep.values()) == pytest.approx(2.05)


def test_idle_share_needs_device_events(tmp_path):
    # The CPU's profile holds no device events: no idle share to report.
    with pytest.raises(RuntimeError, match="no device events"):
        tracing.idle_share(lambda: None, str(tmp_path / "t"))
