"""The per-layer metrics that read the program's own records
(``benchmark/harness/records.py``) on synthetic snapshots: each value by
hand, and None on a store that let records go or holds another count of
windows than the run saw, and on a program without the records."""

import types

import pytest

from benchmark import run as bench_run
from benchmark.harness import records

MS = 1_000_000  # ns


def _window(start_ms, front_ms, loops, end_ms, passes, graph=True, dispatch=None):
    regions = [["window", start_ms * MS, end_ms * MS], ["window_front", start_ms * MS, (start_ms + front_ms) * MS]]
    regions += [["token_loop", a * MS, b * MS] for a, b in loops]
    regions.append(["ladder_finish", (end_ms - 1) * MS, end_ms * MS])
    d = dispatch or (start_ms - 5, start_ms - 4)
    return dict(kind="window", graph=graph, regions=regions, passes=passes, dispatch=[d[0] * MS, d[1] * MS],
                t0=d[0] * MS, t1=end_ms * MS)


def _snap(windows=(), rounds=(), dropped=0, kept_from_ns=0):
    return dict(spans=[], windows=list(windows), rounds=list(rounds), clocks=[], dropped=dropped,
                kept_from_ns=kept_from_ns)


def _batch_run(windows):
    return types.SimpleNamespace(data=dict(windows=windows), mix=dict(warm_windows=2))


def _batch_snap():
    ws = [_window(0, 10, [(12, 20)], 30, [8, 0]), _window(40, 10, [(52, 60)], 70, [8, 0])]  # warm-up
    ws += [_window(100, 20, [(125, 165), (166, 167)], 180, [40, 0, 0]),
           _window(182, 22, [(207, 247)], 260, [40]),
           _window(259, 18, [(280, 340)], 350, [60])]
    ws.append(_window(400, 30, [(431, 500)], 510, [50], graph=False))  # the traced eager window
    return _snap(ws)


@pytest.mark.parametrize("name,want", [
    ("graph_front_ms.batch", (20 + 22 + 18) / 3),
    ("graph_step_us.batch", (41 + 40 + 60) * 1e3 / 140),
    ("graph_gap_ms.batch", (2 + 0) / 2),  # the third window starts 1 ms before the second ends
])
def test_batch_readers(monkeypatch, name, want):
    monkeypatch.setattr(records, "snapshot", _batch_snap)
    assert bench_run.reader(name)(_batch_run(3)) == pytest.approx(want)


@pytest.mark.parametrize("name", ["graph_front_ms.batch", "graph_step_us.batch", "graph_gap_ms.batch"])
@pytest.mark.parametrize("fault", ["dropped", "short", "long", "no_program"])
def test_batch_readers_refuse(monkeypatch, name, fault):
    snap = _batch_snap()
    n = 3
    if fault == "dropped":
        snap["dropped"] = 1
    elif fault == "short":
        n = 4  # the run counted a window the store does not hold
    elif fault == "long":
        n = 0
    monkeypatch.setattr(records, "snapshot", lambda: None if fault == "no_program" else snap)
    assert bench_run.reader(name)(_batch_run(n)) is None


def _round(dispatch_ms, fetch_ms, window, rows):
    return dict(kind="round", dispatch=[dispatch_ms * MS, (dispatch_ms + 2) * MS],
                fetch=None if fetch_ms is None else [fetch_ms[0] * MS, fetch_ms[1] * MS],
                windows=[window], rows=rows)


def _live():
    # The measured window is [1000, 2000] ms.
    rounds = [
        _round(900, (950, 990), _window(960, 100, [(1070, 1100)], 1200, [30], dispatch=(903, 904)),
               [dict(due_src=700 * MS)]),  # dispatched before the window
        _round(1010, (1300, 1400), _window(1210, 50, [(1270, 1290)], 1310, [20], dispatch=(1013, 1014)),
               [dict(due_src=810 * MS), dict(due_src=None), dict(due_src=890 * MS)]),
        _round(1500, (1980, 2050), _window(1520, 50, [(1570, 1590)], 1600, [20], dispatch=(1503, 1504)),
               [dict(due_src=1300 * MS)]),
    ]
    run = types.SimpleNamespace(data=dict(t0=1.0, t1=2.0), mix={})
    return run, _snap(rounds=rounds, kept_from_ns=100 * MS)


def _p95(v):
    from benchmark.harness.stats import percentile

    return percentile(v, 95)


@pytest.mark.parametrize("name,want", [
    ("src_wait_p95_ms.live", _p95([1010 - 810, 1010 - 890, 1500 - 1300])),
    ("dev_queue_p95_ms.live", _p95([1210 - 1014, 1520 - 1504])),
    ("round_dev_ms.live", (100 + 80) / 2),
    ("fetch_block.live", 100.0 * (100 + 20) / 1000),  # the last fetch clipped at the window's end
])
def test_live_readers(monkeypatch, name, want):
    run, snap = _live()
    monkeypatch.setattr(records, "snapshot", lambda: snap)
    assert bench_run.reader(name)(run) == pytest.approx(want)


@pytest.mark.parametrize("name", ["src_wait_p95_ms.live", "dev_queue_p95_ms.live", "round_dev_ms.live",
                                  "fetch_block.live"])
@pytest.mark.parametrize("fault", ["dropped", "no_rounds", "no_window", "no_program"])
def test_live_readers_refuse(monkeypatch, name, fault):
    run, snap = _live()
    if fault == "dropped":
        snap.update(dropped=5, kept_from_ns=1005 * MS)  # records of the window's start may be gone
    elif fault == "no_rounds":
        run.data.update(t0=3.0, t1=4.0)
    elif fault == "no_window":
        snap["rounds"][1]["windows"] = []
    monkeypatch.setattr(records, "snapshot", lambda: None if fault == "no_program" else snap)
    assert bench_run.reader(name)(run) is None


def test_dropped_before_the_window_is_kept(monkeypatch):
    run, snap = _live()
    snap.update(dropped=5, kept_from_ns=950 * MS)
    monkeypatch.setattr(records, "snapshot", lambda: snap)
    assert bench_run.reader("round_dev_ms.live")(run) == pytest.approx(90.0)
