"""The metrics' arithmetic on synthetic stamps and traces, and the operation
and byte counts against hand-worked shapes."""

import math
import random

import numpy as np
import pytest

from benchmark.harness import live, stats
from benchmark.harness.split import roofline, window_split
from benchmark.harness.trace import Trace, union
from benchmark.yardstick import counts
from benchmark.yardstick.peaks import H100

DISTIL = dict(d_model=1280, encoder_ffn_dim=5120, decoder_ffn_dim=5120, encoder_layers=32, decoder_layers=2,
              vocab_size=51866, max_source_positions=1500, num_mel_bins=128)


def test_percentile_matches_numpy():
    rng = random.Random(3)
    for n in (1, 2, 7, 100, 601):
        v = [rng.random() * 1000 for _ in range(n)]
        for q in (0, 50, 95, 100):
            assert stats.percentile(v, q) == pytest.approx(float(np.percentile(v, q)), rel=1e-12)


def test_audio_rate():
    # 10 windows of 8 rows x 30 s in 4 s from the first dispatch to the last fetch.
    assert stats.audio_rate(8 * 30.0, 10, 100.0, 104.0) == pytest.approx(600.0)


def test_window_latencies_keep_the_window_and_first_time_audio():
    recs = [dict(due=1.0, dispatched=1.3, applied=1.9),  # before the window
            dict(due=9.8, dispatched=10.1, applied=10.6),
            dict(due=10.0, dispatched=10.5, applied=11.25),
            dict(due=None, dispatched=10.7, applied=11.3),  # no first-time audio
            dict(due=10.4, dispatched=10.9, applied=None)]  # never applied
    out = stats.window_latencies(recs, 10.0, 12.0)
    assert out["lat_ms"] == pytest.approx([800.0, 1250.0])
    assert out["wait_ms"] == pytest.approx([300.0, 500.0])


def test_w8_bound_by_hand():
    # 8 rows x [1280 -> 3840]: codes 4,915,200 B + scales 15,360 + x 20,480 + out 122,880.
    nbytes = 1280 * 3840 + 4 * 3840 + 2 * 8 * 1280 + 4 * 8 * 3840
    assert nbytes == 5_073_920
    assert counts.w8_bound_s(8, 1280, 3840) == pytest.approx(nbytes / 3.35e12)
    # Compute-bound at many rows: 2 * 4096 * 1280 * 3840 ops at the bf16 peak.
    assert counts.w8_bound_s(4096, 1280, 3840) == pytest.approx(2 * 4096 * 1280 * 3840 / 989e12)


def test_q8a8_bound_by_hand():
    m = 8 * 1500
    ops = 2 * m * 1280 * 3840
    nbytes = m * 1280 + 4 * m + 1280 * 3840 + 6 * 3840 + 2 * m * 3840
    assert counts.q8a8_bound_s(m, 1280, 3840, 2) == pytest.approx(max(ops / 1979e12, nbytes / 3.35e12))
    assert ops / 1979e12 > nbytes / 3.35e12  # operations bound at this shape


def test_launch_counts_of_a_distil_window():
    # 444 steps + the prefill, 2 layers x 6 products + the head: the
    # 5785 w8 launches and 128 q8a8 launches a B=8 window makes.
    w8 = counts.w8_launches(DISTIL, 8, 444)
    assert len(w8) == 5785
    assert w8[0] == (24, 1280, 3840) and w8[12] == (24, 1280, 51866) and w8[13] == (8, 1280, 3840)
    assert len(counts.q8a8_launches(DISTIL, 8)) == 128


def test_model_flops_by_hand():
    cfg = dict(d_model=4, encoder_ffn_dim=16, decoder_ffn_dim=16, encoder_layers=1, decoder_layers=1,
               vocab_size=10, max_source_positions=3, num_mel_bins=2)
    d, t, f, v = 4, 3, 16, 10
    stem = 2 * 6 * 3 * 2 * d + 2 * t * 3 * d * d
    enc = 2 * t * (4 * d * d + 2 * d * f) + 4 * t * t * d
    xkv = 2 * 2 * t * d * d
    tok = lambda keys: 2 * (6 * d * d + 2 * d * f) + 4 * keys * d + 4 * t * d + 2 * d * v
    want = stem + enc + xkv + sum(tok(k) for k in (1, 2, 3)) + sum(tok(k) for k in (4, 5))
    assert counts.model_flops(cfg, 1, 2) == pytest.approx(want)
    assert counts.model_flops(cfg, 3, 2) == pytest.approx(3 * want)


def test_union_and_busy():
    assert union([(0, 2), (1, 3), (5, 6)]) == [(0, 3), (5, 6)]
    assert union([(0, 2), (1, 3), (5, 6)], 1, 5.5) == [(1, 3), (5, 5.5)]
    tr = Trace.from_events([
        dict(ph="X", cat="kernel", name="a", ts=0, dur=10),
        dict(ph="X", cat="kernel", name="b", ts=5, dur=10),
        dict(ph="X", cat="gpu_memcpy", name="c", ts=20, dur=5),
        dict(ph="X", cat="user_annotation", name="benchmark_traced", ts=0, dur=30),
    ], "benchmark_traced")
    assert tr.window == (0.0, 30.0)
    assert tr.busy_union_us(*tr.window) == 20.0
    assert tr.kernel_time_us("a") == (1, 10.0)
    assert tr.top_kernels(1) == [["a", 10e-6]] or tr.top_kernels(1) == [["b", 10e-6]]
    gaps = dict(tr.idle_by_host())
    assert sum(gaps.values()) == pytest.approx(10e-6)


def _window_trace(front_us, steps, step_us):
    """A synthetic eager window: a front kernel, then per step a sampling
    and a w8 kernel."""
    ev, t = [], 0.0
    ev.append(dict(ph="X", cat="kernel", name="q8a8_wgmma_kernel", ts=t, dur=front_us))
    t += front_us + 1.0
    for _ in range(steps):
        ev.append(dict(ph="X", cat="kernel", name="sample_step_kernel", ts=t, dur=step_us / 2))
        ev.append(dict(ph="X", cat="kernel", name="w8_mma_kernel", ts=t + step_us / 2, dur=step_us / 2))
        t += step_us + 0.5
    return Trace.from_events(ev)


class _Run:
    def __init__(self, data):
        self.data = data


def test_window_split_and_roofline():
    tr = _window_trace(100.0, 5, 8.0)
    assert tr.window == (0.0, 100.0 + 1.0 + 4 * 8.5 + 8.0)  # the device's extent
    cfg = dict(DISTIL, decoder_layers=0)  # one w8 launch a pass: the head's
    d = dict(trace=tr, trace_steps=4, cfg=cfg, rows=8)
    s = window_split(_Run(d))
    assert s["front_us"] == pytest.approx(100.0) and s["loop_us"] == pytest.approx(40.0)
    assert window_split(_Run(dict(d, trace_steps=40))) is None  # a trace short of the launches
    # 5 w8 launches of 4 us each: a bound of 1 us each reads 25%.
    assert roofline(tr, "w8_mma_kernel", [1e-6] * 5) == pytest.approx(25.0)
    assert roofline(tr, "w8_mma_kernel", [1e-6] * 50) is None  # not the launches the shapes make


def test_peaks_are_the_data_sheets():
    assert H100 == {"bf16_flops": 989e12, "int8_ops": 1979e12, "bytes_per_s": 3.35e12}
    assert math.isclose(counts.w8_bound_s(1, 16, 16, H100), (256 + 64 + 32 + 64) / 3.35e12)


class _Fed:
    """A feeder's pushed audio and due times, without its thread."""

    def __init__(self, audios, block_n):
        self.sources, self._a, self.block_n = audios, audios, block_n
        self.t0, self.phases, self.block_s = 100.0, [0.0, 0.05], block_n / 16000

    def audio(self, i):
        return self._a[i]

    due = live.Feeder.due


def _record(a, start, n, dispatched, state, width):
    row = np.zeros(width, np.float32)
    row[:n] = a[start:start + n]
    m = live.valid_length(row)
    return dict(dispatched=dispatched, applied=dispatched + 0.5, state=state, due=None, n=m,
                head=row[:live.EDGE].copy(), tail=row[m - live.EDGE:m].copy())


def test_live_rows_found_in_their_streams():
    rng = np.random.default_rng(4)
    a = [rng.standard_normal(4000).astype(np.float32) for _ in range(2)]
    assert live.valid_length(np.concatenate([a[0][:700], np.zeros(50, np.float32)])) == 700
    assert live.find(a[1], a[1][333:349], 300, 400) == 333
    fed = _Fed(a, 100)
    # Chunks of 400 samples, windows of at most 1200.  Stream 0: [0, 400),
    # then [400, 1200) with two new chunks, then [1200, 1600) after the
    # buffer was drained past 1200 -> [1600, 2000): 400 samples skipped.
    # Stream 1 (state 8): [0, 800), then the same start again over [0, 1200).
    recs = [_record(a[0], 0, 400, 1.0, 7, 1300), _record(a[1], 0, 800, 1.1, 8, 1300),
            _record(a[0], 400, 800, 2.0, 7, 1300), _record(a[1], 0, 1200, 2.1, 8, 1300),
            _record(a[0], 1600, 400, 3.0, 7, 1300), _record(a[0], 2000, 400, 9.0, 7, 1300)]
    live.resolve(recs, fed, 1200, 400, until=5.0)
    # Due: the end of the chunk holding the first new sample, on the feeder's clock.
    assert recs[0]["due"] == pytest.approx(100.0 + 400 / 16000)
    assert recs[2]["due"] == pytest.approx(100.0 + 800 / 16000)  # [400, 800) is the oldest new chunk
    assert recs[3]["due"] == pytest.approx(100.05 + 1200 / 16000)  # only [800, 1200) is new
    assert recs[4]["due"] == pytest.approx(100.0 + 2000 / 16000) and recs[4]["skipped"] == 400
    assert [r["skipped"] for r in recs[:4]] == [0, 0, 0, 0]
    assert recs[5]["due"] is None and "skipped" not in recs[5]  # applied after ``until``
    with pytest.raises(RuntimeError):  # a row that is not in its stream
        live.resolve([dict(recs[0], head=-recs[0]["head"])], fed, 1200, 400, until=5.0)
