"""The port's own records (norma_tpu_torch/tracing.py), on the CPU.

  - the recorder: a span's parent is the span open on its own thread; the
    store holds its newest records and counts those it let go
    (``dropped``), none lost to threads recording at once; a span is a ``user_annotation`` in a ``torch.profiler``
    trace; ``NORMA_TPU_TORCH_TRACE=0`` records nothing (a fresh process);
  - the window record of the CPU engine: its regions (the whole window,
    its front, each token loop, its finish) in order inside the window and
    the dispatch, front, loops and finish adding up to the window, its
    loops' passes the engine's decode steps; the eager window's alike;
  - the scheduler's round records with a scripted source: each row's
    bounds in its stream, ``due_src`` the packer's stamp of the chunk that
    holds its first new sample, ``skipped`` on a full-slice drain (the
    counter ``audio_skipped_s`` too), and ``metrics()["latency"]`` from
    the records.
"""

import dataclasses
import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from helpers import TEST_LANG_IDS, TEST_ST, ToyTokenizer, tiny_config
from torch_port_helpers import port_cfg, port_st

import norma_tpu_torch.tracing as ttr
from norma_tpu_torch.audio.sources import AudioSource
from norma_tpu_torch.decode import DecodeEngine, LanguageState, LongFormDecoder
from norma_tpu_torch.frontend.mel import prepare_audio
from norma_tpu_torch.input import Settings
from norma_tpu_torch.model import init_params
from norma_tpu_torch.models.whisper.model import WhisperModel
from norma_tpu_torch.runtime.batching import BatchedTranscriber
from norma_tpu_torch.runtime.channels import RecycledRing

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _engine(max_source_positions=32):
    cfg = dataclasses.replace(port_cfg(tiny_config()), max_source_positions=max_source_positions)
    return DecodeEngine(init_params(cfg, seed=3), cfg, port_st(TEST_ST), language_token_ids=TEST_LANG_IDS)


def _audio(cfg, rows):
    return np.stack([prepare_audio((0.1 * np.random.default_rng(i).standard_normal(8000)).astype(np.float32),
                                   2 * cfg.max_source_positions) for i in range(rows)])


def test_span_parents_are_per_thread():
    got = {}

    def work(tag):
        with ttr.span("outer-" + tag) as a:
            time.sleep(0.01)
            with ttr.span("inner-" + tag, k=tag) as b:
                time.sleep(0.01)
        got[tag] = (a, b)

    threads = [threading.Thread(target=work, args=(t,)) for t in "xy"]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for tag, (a, b) in got.items():
        assert b["parent"] == a["id"] and b["fields"] == {"k": tag}
        assert a["parent"] is None and a["t0"] <= b["t0"] <= b["t1"] <= a["t1"]
    spans = {s["id"] for s in ttr.snapshot()["spans"]}
    assert {r["id"] for pair in got.values() for r in pair} <= spans


def test_store_is_bounded_and_counts_what_it_dropped(monkeypatch):
    import collections

    monkeypatch.setattr(ttr, "_store", collections.deque(maxlen=4))
    monkeypatch.setattr(ttr, "_dropped", 0)
    for i in range(6):
        ttr.record("window", t0=i, t1=10 + i)
    snap = ttr.snapshot()
    assert [r["t1"] for r in snap["windows"]] == [12, 13, 14, 15]
    assert snap["dropped"] == 2 and snap["kept_from_ns"] == 12
    assert [r["t1"] for r in ttr.snapshot(since_ns=14)["windows"]] == [14, 15]
    assert snap["spans"] == [] and snap["rounds"] == []


def test_store_keeps_every_record_under_contention(monkeypatch):
    """More threads than cores recording at once, the interpreter switching
    threads every microsecond: every record is kept or counted as dropped,
    and every span id is distinct."""
    import collections

    monkeypatch.setattr(ttr, "_store", collections.deque(maxlen=1000))
    monkeypatch.setattr(ttr, "_dropped", 0)
    n_threads, each = 2 * (os.cpu_count() or 1) + 2, 300

    def work():
        for _ in range(each):
            with ttr.span("s"):
                pass

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    snap = ttr.snapshot()
    assert len(snap["spans"]) + snap["dropped"] == n_threads * each
    assert len(snap["spans"]) == 1000 and len({s["id"] for s in snap["spans"]}) == 1000


def test_spans_are_user_annotations_in_a_profiler_trace(tmp_path):
    d = tmp_path / "prof"
    with ttr.profile(str(d)):
        with ttr.span("scheduler.fetch"):
            with ttr.span("inner"):
                np.ones(4).sum()
    names = {e["name"] for _, e in ttr.trace_events(str(d)) if e.get("cat") == "user_annotation"}
    assert {"scheduler.fetch", "inner"} <= names


def test_trace_off_records_nothing():
    code = """
import dataclasses, json, sys
sys.path[:0] = [sys.argv[1], sys.argv[1] + '/tests']
import numpy as np
import norma_tpu_torch.tracing as ttr
from test_torch_trace_records import _audio, _engine
with ttr.span('x'):
    pass
ttr.record('round', t0=0, t1=1)
eng = _engine()
p = eng.transcribe_window_async(_audio(eng.cfg, 1), [-1], seed=0)
eng.transcribe_window_fetch(p)
snap = ttr.snapshot()
print(json.dumps([ttr.ENABLED, sum(len(snap[k]) for k in ('spans', 'windows', 'rounds', 'clocks')),
                  snap['dropped'], p.record['regions']]))
"""
    env = dict(os.environ, NORMA_TPU_TORCH_TRACE="0")
    out = subprocess.run([sys.executable, "-c", code, ROOT], env=env, capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == [False, 0, 0, []]


def _check_window(rec, steps, *, graph=False, B, n_active):
    assert rec["kind"] == "window" and rec["graph"] is graph
    assert rec["key"] == [B, False] and rec["n_active"] == n_active
    names = [r[0] for r in rec["regions"]]
    assert names == ["window", "window_front"] + ["token_loop"] * names.count("token_loop") + ["ladder_finish"]
    (w0, w1), front = rec["regions"][0][1:], rec["regions"][1][1:]
    loops = [r[1:] for r in rec["regions"][2:-1]]
    fin = rec["regions"][-1][1:]
    d0, d1 = rec["dispatch"]
    # The CPU runs the window inside its dispatch, on the host clock.
    edges = [d0, w0, *front, *[t for lo in loops for t in lo], *fin, w1, d1, rec["fetched"]]
    assert edges == sorted(edges) and rec["t0"] == d0 and rec["t1"] == rec["fetched"]
    window = w1 - w0
    parts = (front[1] - front[0], sum(b - a for a, b in loops))
    finish = window - sum(parts)  # what the loops and the front leave: the ladder's bookkeeping and packing
    assert all(p > 0 for p in parts) and finish >= fin[1] - fin[0] > 0
    assert sum(parts) + finish == window
    assert sum(rec["passes"]) == steps


@pytest.mark.parametrize("rows", [1, 3])
def test_cpu_window_record(rows):
    """One row (the speculative ladder: one token loop) and three (the
    sequential ladder: a token loop a rung)."""
    eng = _engine()
    s0 = eng.decode_steps
    p = eng.transcribe_window_async(_audio(eng.cfg, rows), [TEST_LANG_IDS[0]] * rows, seed=0, n_active=rows - 1 or 1)
    eng.transcribe_window_fetch(p)
    rec = p.record
    _check_window(rec, eng.decode_steps - s0, B=rows, n_active=rows - 1 or 1)
    assert [r[0] for r in rec["regions"]].count("token_loop") == (1 if rows == 1 else 6)
    assert rec in ttr.snapshot(since_ns=rec["t1"])["windows"]


def test_cpu_eager_window_record():
    eng = _engine()
    s0 = eng.decode_steps
    eng.transcribe_window_eager(_audio(eng.cfg, 3), [TEST_LANG_IDS[0]] * 3, seed=0)
    rec = ttr.snapshot()["windows"][-1]
    _check_window(rec, eng.decode_steps - s0, B=3, n_active=3)


class _Source(AudioSource):
    """Pushed by the test: ``on_data`` is the pipeline's."""

    sample_rate, channels, dtype = 16_000, 1, np.dtype(np.float32)

    def __init__(self):
        self.on_data = None

    def start(self, on_data, on_end=None):
        self.on_data = on_data

    def stop(self):
        pass


def test_round_records_on_a_scripted_stream(monkeypatch):
    """A window of 20480 samples, chunks of 16000.  Round 1 decodes chunk 1
    (the buffer is shorter than a window); chunk 2 arrives while it is in
    flight; the full-slice drain at its apply drains a window's worth,
    4480 samples of chunk 2 that no window decoded; round 2 starts after
    them, its first new sample in chunk 2."""
    eng = _engine(max_source_positions=64)
    model = WhisperModel(eng, ToyTokenizer(), LanguageState(const=TEST_LANG_IDS[0]), language_tokens=TEST_LANG_IDS)
    window_n = 2 * 64 * 160

    def full_slice_drain(self, dr, final_chunk):
        self._drain(min(self.buf.size, self.window_samples))
        self.pending_text.append("x")
        return self.buf.size > 0

    sent = []
    orig_send = RecycledRing.try_send

    def try_send(self, data, length, final=None, stamp=None):
        sent.append((length, stamp))
        return orig_send(self, data, length, final, stamp)

    monkeypatch.setattr(LongFormDecoder, "apply_result", full_slice_drain)
    monkeypatch.setattr(RecycledRing, "try_send", try_send)
    bt = BatchedTranscriber(model, max_streams=2)
    src = _Source()
    rng = np.random.default_rng(0)
    block = lambda n: (0.1 * rng.standard_normal(n)).astype(np.float32)  # noqa: E731
    orig_async = eng.transcribe_window_async
    calls = []

    def window_async(audio, langs, seed, n_active=None):
        calls.append(n_active)
        if len(calls) == 1:
            src.on_data(block(16_000))  # chunk 2 fills and is sent while round 1 is in flight
        return orig_async(audio, langs, seed, n_active)

    eng.transcribe_window_async = window_async
    try:
        h = bt.blocking_start(Settings(source=src))
        reader = threading.Thread(target=lambda: list(h.receiver), daemon=True)
        reader.start()
        src.on_data(block(16_001))  # chunk 1 is sent when its next sample comes
        deadline = time.monotonic() + 60
        mine = lambda: [r for r in ttr.snapshot()["rounds"] if r["sched"] == bt._sched]  # noqa: E731
        while len(mine()) < 2 and time.monotonic() < deadline:
            time.sleep(0.02)
        h.stop()
        reader.join(timeout=30)
        metrics = bt.metrics()
    finally:
        bt.close()
    rounds = mine()
    assert len(rounds) == 2, rounds
    r1, r2 = (r["rows"][0] for r in rounds)
    (n1, stamp1), (n2, stamp2) = sent[:2]
    assert (n1, n2) == (16_000, 16_000) and stamp1 < stamp2
    assert (r1["start"], r1["end"], r1["due_src"], r1["skipped"]) == (0, 16_000, stamp1, 0)
    assert (r2["start"], r2["end"], r2["due_src"], r2["skipped"]) == (window_n, 32_000, stamp2, window_n - 16_000)
    assert metrics["audio_skipped_s"] == (window_n - 16_000) / 16_000
    for r in rounds:
        assert r["B"] == 1 and r["n_active"] == 1 and len(r["windows"]) == 1
        assert r["windows"][0]["kind"] == "window" and r["windows"][0]["n_active"] == 1
        edges = [*r["drain"], *r["dispatch"], *r["fetch"], *r["apply"]]
        assert edges == sorted(edges) and r["t0"] == r["drain"][0] and r["t1"] == r["apply"][1]
        row = r["rows"][0]
        assert r["fetch"][1] <= row["applied"] <= r["apply"][1] and row["ready"] <= r["dispatch"][0]
    assert r1["admitted"] is not None and r2["admitted"] is None  # the stream's first text came with round 1
    # metrics()'s latencies are the records' (milliseconds, rounded to 0.1).
    lat = metrics["latency"]
    ready = [(row["applied"] - row["ready"]) / 1e6 for row in (r1, r2)]
    assert lat["ready_to_applied"]["n"] == 2
    assert lat["ready_to_applied"]["max_ms"] == round(max(ready), 1)
    assert lat["ready_to_applied"]["p50_ms"] == round(float(np.percentile(ready, 50)), 1)
    assert lat["admit_to_first_partial"]["n"] == 1
    assert lat["admit_to_first_partial"]["max_ms"] == round((r1["applied"] - r1["admitted"]) / 1e6, 1)
