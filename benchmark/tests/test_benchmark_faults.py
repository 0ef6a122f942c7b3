"""A run with the timed path broken underneath comes out not correct: once
for each fault a served cell can have (one card, so no exchange between
cards to leave out), and the control (the reference on an int4 grid where
the configuration states int8) reads far above the program."""

import pytest
import torch

from benchmark import control, run
from benchmark.tests.conftest import tiny_spec

LIMIT = 0.05  # the tiny model's logits spread ~0.16; sound runs read ~0.003


def spec(cell="distil-large-v3.batch32", **mix):
    s = tiny_spec(cell, **mix)
    s["limits"]["token_gap"] = LIMIT
    return s


def failing(line):
    return {k for k, c in line["checks"].items() if c["value"] > c["limit"]}


def test_sound_run_is_correct():
    line = run.run_workload(spec(), 11, 0.5, False, "cpu")
    assert line["correct"] is True and not failing(line)


@pytest.mark.parametrize("cell,mix", [("distil-large-v3.batch32", {}),
                                      ("distil-large-v3.live", dict(streams=1, max_streams=1, check_rows=1))])
def test_token_altered_where_produced(monkeypatch, cell, mix):
    from norma_tpu_torch.decode import engine

    inner = engine.sample_step

    def altered(*a, **k):
        nxt, prob, dead = inner(*a, **k)
        step = a[8]  # the loop's per-row step
        first_row = torch.arange(nxt.shape[0], device=nxt.device) == 0
        # Row 0's sixth token becomes a text token the grammar did not pick.
        return torch.where(first_row & (step == 5), 100, nxt).to(nxt.dtype), prob, dead

    monkeypatch.setattr(engine, "sample_step", altered)
    line = run.run_workload(spec(cell, **mix), 12, 40.0 if "live" in cell else 0.5, False, "cpu")
    assert line["correct"] is False
    assert failing(line) & {"token_gap", "grammar_breaks"}


def test_step_returns_its_state_unchanged(monkeypatch):
    from norma_tpu_torch.decode.engine import DecodeEngine

    inner = DecodeEngine._loop_step

    def stale(self, buf, *a, **k):
        ll = buf.ll.clone()
        inner(self, buf, *a, **k)
        buf.ll.copy_(ll)  # the step's forward leaves the logits as they were

    monkeypatch.setattr(DecodeEngine, "_loop_step", stale)
    line = run.run_workload(spec(), 13, 0.5, False, "cpu")
    assert line["correct"] is False
    assert failing(line) & {"token_gap", "grammar_breaks"}


def test_half_the_batch_left_out(monkeypatch):
    from norma_tpu_torch.decode.engine import DecodeEngine

    inner = DecodeEngine.transcribe_window_async

    def half(self, audio, langs, seed, n_active=None):
        return inner(self, audio, langs, seed, n_active=audio.shape[0] // 2)

    monkeypatch.setattr(DecodeEngine, "transcribe_window_async", half)
    line = run.run_workload(spec(), 14, 0.5, False, "cpu")
    assert line["correct"] is False and "rows_missing" in failing(line)


def test_control_reads_above_the_program():
    s = spec()
    rows = control.served_rows(s["cfg"], s["mix"], 15, torch.device("cpu"), 1)
    r = control.readings(s["cfg"], 15, torch.device("cpu"), rows, True, LIMIT)
    assert r["program"]["gap"] <= LIMIT and r["program"]["breaks"] == 0
    assert r["control"]["gap"] > LIMIT or r["control"]["breaks"] > 0
    assert r["control"]["gap"] >= 3 * r["program"]["gap"]


@pytest.mark.card
def test_control_fails_at_the_cells_size(card):
    """On the card, at distil-large-v3's size: the control fails the limit
    that the program's run meets."""
    from benchmark.tests.conftest import ROOT

    sp = run.load_spec(ROOT, "distil-large-v3.batch32")
    rows = control.served_rows(sp["cfg"], sp["mix"], 21, card, 1)
    limit = sp["limits"]["token_gap"]
    r = control.readings(sp["cfg"], 21, card, rows, True, limit)
    assert r["program"]["gap"] <= limit and r["program"]["breaks"] == 0
    assert r["control"]["gap"] > limit or r["control"]["breaks"] > 0
