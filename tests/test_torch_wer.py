"""The port's WER metric and its manifest runner
(``norma_tpu_torch/eval/wer.py``, ``norma_tpu_torch/tools/eval_wer.py``).

The five cases of ``tests/test_wer.py`` on the port, each also held against
the JAX package on the same inputs, and the runner end to end: the same
WAVs and manifest through the port's tool and the JAX package's
``tools/eval_wer.py`` on one checkpoint from ``tests/checkpoint_fixture.py``
(f32 on the CPU) give the same hypotheses, hence the same WER.
"""

import importlib.util
import json
import os
import wave

import numpy as np
import pytest

import norma_tpu.eval as jax_eval
from norma_tpu_torch.eval import edit_distance, normalize_text, word_error_rate
from norma_tpu_torch.tools import eval_wer as ew

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_tool():
    spec = importlib.util.spec_from_file_location("jax_eval_wer_tool", os.path.join(REPO, "tools", "eval_wer.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_normalize():
    s = "Hello, World!  It's ME."
    assert normalize_text(s) == "hello world its me" == jax_eval.normalize_text(s)


def test_edit_distance_ops():
    r, h = "a b c d".split(), "a x c".split()
    assert edit_distance(r, h) == (1, 1, 0, 2) == jax_eval.edit_distance(r, h)


def test_wer_perfect():
    pairs = [("hello world", "Hello, world!")]
    assert word_error_rate(pairs).wer == 0.0 == jax_eval.word_error_rate(pairs).wer


def test_wer_corpus():
    pairs = [
        ("the quick brown fox", "the quick brown fox"),
        ("jumps over the lazy dog", "jumps over a lazy"),  # 1 sub, 1 del
    ]
    res = word_error_rate(pairs)
    assert res.ref_words == 9
    assert res.substitutions == 1 and res.deletions == 1 and res.insertions == 0
    assert abs(res.wer - 2 / 9) < 1e-9
    assert vars(res) == vars(jax_eval.word_error_rate(pairs))


def _write_wav(path, seconds=0.3, freq=220.0):
    n = int(16_000 * seconds)
    pcm = (np.sin(2 * np.pi * freq * np.arange(n) / 16000) * 8000).astype(np.int16)
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16_000)
        w.writeframes(pcm.tobytes())


def _manifest(tmp_path, texts, seconds=0.3):
    with open(tmp_path / "m.jsonl", "w") as f:
        for i, text in enumerate(texts):
            p = tmp_path / f"u{i}.wav"
            _write_wav(p, seconds, 220.0 + 110 * i)
            f.write(json.dumps({"wav": str(p), "text": text}) + "\n")
    return str(tmp_path / "m.jsonl")


def test_eval_wer_manifest_runner(tmp_path):
    """The manifest loaders and the evaluate() loop of the port's tool,
    driven with synthetic WAVs and a fake transcribe function, as JAX's."""
    items = ew.load_manifest(_manifest(tmp_path, ["hello world", "the quick fox"]))
    assert [t for _, t in items] == ["hello world", "the quick fox"]
    assert items == _jax_tool().load_manifest(str(tmp_path / "m.jsonl"))

    ls = tmp_path / "ls" / "84" / "121123"
    ls.mkdir(parents=True)
    _write_wav(ls / "84-121123-0000.wav")
    (ls / "84-121123.trans.txt").write_text("84-121123-0000 GO DO YOU HEAR\n84-121123-9999 MISSING AUDIO\n")
    ls_items = ew.load_librispeech(str(tmp_path / "ls"))
    assert len(ls_items) == 1  # the missing-wav line is skipped
    assert ls_items[0][1] == "GO DO YOU HEAR"
    assert ls_items == _jax_tool().load_librispeech(str(tmp_path / "ls"))

    hyps = {str(tmp_path / "u0.wav"): "hello world", str(tmp_path / "u1.wav"): "the quick dog"}
    it = iter(range(len(items)))

    def fake_transcribe(audio):
        assert audio.dtype == np.float32 and audio.size > 0
        return hyps[items[next(it)][0]]

    res = ew.evaluate(fake_transcribe, items, log=lambda *_: None)
    assert res["n_utterances"] == 2
    assert res["ref_words"] == 5
    assert abs(res["wer"] - 1 / 5) < 1e-9
    assert res["audio_seconds"] > 0


def test_eval_wer_tool_matches_jax_on_a_checkpoint(tmp_path, monkeypatch):
    """Both packages' runners over the same manifest and checkpoint: the
    port's hypotheses equal JAX's, so every count and the WER are equal."""
    from checkpoint_fixture import make_checkpoint_dir

    ckpt = tmp_path / "ckpt"
    ckpt.mkdir()
    make_checkpoint_dir(str(ckpt))
    m = _manifest(tmp_path, ["w44 w91 w3", "w7 w8", "hello"], seconds=1.2)
    hyps = {}
    for name, mod in (("port", ew), ("jax", _jax_tool())):
        seen = []
        inner = mod.evaluate

        def spy(transcribe, items, limit=0, log=print, inner=inner, seen=seen):
            return inner(lambda a: seen.append(transcribe(a)) or seen[-1], items, limit, log)

        monkeypatch.setattr(mod, "evaluate", spy)
        out = str(tmp_path / f"{name}.json")
        argv = [out, "--manifest", m, "--local-dir", str(ckpt)]
        if name == "port":
            mod.main(argv + ["--cpu"])
        else:
            monkeypatch.setattr("sys.argv", ["eval_wer.py"] + argv)
            mod.main()
        with open(out) as f:
            hyps[name] = (seen, json.load(f))
    (port_h, port_r), (jax_h, jax_r) = hyps["port"], hyps["jax"]
    assert port_h == jax_h and len(port_h) == 3
    for k in ("wer", "substitutions", "deletions", "insertions", "ref_words", "n_utterances", "audio_seconds"):
        assert port_r[k] == jax_r[k], k
    assert port_r["ref_words"] == 6
