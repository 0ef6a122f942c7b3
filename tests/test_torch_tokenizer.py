"""The port's tokenizer.json reader (models/whisper/tokenizer.py) against
the ``tokenizers`` library, on the fixture checkpoint's WordLevel file and
on a ByteLevel BPE file built here: token_to_id for every special and
language token, decode with and without skip_special_tokens (non-ASCII
text, special tokens, split multi-byte characters, unknown ids), and
LoadTokenizerError for what the reader does not support."""

import json

import numpy as np
import pytest

pytest.importorskip("tokenizers")

from tokenizers import Tokenizer, decoders, models, pre_tokenizers, trainers  # noqa: E402

from checkpoint_fixture import build_vocab, make_checkpoint_dir  # noqa: E402

from norma_tpu_torch.errors import LoadTokenizerError  # noqa: E402
from norma_tpu_torch.models.whisper.languages import ALL_LANGUAGES  # noqa: E402
from norma_tpu_torch.models.whisper.tokenizer import WhisperTokenizer  # noqa: E402

SPECIALS = ["<|endoftext|>", "<|startoftranscript|>", "<|en|>", "<|fr|>", "<|transcribe|>",
            "<|translate|>", "<|nospeech|>", "<|notimestamps|>", "<|0.00|>", "<|0.02|>"]
TEXT = ["Hello wörld, ça va? Grüße aus Köln.", "日本語のテキストと emoji 🎉 mixed in.",
        "naïve café — déjà vu; Ελληνικά και русский текст.", "plain ascii words again and again"]


@pytest.fixture(scope="module")
def wordlevel(tmp_path_factory):
    d = tmp_path_factory.mktemp("wl")
    make_checkpoint_dir(d)
    path = str(d / "tokenizer.json")
    return path, Tokenizer.from_file(path), WhisperTokenizer.from_file(path)


@pytest.fixture(scope="module")
def bytelevel(tmp_path_factory):
    tok = Tokenizer(models.BPE())
    tok.pre_tokenizer = pre_tokenizers.ByteLevel(add_prefix_space=False)
    tok.decoder = decoders.ByteLevel()
    trainer = trainers.BpeTrainer(vocab_size=400, initial_alphabet=pre_tokenizers.ByteLevel.alphabet(),
                                  special_tokens=SPECIALS[:2])
    tok.train_from_iterator(TEXT * 20, trainer)
    tok.add_special_tokens(SPECIALS[2:8])
    tok.add_tokens(SPECIALS[8:])  # timestamps: added, not special
    path = str(tmp_path_factory.mktemp("bl") / "tokenizer.json")
    tok.save(path)
    return path, Tokenizer.from_file(path), WhisperTokenizer.from_file(path)


def test_wordlevel_token_to_id(wordlevel):
    _, lib, ours = wordlevel
    vocab, specials = build_vocab()
    names = list(vocab) + specials + [lang.token() for lang in ALL_LANGUAGES] + ["<|nocaptions|>", "nope"]
    for name in names:
        assert ours.token_to_id(name) == lib.token_to_id(name), name


@pytest.mark.parametrize("skip", [True, False])
def test_wordlevel_decode(wordlevel, skip):
    _, lib, ours = wordlevel
    rng = np.random.default_rng(0)
    n = lib.get_vocab_size()
    for _ in range(50):
        ids = rng.integers(0, n + 3, size=int(rng.integers(0, 12))).tolist()  # some ids unknown
        assert ours.decode(ids, skip_special_tokens=skip) == lib.decode(ids, skip_special_tokens=skip), ids
    assert ours.decode([]) == lib.decode([]) == ""


def test_bytelevel_token_to_id(bytelevel):
    _, lib, ours = bytelevel
    for name in SPECIALS + list(lib.get_vocab())[:200] + ["nope", "<|de|>"]:
        assert ours.token_to_id(name) == lib.token_to_id(name), name


@pytest.mark.parametrize("skip", [True, False])
def test_bytelevel_decode(bytelevel, skip):
    _, lib, ours = bytelevel
    sp = [lib.token_to_id(s) for s in SPECIALS]
    for text in TEXT:
        ids = lib.encode(text).ids
        for seq in (ids, sp[1:5] + ids + sp[8:] + [sp[0]], ids[: len(ids) // 2], ids[1:] + [10**6]):
            assert ours.decode(seq, skip_special_tokens=skip) == lib.decode(seq, skip_special_tokens=skip), seq
    # A multi-byte character cut in half decodes to replacement characters
    # the way the library's lossy UTF-8 does.
    rng = np.random.default_rng(1)
    n = lib.get_vocab_size()
    for _ in range(100):
        ids = rng.integers(0, n, size=int(rng.integers(1, 8))).tolist()
        assert ours.decode(ids, skip_special_tokens=skip) == lib.decode(ids, skip_special_tokens=skip), ids


def _rewrite(src, tmp_path, edit):
    spec = json.load(open(src))
    edit(spec)
    p = tmp_path / "tokenizer.json"
    p.write_text(json.dumps(spec))
    return str(p)


def test_unsupported_files_raise(bytelevel, tmp_path):
    path = bytelevel[0]
    with pytest.raises(LoadTokenizerError, match="decoder"):
        WhisperTokenizer.from_file(_rewrite(path, tmp_path, lambda s: s.update(decoder={"type": "WordPiece"})))
    with pytest.raises(LoadTokenizerError, match="model type"):
        WhisperTokenizer.from_file(_rewrite(path, tmp_path, lambda s: s["model"].update(type="Unigram")))
    with pytest.raises(LoadTokenizerError, match="malformed"):
        WhisperTokenizer.from_file(_rewrite(path, tmp_path, lambda s: s["model"].pop("vocab")))
    with pytest.raises(LoadTokenizerError):
        WhisperTokenizer.from_file(str(tmp_path / "missing.json"))
    bad = tmp_path / "bad.json"
    bad.write_text("{not json")
    with pytest.raises(LoadTokenizerError):
        WhisperTokenizer.from_file(str(bad))
