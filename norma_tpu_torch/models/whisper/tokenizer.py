"""Tokenizer facade (``norma_tpu/models/whisper/tokenizer.py``).

The JAX package wraps the HF ``tokenizers`` library behind the two calls the
framework needs, ``token_to_id`` and ``decode``.  The port reads the same
``tokenizer.json`` with ``json`` alone, so it needs no ``tokenizers``
package, and gives the library's answers for what whisper checkpoints
hold:

  - the model's vocabulary (``model.vocab`` of a WordLevel or BPE model)
    and the ``added_tokens``, which take precedence both ways, as in the
    library;
  - ``decode``: ids become tokens (ids the file does not know are dropped;
    special added tokens too under ``skip_special_tokens``), then the
    decoder: ``ByteLevel`` maps each token's characters back to bytes
    through GPT-2's byte-to-unicode table (a token with a character outside
    it keeps its UTF-8 bytes) and decodes the bytes as UTF-8 with
    replacement characters; no decoder joins the tokens with single spaces.

Any other model type or decoder raises :class:`LoadTokenizerError`.
"""

from __future__ import annotations

import functools
import json
from typing import Dict, List, Optional

from ...errors import LoadTokenizerError

_MODELS = ("WordLevel", "BPE")


@functools.lru_cache(maxsize=1)
def _unicode_to_byte() -> Dict[str, int]:
    """Inverse of GPT-2's byte-to-unicode table: printable bytes stand for
    themselves, the other 68 take the code points from U+0100 up."""
    bs = list(range(ord("!"), ord("~") + 1)) + list(range(ord("¡"), ord("¬") + 1))
    bs += list(range(ord("®"), ord("ÿ") + 1))
    cs = list(bs)
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return {chr(c): b for b, c in zip(bs, cs)}


def _token_bytes(token: str, table: Dict[str, int]) -> bytes:
    try:
        return bytes(table[c] for c in token)
    except KeyError:
        return token.encode("utf-8")


class WhisperTokenizer:
    def __init__(
        self,
        vocab: Dict[str, int],
        added: Dict[str, int],
        special: "set[str]",
        byte_level: bool,
    ) -> None:
        self._vocab = vocab
        self._added = added
        self._special = special
        self._byte_level = byte_level
        self._id_to_token = {i: t for t, i in vocab.items()}
        self._id_to_token.update({i: t for t, i in added.items()})

    @classmethod
    def from_file(cls, path: str) -> "WhisperTokenizer":
        try:
            with open(path, encoding="utf-8") as f:
                spec = json.load(f)
        except (OSError, ValueError) as e:
            raise LoadTokenizerError(f"{path}: {e}") from e
        try:
            model, decoder = spec["model"], spec.get("decoder")
            if model.get("type") not in _MODELS:
                raise LoadTokenizerError(
                    f"{path}: model type {model.get('type')!r} is not supported (expected one of {_MODELS})"
                )
            if decoder is not None and decoder.get("type") != "ByteLevel":
                raise LoadTokenizerError(
                    f"{path}: decoder {decoder.get('type')!r} is not supported (expected ByteLevel or none)"
                )
            vocab = {str(t): int(i) for t, i in model["vocab"].items()}
            added_list = spec.get("added_tokens") or []
            added = {str(a["content"]): int(a["id"]) for a in added_list}
            special = {str(a["content"]) for a in added_list if a.get("special")}
        except (KeyError, TypeError, AttributeError, ValueError) as e:
            raise LoadTokenizerError(f"{path}: malformed tokenizer.json ({e!r})") from e
        return cls(vocab, added, special, decoder is not None)

    def token_to_id(self, token: str) -> Optional[int]:
        i = self._added.get(token)
        return i if i is not None else self._vocab.get(token)

    def decode(self, ids: List[int], skip_special_tokens: bool = True) -> str:
        tokens = []
        for i in ids:
            t = self._id_to_token.get(int(i))
            if t is None or (skip_special_tokens and t in self._special):
                continue
            tokens.append(t)
        if not self._byte_level:
            return " ".join(tokens)
        table = _unicode_to_byte()
        return b"".join(_token_bytes(t, table) for t in tokens).decode("utf-8", errors="replace")
