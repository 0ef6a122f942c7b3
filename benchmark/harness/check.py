"""The comparison that decides ``correct``.

Once the window has closed, the peak memory has been read and the
program's state is freed, the weights are drawn again from the seed and
the plain reference (``reference/``) follows each sampled served row:
its encoder on the row's audio, its decoder teacher-forced over the
served tokens.  Each served token is judged by the grammar on the
reference's logits (``reference/grammar.py``): the widest gap by which a
served token's logit lies below the reference's best allowed one, and
the count of served tokens that no allowed set holds.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from ..reference.grammar import Grammar, Tokens
from ..reference.whisper_ref import Reference
from .weights import make_weights


def grammar_of(cfg: Dict, device) -> Grammar:
    a = cfg["assumed"]
    return Grammar(cfg["vocab_size"], a["suppress_tokens"], Tokens.from_config(a["special_tokens"]), device)


def reference_of(cfg: Dict, seed: int, device, bits: int = 8) -> Reference:
    return Reference(make_weights(cfg, seed, device), cfg["encoder_attention_heads"], bits)


def compare(cfg: Dict, seed: int, device, samples: List[Tuple], tol: float) -> Dict:
    """Judge ``samples`` [(audio row, served tokens)]; returns the widest
    gap, the grammar breaks, and the tokens judged and exact."""
    ref = reference_of(cfg, seed, device)
    g = grammar_of(cfg, device)
    gap, breaks, judged, exact = 0.0, 0, 0, 0
    for row, tokens in samples:
        _, logits = follow(ref, row, tokens, device)
        j = g.judge_row(logits, tokens, tol)
        gap, breaks = max(gap, j.max_gap), breaks + j.breaks
        judged, exact = judged + j.judged, exact + j.exact
    return dict(token_gap=gap, grammar_breaks=breaks, judged=judged, exact=exact, rows=len(samples))


def follow(ref: Reference, row, tokens, device):
    """(encoder output, teacher-forced logits) of one served row."""
    audio = torch.as_tensor(row, dtype=torch.float32).to(device)
    xa = ref.encode(audio)
    return xa, ref.logits(xa, tokens)
