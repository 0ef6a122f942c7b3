"""The greedy timestamp grammar of the served decode, judged on the
reference's logits.

The served token loop picks, at each step, the most probable token among
those its grammar allows (Whisper's timestamp rules: suppressed tokens;
the first token a timestamp in [<|0.00|>, <|1.00|>]; after a timestamp
pair text, after a lone timestamp a later timestamp; timestamps forced
where their summed probability reaches the best text token's; no
timestamp at or below the last one).  Where nothing is allowed it pushes
the vocabulary's last id (a deadlock, as the reference implementation
does).  These rules are restated here from that description, in float64.

:func:`judge_row` follows a served row token by token.  For each token it
takes the grammar's allowed set in the state the served tokens before it
left, and reads the token's gap: the reference's best allowed logit
minus the token's logit (0 where the served token is the reference's
choice, and for a deadlock's last id where the reference deadlocks too).
A token outside every allowed set is a grammar break.  The one decision
of the grammar that compares two probabilities (timestamps forced or
not) can go either way when its two sides lie within ``tol`` of each
other in log space: there the token is judged against both outcomes and
the smaller gap counts.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence

import torch

NEG = float("-inf")


@dataclass(frozen=True)
class Tokens:
    """Special token ids of the vocabulary."""

    eot: int
    no_timestamps: int
    zero_sec: int
    one_sec: int

    @classmethod
    def from_config(cls, special: dict) -> "Tokens":
        return cls(special["eot"], special["no_timestamps"], special["zero_sec"], special["one_sec"])


@dataclass
class Judgement:
    gaps: List[float]  # per judged token, for tokens inside an allowed set
    breaks: int  # tokens outside every allowed set
    judged: int
    exact: int  # tokens equal to the reference's choice

    @property
    def max_gap(self) -> float:
        return max(self.gaps, default=0.0)


class Grammar:
    def __init__(self, vocab: int, suppress: Sequence[int], tok: Tokens, device):
        ids = torch.arange(vocab, device=device)
        self.vocab, self.tok, self.ids = vocab, tok, ids
        sup = torch.zeros(vocab, dtype=torch.bool, device=device)
        sup[[t for t in suppress if 0 <= t < vocab]] = True
        sup[tok.no_timestamps] = True
        self.unsuppressed = ~sup
        self.is_ts = ids > tok.no_timestamps
        self.is_text = ids < tok.no_timestamps
        self.first = (ids >= tok.zero_sec) & (ids <= tok.one_sec)

    def allowed(self, lp: torch.Tensor, step: int, prev1: int, prev2: int, last_ts: int, tol: float):
        """The allowed sets [bool V] the grammar may take at this step
        (two where the forcing test is within ``tol``)."""
        tok = self.tok
        if step == 0:
            return [self.first]
        past = self.is_ts & (self.ids <= last_ts)
        if prev1 > tok.no_timestamps:
            if prev2 >= tok.eot:
                return [self.unsuppressed & ~self.is_ts]
            return [self.unsuppressed & self.is_ts & ~past]
        p = torch.exp(lp)
        sum_ts = torch.where(self.unsuppressed & self.is_ts, p, 0.0).sum()
        max_txt = torch.where(self.unsuppressed & self.is_text, p, 0.0).amax()
        forced = self.unsuppressed & self.is_ts & ~past
        free = self.unsuppressed & ~past
        margin = float(torch.log(sum_ts) - torch.log(max_txt))
        if abs(margin) <= tol:
            return [forced, free]
        return [forced] if margin >= 0 else [free]

    def choice(self, lp: torch.Tensor, allowed: torch.Tensor) -> int:
        """The greedy pick in ``allowed``: its best token, or the last id
        on a deadlock (nothing allowed)."""
        if not bool(allowed.any()):
            return self.vocab - 1
        return int(torch.where(allowed, lp, NEG).argmax())

    def judge_row(self, logits: torch.Tensor, tokens: Sequence[int], tol: float,
                  picks: Optional[Sequence[int]] = None) -> Judgement:
        """Judge the served ``tokens`` (prefix of 3 included; the final
        token, an end of text the loop may have pushed at its cap, is not
        judged) on ``logits`` [n, V] (row p predicts token p + 1).
        ``picks``, where given, are judged in the served tokens' place:
        another implementation's choice at each judged position (the
        control's), the state still following the served tokens."""
        lp = torch.log_softmax(logits.double(), dim=-1)
        tokens = [int(t) for t in tokens]
        gaps, breaks, exact = [], 0, 0
        last_ts = 0
        judged = range(3, len(tokens) - 1)
        for i, j in enumerate(judged):
            row = lp[j - 1]
            sets = self.allowed(row, j - 3, tokens[j - 1], tokens[j - 2], last_ts, tol)
            t = tokens[j] if picks is None else int(picks[i])
            best = []
            for a in sets:
                c = self.choice(row, a)
                if t == c:
                    best.append(0.0)
                elif bool(a.any()) and bool(a[t]):
                    best.append(float(row[c] - row[t]))
            if best:
                g = min(best)
                gaps.append(g)
                exact += g == 0.0
            else:
                breaks += 1
            if tokens[j] > self.tok.no_timestamps:
                last_ts = tokens[j]
        return Judgement(gaps, breaks, len(judged), exact)

    def picks(self, logits: torch.Tensor, tokens: Sequence[int]) -> List[int]:
        """Greedy choices of ``logits`` at each judged position of the
        served ``tokens``, the grammar's state following the served
        tokens and its forcing test decided by these logits alone."""
        lp = torch.log_softmax(logits.double(), dim=-1)
        tokens = [int(t) for t in tokens]
        out, last_ts = [], 0
        for j in range(3, len(tokens) - 1):
            # A negative tolerance: the forcing test is never ambiguous.
            (a,) = self.allowed(lp[j - 1], j - 3, tokens[j - 1], tokens[j - 2], last_ts, -1.0)
            out.append(self.choice(lp[j - 1], a))
            if tokens[j] > self.tok.no_timestamps:
                last_ts = tokens[j]
        return out
