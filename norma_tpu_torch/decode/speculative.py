"""Speculative decoding: a shallow draft decoder proposes, the target
verifies (``norma_tpu/decode/speculative.py``).

The distil-whisper checkpoints share the target's encoder lineage, vocab
and tokenizer, so one encoder pass feeds both decoders: per round the
draft proposes K greedy tokens in K+1 one-token steps, then the target
scores all K proposals plus one bonus position in ONE chunked forward
(:func:`~norma_tpu_torch.model.whisper.decoder_chunk`), so the target's
weights stream once for up to K+1 committed tokens.

Exact greedy equivalence: every committed token is the TARGET's own
grammar-masked greedy choice.  Position j of a verify chunk is accepted
only if the target's choice (with the timestamp-grammar state the plain
loop would carry, advanced along the accepted prefix) equals the draft's
proposal; the first mismatch commits the target's choice instead.  The
avg_logprob gate reads the target's own masked probabilities, so the
temperature fallback is unchanged: the t=0 rung is speculative, t>0 rungs
run the plain sequential ladder over the same encoder features.

Cache staleness: each round writes chunk K/V at positions [n-1, n+K) and
commits n' >= n+1, so rows left by rejected proposals sit at positions
>= n'-1 and are overwritten by the next round's writes (which start at
n'-1) before any read; queries mask keys beyond their own position.

The round loop keeps all its state on the device (tokens, n, grammar
state, sum of log-probabilities, finished flags, rounds per row, rounds
run), and its stop test runs there: the loop is one
``DecodeEngine._device_while`` whose pass is one round, "any row
unfinished and fewer than ``mtp - 1 - n0`` rounds run" (the JAX package's
``lax.while_loop``).  Rounds after every row has finished change nothing
(the caches carry K+1 rows of slack for the writes of finished rows).

A window is one device program with one host read, as the JAX package's
``(K, detect)`` program and its one fetch are: on CUDA one CUDA graph per
(rows, samples, detection, K) holds mel, encoder, both cross-K/V, both
prefills, the no-speech gate, the round loop as one WHILE node and the
packed result; the host applies the avg_logprob gate to it, and only rows
that fail it take the t>0 fallback, one more program (a graph per rows)
with one more read.  On the CPU the same structure runs eagerly.
:meth:`SpeculativeEngine.transcribe_window_eager` runs the rounds one by
one with a host read before each, and no graphs: the comparison path.

Tensor parallelism: target and draft as
:class:`~norma_tpu_torch.parallel.collectives.TPParams` over one group run
every draft step and verify chunk on each rank's Megatron shard, the
ranks meeting in the layer code's collectives (``DecodeEngine._fan``);
both decoders' cross-K/V and caches are per-rank
:class:`~norma_tpu_torch.parallel.collectives.RankList` values, and the
round's state and the grammar run once per process on the logits every
rank gets whole.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..constants import LOGPROB_THRESHOLD, NO_SPEECH_THRESHOLD, TEMPERATURES
from ..errors import NormaError
from ..model.config import WhisperConfig
from ..model.load import Params
from ..model.whisper import quantize_cross_kv as quantize_xkv8
from ..ops.quant_matmul import head_kernel_layout
from ..ops.sample_step import sample_step
from ..parallel.collectives import RankList, TPParams, first, per_rank
from ..tracing import instrument
from .engine import DecodeEngine, DecodingResult, _Program, _signature
from .masks import SpecialTokens


class _SpecBuffers:
    """The round loop's tensors: inputs (both cross-K/V, both caches: the
    caller's own, the caches written in place) and state (tokens, n,
    p1/p2/last timestamp, sum of logprobs, finished flags, live rounds per
    row, and ``pos``, the rounds run: the position of the loop's stop
    test), all on the device.  Under tp the inputs are
    :class:`~norma_tpu_torch.parallel.collectives.RankList` values (each
    rank's own) and the state is held once."""

    def __init__(self, ins):
        tokens_init = ins[8]
        B, Tmax = tokens_init.shape
        dev = tokens_init.device
        self.xk, self.xv, self.dxk, self.dxv, self.ck, self.cv, self.dk, self.dv = ins[:8]
        self.tokens = torch.empty((B, Tmax), dtype=torch.int32, device=dev)
        i32 = lambda: torch.empty(B, dtype=torch.int32, device=dev)
        self.n, self.p1, self.p2, self.last_ts, self.rounds = i32(), i32(), i32(), i32(), i32()
        self.slp = torch.empty(B, dtype=torch.float32, device=dev)
        self.fin = torch.empty(B, dtype=torch.bool, device=dev)
        self.pos = torch.empty(1, dtype=torch.int64, device=dev)
        self.slots = torch.arange(Tmax, device=dev)[None]

    def start(self, ins, n0: int, prev1, prev2, fin_init) -> None:
        self.tokens.copy_(ins[8])
        self.n.fill_(n0)
        self.p1.copy_(prev1)
        self.p2.copy_(prev2)
        self.last_ts.zero_()
        self.slp.zero_()
        self.fin.copy_(fin_init)
        self.rounds.zero_()
        self.pos.zero_()


class SpeculativeEngine(DecodeEngine):
    """DecodeEngine whose greedy (t=0) rung runs draft/verify speculation.

    ``draft_params``/``draft_cfg`` describe a shallow Whisper decoder with
    the same d_model, vocab and max_target_positions as the target; its
    encoder weights are unused (the target's encoder output feeds the
    draft's own cross-attention projections).

    ``spec_k`` proposals are drafted per round; ``spec_k="auto"`` walks K
    along ``_K_CHOICES`` between windows from the acceptance telemetry
    (``last_tokens_per_round``).  Committed tokens are identical at every
    K, so K is a performance knob only.

    Target and draft params sharded over one mesh give a data-parallel
    engine of speculative replicas (``DecodeEngine.__new__``,
    ``parallel/data_parallel.py``), each on its position's tp ranks; its
    telemetry attributes are the first replica's.  On :class:`~norma_tpu_torch.
    parallel.collectives.TPParams` the draft must be over the target's
    group and ranks.
    """

    #: The K ladder ``spec_k="auto"`` walks.
    _K_CHOICES = (2, 4, 8, 12)
    #: EMA-smoothed acceptance ratio (tokens/round over K+1) thresholds:
    #: above _K_UP, escalate; below _K_DOWN, de-escalate.
    _K_UP = 0.75
    _K_DOWN = 0.35
    _K_EMA = 0.5

    # The window has a host gate between the speculative arm and its
    # fallback dispatch, so it does not split into dispatch and fetch; the
    # batching scheduler runs its rounds synchronously.
    supports_async_window = False

    def __init__(
        self,
        params: Params,
        cfg: WhisperConfig,
        draft_params: Params,
        draft_cfg: WhisperConfig,
        st: SpecialTokens,
        language_token_ids: Optional[Sequence[int]] = None,
        mel_center: bool = False,
        quantize_cross_kv: "bool | str" = False,
        spec_k=4,
    ):
        if isinstance(params, TPParams) or isinstance(draft_params, TPParams):
            if not (
                isinstance(params, TPParams) and isinstance(draft_params, TPParams)
                and draft_params.group is params.group and list(draft_params.ranks) == list(params.ranks)
            ):
                raise NormaError(
                    "a tp-sharded target needs its draft sharded over the same group and ranks "
                    "(shard_params of both over one mesh)"
                )
        if draft_cfg.d_model != cfg.d_model:
            raise ValueError(
                "draft d_model must match the target's (the draft reuses "
                f"the target encoder output): {draft_cfg.d_model} != {cfg.d_model}"
            )
        if draft_cfg.vocab_size != cfg.vocab_size:
            raise ValueError("draft vocab must match the target's")
        if draft_cfg.max_target_positions != cfg.max_target_positions:
            raise ValueError(
                "draft max_target_positions must match the target's (both "
                "decoders share the round's position bookkeeping)"
            )
        if quantize_cross_kv and cfg.cross_kv_impl == "kernel":
            raise ValueError(
                'cross_kv_impl="kernel" is not supported with speculative '
                "decoding: the verify pass scores multi-token chunks and "
                "the cross-decode kernel is single-query — use the einsum "
                "or chunked impl (or drop quantize_cross_kv)"
            )
        super().__init__(
            params, cfg, st,
            language_token_ids=language_token_ids,
            mel_center=mel_center,
            quantize_cross_kv=quantize_cross_kv,
        )
        if draft_params.device != self.device:
            raise ValueError(f"draft params on {draft_params.device}, target on {self.device}")
        tp = 1 if self._group is None else self._group.size
        if draft_cfg.decoder_attention_heads % tp:
            raise ValueError(f"draft decoder_attention_heads={draft_cfg.decoder_attention_heads} does not split "
                             f"over tp={tp}")
        dshards = [self._draft_kernel_params(p) for p in
                   (draft_params.shards if isinstance(draft_params, TPParams) else [draft_params])]
        self.draft_params = dshards[0]
        # The draft the layer code runs on: each rank's under tp (self._rp's
        # counterpart).
        self._drp = self.draft_params if self._group is None else RankList(dshards)
        self.draft_cfg = draft_cfg
        if spec_k == "auto":
            self.auto_k = True
            self.spec_k = 4  # starting rung of _K_CHOICES
        else:
            self.auto_k = False
            if spec_k < 1:
                raise ValueError("spec_k must be >= 1")
            self.spec_k = int(spec_k)
        self._accept_ema: Optional[float] = None
        self.last_spec_k: Optional[int] = None
        # Telemetry of the last transcribe_window (read with its one fetch):
        # draft/verify rounds, and committed tokens per round (1.0 = nothing
        # accepted .. spec_k+1 = all accepted).
        self.last_spec_rounds: Optional[int] = None
        self.last_tokens_per_round: Optional[float] = None

    def _draft_kernel_params(self, draft: Params) -> Params:
        """On CUDA the draft's heads in their kernel layout, as
        ``DecodeEngine._kernel_params`` sets the target's (the draft's
        encoder is never run); else ``draft`` itself."""
        if self.device.type != "cuda":
            return draft
        dec = head_kernel_layout(draft["decoder"])
        return draft if dec is draft["decoder"] else Params({**dict(draft.items()), "decoder": dec})

    def _adapt_spec_k(self) -> None:
        """Walk ``spec_k`` along ``_K_CHOICES`` from the acceptance ratio
        tokens_per_round / (K+1), EMA-smoothed; called after each window
        when ``spec_k="auto"``."""
        tpr = self.last_tokens_per_round
        if tpr is None:
            return
        ratio = tpr / (self.spec_k + 1)
        ema = self._accept_ema
        ema = ratio if ema is None else self._K_EMA * ema + (1 - self._K_EMA) * ratio
        self._accept_ema = ema
        idx = self._K_CHOICES.index(self.spec_k) if self.spec_k in self._K_CHOICES else None
        if idx is None:
            return
        if ema >= self._K_UP and idx + 1 < len(self._K_CHOICES):
            self.spec_k = self._K_CHOICES[idx + 1]
            self._accept_ema = None  # ratio scale changed with K
        elif ema <= self._K_DOWN and idx > 0:
            self.spec_k = self._K_CHOICES[idx - 1]
            self._accept_ema = None

    # ------------------------------------------------------------------
    # The speculative greedy loop
    # ------------------------------------------------------------------

    def _grammar(self, ll, p1, p2, lts, step):
        """Greedy grammar-masked pick for rows at per-row ``step``."""
        zero_temp = torch.zeros(ll.shape[0], dtype=torch.float32, device=ll.device)
        return sample_step(
            ll, self._m_suppress, self._m_non_ts, self._m_ts, self._m_first,
            p1, p2, lts, step, zero_temp,
            eot=self.st.eot, no_timestamps=self.st.no_timestamps, greedy_only=True,
        )

    def _spec_round(self, buf: _SpecBuffers, K: int, n0: int) -> None:
        """One draft/verify round on ``buf``'s tensors, in place.

        State at the top of a round, per row: tokens [0, n) committed; both
        caches hold positions [0, n-1); the committed token at n-1 (the
        pending one) is fed to neither decoder yet; (p1, p2, last_ts) is the
        grammar state for predicting position n, at step n - n0."""
        cfg, st = self.cfg, self.st
        B = buf.tokens.shape[0]
        mtp = cfg.max_target_positions
        dev = buf.tokens.device
        fin, n = buf.fin, buf.n
        live = ~fin
        # Per-row live rounds: rows finished before this round do not pay
        # for it (the acceptance telemetry's denominator).
        buf.rounds.add_(live.to(torch.int32))
        step0 = n - n0

        # Draft: K+1 one-token steps feed [pending, d_0 .. d_{K-1}] at
        # positions n-1 .. n+K-1 (the last step only writes its cache row);
        # step j proposes d_j from the grammar state s_j, kept for verify.
        dp1, dp2, dlts = buf.p1, buf.p2, buf.last_ts
        fed, states = [buf.p1], []
        for j in range(K + 1):
            states.append((dp1, dp2, dlts, step0 + j))
            logits, _, _ = self._fan(
                "decoder_chunk", self._drp, self.draft_cfg, fed[-1][:, None], n - 1 + j,
                buf.dk, buf.dv, buf.dxk, buf.dxv,
            )
            if j < K:
                d_j, _, _ = self._grammar(first(logits)[:, 0, :].contiguous(), dp1, dp2, dlts, step0 + j)
                dp2, dp1 = dp1, d_j
                dlts = torch.where(d_j > st.no_timestamps, d_j, dlts)
                fed.append(d_j)
        s_p1, s_p2, s_lts, s_step = (list(x) for x in zip(*states))

        # Verify: one (K+1)-wide target chunk; logits[:, j] predicts n + j
        # under grammar state s_j.
        chunk = torch.stack(fed, 1)  # [B, K+1]
        logits, _, _ = self._fan("decoder_chunk", self._rp, cfg, chunk, n - 1, buf.ck, buf.cv, buf.xk, buf.xv)
        logits = first(logits)
        rows = lambda xs: torch.stack(xs, 1).reshape(-1)  # row b*(K+1) + j
        g, prob, _ = self._grammar(
            logits.reshape(B * (K + 1), -1), rows(s_p1), rows(s_p2), rows(s_lts), rows(s_step)
        )
        g = g.reshape(B, K + 1)  # the target's choice at positions n .. n+K
        prob = prob.reshape(B, K + 1)

        # Acceptance: the longest prefix where the target agrees.
        match = g[:, :K] == chunk[:, 1:]
        a = torch.where(match.all(1), K, torch.argmin(match.to(torch.int32), 1))  # [B] in [0, K]
        # Sequential push semantics over j = 0..a (as the plain loop): stop
        # after the first EOT; at len >= mtp-1 push the token and an EOT.
        js = torch.arange(K + 1, device=dev)[None]
        in_range = js <= a[:, None]
        is_eot = g == st.eot
        first_eot = torch.where(in_range & is_eot, js, K + 1).amin(1)
        limit_j = ((n[:, None] + js + 1) >= (mtp - 1)) & ~is_eot
        first_lim = torch.where(in_range & limit_j, js, K + 1).amin(1)
        stop_j = torch.minimum(first_eot, first_lim)  # K+1 = no stop
        cc = torch.minimum(a + 1, stop_j + 1)  # committed count
        hit_lim = first_lim < torch.minimum(first_eot, a + 1)

        # Committed tokens at [n, n+cc); the extra EOT at n+cc on the limit.
        sel = buf.slots - n[:, None]
        take = (sel >= 0) & (sel < cc[:, None]) & live[:, None]
        tokens = torch.where(take, torch.gather(g, 1, sel.clamp(0, K)), buf.tokens)
        lim_slot = buf.slots == (n + cc)[:, None]
        tokens = torch.where(lim_slot & (hit_lim & live)[:, None], st.eot, tokens)
        committed = (js < cc[:, None]) & live[:, None]
        slp = buf.slp + torch.where(committed, torch.log(prob), 0.0).sum(1)
        new_fin = fin | (first_eot <= a) | hit_lim
        n_new = torch.where(fin, n, n + cc + hit_lim.to(torch.int32))

        # Grammar state after the commit: s_{cc-1} advanced by its token.
        last_j = (cc - 1).clamp(min=0)[:, None]
        at_last = lambda xs: torch.gather(torch.stack(xs, 1), 1, last_j)[:, 0]
        c_last = torch.gather(g, 1, last_j)[:, 0]
        np1 = torch.where(fin, buf.p1, c_last)
        np2 = torch.where(fin, buf.p2, at_last(s_p1))
        nlts = torch.where(live & (c_last > st.no_timestamps), c_last, at_last(s_lts))
        nlts = torch.where(fin, buf.last_ts, nlts)

        buf.tokens.copy_(tokens)
        buf.slp.copy_(slp)
        buf.n.copy_(n_new)
        buf.p1.copy_(np1)
        buf.p2.copy_(np2)
        buf.last_ts.copy_(nlts)
        buf.fin.copy_(new_fin)

    def _spec_loop(self, ins, n0: int, prev1, prev2, fin_init, k: int):
        """The greedy draft/verify loop over ``ins`` = (xk, xv, dxk, dxv,
        cache_k, cache_v, draft cache_k, draft cache_v, tokens_init), the
        caches holding positions [0, n0-1) with K+1 rows of slack.  Returns
        (tokens, n, sum_logprob, live rounds per row) on the device;
        token-for-token the plain loop's greedy decode.

        Every row has finished within ``mtp - 1 - n0`` rounds (a live row
        commits at least one token a round, and the length guard finishes it
        by then), so the loop is one :meth:`_device_while` over rounds while
        a row is unfinished and fewer rounds have run (a WHILE node in a
        captured window).  The run before a capture makes one round whatever
        the flags, so a window whose rows are all finished before the first
        round (silence, as in a warm-up window) captures the same program a
        live window replays."""
        buf = _SpecBuffers(ins)
        buf.start(ins, n0, prev1, prev2, fin_init)

        def one_round():
            self._spec_round(buf, k, n0)
            buf.pos.add_(1)

        self._device_while(buf, self.cfg.max_target_positions - 1 - n0, one_round)
        return buf.tokens, buf.n, buf.slp, buf.rounds

    def _spec_loop_eager(self, ins, n0: int, prev1, prev2, fin_init, k: int):
        """:meth:`_spec_loop` round by round, a host read before each round
        and no graphs: its results from the same rounds, for comparisons."""
        buf = _SpecBuffers(ins)
        buf.start(ins, n0, prev1, prev2, fin_init)
        for _ in range(self.cfg.max_target_positions - 1 - n0):
            self.host_syncs += 1
            if not bool((~buf.fin).any()):
                break
            self._spec_round(buf, k, n0)
        return buf.tokens, buf.n, buf.slp, buf.rounds

    # ------------------------------------------------------------------
    # The window
    # ------------------------------------------------------------------

    @torch.no_grad()
    def _spec_window(self, audio, langs, active, *, detect: bool, k: int, eager: bool = False):
        """mel -> encoder -> (detection) -> both prefills -> no-speech gate
        -> the speculative greedy loop (``eager``: round by round,
        :meth:`_spec_loop_eager`).  Returns the packed ladder layout (rung 0
        everywhere; the host applies the logprob gate and runs the t>0
        fallback on failures) with each row's live rounds as one trailing
        column, and the encoder features for that fallback."""
        cfg, st = self.cfg, self.st
        B = audio.shape[0]
        dev = audio.device
        feats, xk, xv, prefix, langs, lang_probs = self._window_front(audio, langs, detect=detect)
        dxk, dxv = self._fan("cross_kv", self._drp, self.draft_cfg, feats)
        # Both decoders prefill the prefix MINUS the pending task token (the
        # loop re-feeds it as the head of the first chunk); the no-speech
        # probe still reads the SOT position.
        logits, ck, cv = self._fan("decoder_prefill", self._rp, cfg, prefix[:, :2], xk, xv)
        _, dck, dcv = self._fan("decoder_prefill", self._drp, self.draft_cfg, prefix[:, :2], dxk, dxv)
        logits = first(logits)
        # K+1 rows of slack: finished rows keep feeding their last pending
        # token at their final position, and rows at the length limit write
        # a chunk past it.
        pad = lambda *cs: tuple(F.pad(c, (0, 0, 0, k + 1)) for c in cs)
        ck, cv, dck, dcv = per_rank(pad, ck, cv, dck, dcv)
        if self.quantize_cross_kv:  # loop-side only
            xk, xv = per_rank(quantize_xkv8, xk, xv)
        nsp = torch.softmax(logits[:, 0, :], dim=-1)[:, st.no_speech]
        tokens_init = torch.zeros((B, cfg.max_target_positions), dtype=torch.int32, device=dev)
        tokens_init[:, :3] = prefix
        gated0 = (nsp > NO_SPEECH_THRESHOLD) | ~active
        loop = self._spec_loop_eager if eager else self._spec_loop
        toks, n, slp, lrounds = loop(
            (xk, xv, dxk, dxv, ck, cv, dck, dcv, tokens_init), 3,
            prefix[:, -1].contiguous(), prefix[:, -2].contiguous(), gated0, k,
        )
        avg = slp / torch.clamp(n, min=1).to(torch.float32)
        rung0 = torch.zeros(B, dtype=torch.int32, device=dev)
        packed = self._pack_ladder(toks, n, avg, rung0, nsp, langs, lang_probs)
        return torch.cat([packed, lrounds.to(torch.float32)[:, None]], dim=1), feats

    @torch.no_grad()
    def _fallback_rungs(self, feats, langs, seed, settled, eager: bool = False):
        """The t>0 rungs over the window's encoder features for rows whose
        speculative t=0 rung failed the logprob gate: the sequential ladder
        from rung 1 (a row settling at rung r reports TEMPERATURES[r]);
        settled rows are born finished.  ``seed``: an ``int``, or the low
        word in one int64 on the device.  Returns [B, Tmax+3] f32: tokens,
        n, avg_logprob, rung."""
        cfg, st = self.cfg, self.st
        B = first(feats).shape[0]  # each rank's features under tp
        dev = first(feats).device
        xk, xv = self._fan("cross_kv", self._rp, cfg, feats)
        prefix = torch.stack(
            [
                torch.full((B,), st.sot, dtype=torch.int32, device=dev),
                langs.to(device=dev, dtype=torch.int32),
                torch.full((B,), st.task, dtype=torch.int32, device=dev),
            ],
            dim=1,
        )
        cache_k, cache_v, next_logits, _ = self._prefill_kv(prefix, xk, xv)
        if self.quantize_cross_kv:
            xk, xv = self._quantize_xkv(xk, xv)
        tokens_init = torch.zeros((B, cfg.max_target_positions), dtype=torch.int32, device=dev)
        tokens_init[:, :3] = prefix
        btoks, bn, bavg, brung = self._sequential_rungs(
            xk, xv, cache_k, cache_v, next_logits, tokens_init, prefix, seed, settled,
            start_rung=1, eager=eager,  # rung 0 already ran speculatively
        )
        col = lambda t: t.to(torch.float32)[:, None]
        return torch.cat([btoks.to(torch.float32), col(bn), col(bavg), col(brung)], dim=1)

    def _spec_packed(self, audio, langs_arr, active, detect: bool, k: int, eager: bool = False):
        """The speculative rung of a window as writable host rows
        (:meth:`_spec_window`'s packed layout) and the window's encoder
        features on the device, with one host read.  On CUDA one graph per
        (rows, samples, detection, K), captured on its first call, holds the
        window whole and keeps its features for the fallback; on the CPU,
        and ``eager``, the window runs outside a graph."""
        B = int(audio.shape[0])
        if self.device.type != "cuda" or eager:
            dev = self.device
            packed, feats = self._spec_window(
                torch.as_tensor(audio).to(dev, torch.float32), torch.tensor(np.asarray(langs_arr), device=dev),
                torch.from_numpy(active).to(dev), detect=detect, k=k, eager=eager,
            )
            return np.array(self._host(packed)), feats
        samples = int(audio.shape[-1])
        key = ("spec", B, samples, detect, k)
        prog = self._programs.get(key)
        if prog is None:
            # _pack_ladder's columns and the live rounds; one WHILE node.
            n_out = self.cfg.max_target_positions + 5 + (len(self._lang_ids) if detect else 1) + 1
            prog = self._programs[key] = _Program(
                self.device, 1, (B, n_out),
                dict(audio=((B, samples), torch.float32), langs=((B,), torch.int64), active=((B,), torch.bool)),
            )
        staging = prog.take()
        prog.load(staging, audio=audio, langs=langs_arr, active=active)
        ins = prog.ins
        run = lambda: self._spec_window(ins["audio"], ins["langs"], ins["active"], detect=detect, k=k)
        return self._fetch(self._dispatch(prog, staging, run, "spec_window_graph")), prog.keep

    def _fallback(self, feats, langs, seed: int, settled, eager: bool = False) -> np.ndarray:
        """:meth:`_fallback_rungs` as host rows [B, Tmax+3], with one host
        read: on CUDA one graph per (rows, features' signature), captured on
        its first call (``warmup_fallback``), its inputs the features, the
        languages, the seed and the settled rows; on the CPU, and
        ``eager``, outside a graph."""
        settled = np.asarray(settled, bool)
        langs = np.asarray(langs, np.int64)
        low = int(seed) & 0xFFFFFFFF
        key = self._fallback_key(feats)
        if self.device.type != "cuda" or eager:
            as_dev = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(self.device)
            kw = {"eager": True} if eager else {}
            return self._host(self._fallback_rungs(feats, as_dev(langs), low, as_dev(settled), **kw))
        B = len(settled)
        prog = self._programs.get(key)
        if prog is None:
            prog = self._programs[key] = _Program(
                self.device, (len(TEMPERATURES) - 1) * len(self._loop_crops(3)),
                (B, self.cfg.max_target_positions + 3),
                dict(langs=((B,), torch.int64), seed=((1,), torch.int64), settled=((B,), torch.bool)),
                dict(feats=feats),
            )
        staging = prog.take()
        prog.load(staging, feats=feats, langs=langs, seed=[low], settled=settled)
        ins = prog.ins
        run = lambda: self._fallback_rungs(ins["feats"], ins["langs"], ins["seed"], ins["settled"])
        return self._fetch(self._dispatch(prog, staging, run, "fallback_graph"))

    @staticmethod
    def _fallback_key(feats) -> tuple:
        """The fallback program's key: its rows, and its features' shapes,
        strides, dtypes and devices (each rank's under tp)."""
        return ("fallback", int(first(feats).shape[0]), _signature(feats))

    @torch.no_grad()
    def warmup_fallback(self, batch: int = 1) -> None:
        """Run the t>0 fallback once at ``batch`` rows.  Silence never
        reaches it (the no-speech gate), so a warm-up of zeros alone would
        leave the first gate-failing live window to pay its first-use costs
        (its graph's capture, allocator growth).  ``WhisperModel.warmup``
        calls it."""
        cfg = self.cfg
        feats = torch.zeros(
            (batch, cfg.max_source_positions, cfg.d_model),
            dtype=self.params["decoder"]["tok_emb"].dtype, device=self.device,
        )
        if self._group is not None:  # each rank's features, as a window's are
            feats = RankList(feats.clone() for _ in self._tp_ranks)
        self._fallback(feats, np.full(batch, self.st.sot + 1), 0, np.zeros(batch, bool))

    # ------------------------------------------------------------------
    # Host orchestration
    # ------------------------------------------------------------------

    @instrument(
        fields={
            "B": lambda a: int(a["audio"].shape[0]),
            "samples": lambda a: int(a["audio"].shape[1]),
            "seed": lambda a: a["seed"],
        }
    )
    @torch.no_grad()
    def transcribe_window(
        self, audio, langs, seed: int, n_active: Optional[int] = None
    ) -> Tuple[List[Optional[DecodingResult]], dict]:
        """Speculative window transcription: one device->host read of the
        packed result (the window's one program), and a second program and
        read over the window's encoder features only for streams whose
        greedy decode failed the reference's avg_logprob gate.  Same
        contract as :meth:`DecodeEngine.transcribe_window`."""
        return self._spec_transcribe(audio, langs, seed, n_active, eager=False)

    @torch.no_grad()
    def transcribe_window_eager(
        self, audio, langs, seed: int, n_active: Optional[int] = None
    ) -> Tuple[List[Optional[DecodingResult]], dict]:
        """:meth:`transcribe_window` with no graphs: the rounds one by one
        with a host read before each (:meth:`_spec_loop_eager`), the
        fallback's steps too: the same results from the same rounds and
        steps, the comparison path on the card."""
        return self._spec_transcribe(audio, langs, seed, n_active, eager=True)

    def _spec_transcribe(self, audio, langs, seed: int, n_active, eager: bool):
        langs_arr, detect, active = self._window_inputs(audio, langs, n_active)
        self.last_spec_k = k = self.spec_k  # the K this window used
        packed, feats = self._spec_packed(audio, langs_arr, active, detect, k, eager=eager)
        Tmax = self.cfg.max_target_positions
        bn = packed[:, Tmax].astype(np.int32)
        bavg = packed[:, Tmax + 1]
        nsp = packed[:, Tmax + 3]
        langs_out = packed[:, Tmax + 4].astype(np.int32)

        # Telemetry from the trailing column: each row's live rounds, and
        # the mean over live streams of per-row committed tokens / rounds
        # (per-row, so one long stream cannot dilute the others' ratio).
        lrounds = packed[:, -1].astype(np.int32)
        live = active & ~(nsp > NO_SPEECH_THRESHOLD)
        self.last_spec_rounds = int(lrounds.max()) if len(lrounds) else 0
        live_r = live & (lrounds > 0)
        self.last_tokens_per_round = (
            float(((bn[live_r] - 3) / lrounds[live_r]).mean()) if live_r.any() else None
        )
        if self.auto_k:
            self._adapt_spec_k()

        # Reference gate (model.rs:175-186): the greedy rung is accepted
        # unless avg_logprob < threshold (NaN accepted; no-speech rows exit
        # early regardless).
        need_fb = active & ~(nsp > NO_SPEECH_THRESHOLD) & (bavg < LOGPROB_THRESHOLD)
        if need_fb.any():
            fb = self._fallback(feats, langs_out, int(seed), ~need_fb, eager=eager)
            packed[need_fb, : Tmax + 3] = fb[need_fb]
        return self._unpack_ladder(
            packed, active, detect, trailing_cols=1, reject_rung0_below_gate=True
        )
