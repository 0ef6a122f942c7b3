"""Whisper decoding engine in eager PyTorch (``norma_tpu/decode/engine.py``,
without speculation or meshes).

The reference's per-window decode (``model.rs:164-389``): mel -> encoder ->
cross-K/V -> optional language detection -> prefill with the no-speech
probe -> the temperature-fallback ladder, whose token loop runs
:func:`~norma_tpu_torch.model.whisper.decoder_step` and the fused
grammar/sampling step (:func:`~norma_tpu_torch.ops.sample_step.sample_step`)
with an incremental KV cache.

Semantics preserved from the reference, in prob space (post first softmax):
  - first sampled token forced into [<|0.00|> ..= <|1.00|>]  (model.rs:336-338)
  - stateful rule engine supress_tokens()                    (model.rs:245-277)
  - monotonic timestamps via past-timestamp masking          (model.rs:225-243)
  - greedy argmax (t=0) / categorical over softmax(masked/t) (model.rs:340-357)
  - all-NaN weights => push EOT and stop                     (model.rs:343-346)
  - max_target_positions-1 guard pushes an extra EOT         (model.rs:367-370)
  - sum_logprob over ln(masked prob of chosen token)         (model.rs:364-365)
  - no-speech probe at the SOT position of the prefix        (model.rs:293-305)
  - compression_ratio never computed (NaN): the fallback is logprob-only
                                                             (model.rs:313,387)

The token loop: all per-step state (tokens, n, prev tokens, last
timestamp, sum of logprobs, finished flags, step, position, draw key)
stays on the device.  The loop advances in chunks of ``LOOP_CHUNK``
steps at one cache crop and reads "any row unfinished" on the host once
per chunk (the JAX package runs one ``lax.while_loop`` per crop).  On
CUDA each chunk is a captured CUDA graph, replayed; on the CPU the same
steps run eagerly.  Every host read is counted in
:attr:`DecodeEngine.host_syncs`.

``quantize_cross_kv`` (int8, or int4 under ``cross_kv_impl="kernel"``)
quantizes the cross-K/V the token loop reads, per window after prefill;
prefill and language detection stay unquantized.  Under
``cross_kv_impl="kernel"`` the codes are laid out for the cross-decode
kernel (``ops/paged_cross.py``) on every device.  ``quantize_self_kv``
turns the self-attention caches into int8 with per-row scales after
prefill (``model/whisper.py::quantize_self_kv_cache``); the loop then
writes int8 rows, and the self-decode kernel stays off, as in the JAX
package.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..constants import LOGPROB_THRESHOLD, NO_SPEECH_THRESHOLD, TEMPERATURES
from ..frontend.mel import log_mel_spectrogram
from ..model.config import WhisperConfig
from ..model.load import Params
from ..model.quant import prep_encoder_q8_kernel
from ..model.whisper import (
    cross_kv,
    decoder_prefill,
    decoder_step,
    encode,
    quantize_cross_kv as quantize_xkv8,
    quantize_cross_kv4,
    quantize_self_kv_cache,
)
from ..ops import flash_encoder, mel_pallas, paged_cross, quant_matmul, self_decode
from ..ops.paged_cross import prep_cross_kv_kernel, prep_cross_kv_kernel4
from ..ops.quant_matmul import head_kernel_layout
from ..ops.sample_step import sample_step
from ..tracing import decode_telemetry, instrument
from .masks import SpecialTokens, build_masks

logger = logging.getLogger(__name__)


@dataclass
class DecodingResult:
    """Mirror of the reference's DecodingResult (model.rs:493-499)."""

    tokens: List[int]
    avg_logprob: float
    no_speech_prob: float
    compression_ratio: float = float("nan")


def _crop(cache, S: int):
    """Rows [0, S) of a [L, B, T, ...] cache, or of each tensor of an int8
    cache's {"q", "s"} (views, so row writes land in the full cache)."""
    if isinstance(cache, dict):
        return {k: v[:, :, :S] for k, v in cache.items()}
    return cache[:, :, :S]


def _tile_rows(cache, R: int):
    """The cache's stream axis repeated R times (rung r of stream b at row
    r*B + b), for a tensor or an int8 cache's {"q", "s"}."""
    if isinstance(cache, dict):
        return {k: v.repeat(1, R, 1, 1) for k, v in cache.items()}
    return cache.repeat(1, R, 1, 1)


def _rung_seed(seed: int, rung: int) -> int:
    """The 64-bit draw key of ladder rung ``rung``: the low word is the
    caller's seed, the high word the rung."""
    return (int(seed) & 0xFFFFFFFF) | (int(rung) << 32)


# Steps per chunk of the token loop: one host read of the finished flags,
# and on CUDA one graph replay, per chunk (PERF.md: chosen on the H100).
LOOP_CHUNK = 16


def _kernel_counters():
    """Every kernel wrapper's launch counter (a function with ``.launches``)."""
    return (
        sample_step, self_decode.self_attention_decode,
        paged_cross.cross_attention_q8_kernel_stacked, flash_encoder.flash_self_attention,
        quant_matmul.q8a8_dense, quant_matmul.w8_matmul, quant_matmul.w4_matmul,
        mel_pallas.log_mel_pallas,
    )


def _signature(x):
    """Shapes, strides, dtypes and devices of a tensor or a tree of them."""
    if isinstance(x, dict):
        return tuple((k, _signature(v)) for k, v in sorted(x.items()))
    if isinstance(x, (tuple, list)):
        return tuple(_signature(v) for v in x)
    return (tuple(x.shape), x.stride(), x.dtype, str(x.device))


def _like(x):
    """An uninitialised tensor (or tree) with ``x``'s shape, strides and dtype."""
    if isinstance(x, dict):
        return {k: _like(v) for k, v in x.items()}
    return torch.empty_strided(x.shape, x.stride(), dtype=x.dtype, device=x.device)


def _copy_into(dst, src) -> None:
    if isinstance(dst, dict):
        for k in dst:
            dst[k].copy_(src[k])
    else:
        dst.copy_(src)


class _LoopBuffers:
    """The token loop's tensors: its inputs (cross-K/V, self-attention
    caches) and its state (logits, tokens, lengths, previous tokens, last
    timestamp, sum of logprobs, finished flags, step, position, seed), all
    on the device.

    A ``static`` one (CUDA) owns every tensor, at addresses its captured
    graphs hold: :meth:`start` copies a loop's inputs in, so the caller's
    caches are only read.  Otherwise (the CPU) the loop works on the
    caller's cross-K/V and caches, writing rows >= n0 of the caches in place
    (they are rewritten before any read, so a caller may reuse them)."""

    def __init__(self, ins, static: bool = False):
        next_logits, tokens_init = ins[4], ins[5]
        B, Tmax = tokens_init.shape
        dev = tokens_init.device
        self.static = static
        self.xk, self.xv, self.cache_k, self.cache_v = (_like(t) for t in ins[:4]) if static else ins[:4]
        self.ll = torch.empty_like(next_logits)
        self.tokens = torch.empty((B, Tmax), dtype=torch.int32, device=dev)
        i32 = lambda: torch.empty(B, dtype=torch.int32, device=dev)
        self.n, self.p1, self.p2, self.last_ts, self.step = i32(), i32(), i32(), i32(), i32()
        self.slp = torch.empty(B, dtype=torch.float32, device=dev)
        self.temp = torch.empty(B, dtype=torch.float32, device=dev)
        self.fin = torch.empty(B, dtype=torch.bool, device=dev)
        self.use_sampling = torch.empty(B, dtype=torch.bool, device=dev)
        self.pos = torch.empty(1, dtype=torch.int64, device=dev)
        self.seed = torch.empty(1, dtype=torch.int64, device=dev)  # the 64-bit key's bits
        self.slots = torch.arange(Tmax, device=dev)[None]
        self.graphs: dict = {}  # (S, k, n_rungs, greedy_only) -> CUDAGraph
        self.launches: dict = {}  # the same key -> {counter: launches per replay}

    def start(self, ins, n0: int, prev1, prev2, temp, seed: int, fin_init) -> None:
        if self.static:
            for dst, src in zip((self.xk, self.xv, self.cache_k, self.cache_v), ins[:4]):
                _copy_into(dst, src)
        else:
            self.xk, self.xv, self.cache_k, self.cache_v = ins[:4]
        self.ll.copy_(ins[4])
        self.tokens.copy_(ins[5])
        self.n.fill_(n0)
        self.p1.copy_(prev1)
        self.p2.copy_(prev2)
        self.last_ts.zero_()
        self.slp.zero_()
        self.step.zero_()
        self.temp.copy_(temp)
        self.use_sampling.copy_(temp > 0.0)
        if fin_init is None:
            self.fin.zero_()
        else:
            self.fin.copy_(fin_init)
        self.pos.fill_(n0)
        key = int(seed) & 0xFFFFFFFFFFFFFFFF
        self.seed.fill_(key - (1 << 64) if key >= 1 << 63 else key)


class DecodeEngine:
    """Encode / prefill / decode-loop bundle for one model on one device.

    All functions are batched over a leading stream dimension B; the
    single-stream API uses B=1.
    """

    # Ladder policy threshold: total decode rows (streams x rungs) up to
    # which the speculative ladder (all rungs as extra rows of one token
    # loop) is chosen over the sequential one.
    _SPECULATIVE_ROWS_MAX = 16

    def __init__(
        self,
        params: Params,
        cfg: WhisperConfig,
        st: SpecialTokens,
        language_token_ids: Optional[Sequence[int]] = None,
        mel_center: bool = False,
        quantize_cross_kv: "bool | str" = False,
        quantize_self_kv: bool = False,
    ):
        self.cfg = cfg
        self.st = st
        self.device = params.device
        if self.device.type == "cuda" and params["decoder"]["tok_emb"].dtype == torch.float32:
            # The exact f32 path: cuBLAS matmuls and cuDNN convolutions (the
            # encoder's conv stem) may otherwise run in TF32, which keeps
            # ~3 decimal digits.  These are process-wide torch settings.
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        self.params = self._kernel_params(params, cfg, self.device)
        # False = reference (whisper.cpp/candle) framing; True = OpenAI/HF
        # centered STFT.
        self.mel_center = bool(mel_center)
        # int8 cross-K/V for the token loop (the loop's largest per-step
        # stream at batch); "int4" (nibble-packed codes) runs on the kernel
        # layout only and otherwise falls back to int8 with a warning.
        if quantize_cross_kv not in (False, True, "int8", "int4"):
            raise ValueError(
                "quantize_cross_kv must be False, True/'int8' or 'int4', "
                f"got {quantize_cross_kv!r}"
            )
        if quantize_cross_kv == "int4" and cfg.cross_kv_impl != "kernel":
            logger.warning(
                "quantize_cross_kv='int4' needs cross_kv_impl='kernel'; "
                "falling back to the int8 tier"
            )
            quantize_cross_kv = True
        self.quantize_cross_kv = (
            quantize_cross_kv if quantize_cross_kv in (False, "int4") else True
        )
        # int8 self-attention caches with per-row scales: halves the other
        # per-step K/V stream; the scales fold exactly into the attention.
        self.quantize_self_kv = bool(quantize_self_kv)
        bad = [b for b in cfg.decode_buckets if not isinstance(b, int) or b <= 0]
        if bad:
            raise ValueError(f"decode_buckets must be positive ints, got {bad}")
        masks = build_masks(cfg.vocab_size, cfg.suppress_tokens, st)
        as_dev = lambda a: torch.from_numpy(a).to(self.device)
        self._m_suppress = as_dev(masks.suppress)
        self._m_non_ts = as_dev(masks.non_timestamps)
        self._m_ts = as_dev(masks.timestamps)
        self._m_first = as_dev(masks.first_token)
        self._lang_ids = (
            as_dev(np.asarray(language_token_ids, np.int64))
            if language_token_ids is not None
            else None
        )
        # Counters: device->host reads, and decode steps run.
        self.host_syncs = 0
        self.decode_steps = 0
        # The token loop: steps per chunk, and on CUDA its static buffers
        # (by input signature) with their captured graphs.
        self._loop_chunk = LOOP_CHUNK
        self._graph_buffers: dict = {}
        self._graph_pool = None
        self._side_stream = None

    @staticmethod
    def _kernel_params(params: Params, cfg: WhisperConfig, device: torch.device) -> Params:
        """The tree the engine runs on: on CUDA, its own tree where the
        kernels need another layout of the same values -- the logits
        heads' codes with 16-byte aligned rows (``head_kernel_layout``: a
        tree carried from numpy or moved with ``.to`` loses that pitch)
        and, with the w8a8 encoder, K-major copies of the encoder's codes
        (the int8 GEMM kernel's layout); else ``params`` itself.  The
        caller's params are never changed."""
        if device.type != "cuda":
            return params
        if cfg.encoder_q8_mode in ("w8a8", "w8a8_pallas") and "fc1_w_q" in params["encoder"]["layers"]:
            params = prep_encoder_q8_kernel(params)
        dec = head_kernel_layout(params["decoder"])
        if dec is not params["decoder"]:
            params = Params({**dict(params.items()), "decoder": dec})
        return params

    def _host(self, t: torch.Tensor) -> np.ndarray:
        """One counted device->host read."""
        self.host_syncs += 1
        return t.cpu().numpy()

    # ------------------------------------------------------------------
    # Device-side pieces
    # ------------------------------------------------------------------

    @torch.no_grad()
    def encode(self, mel: torch.Tensor) -> torch.Tensor:
        """mel [B, n_mels, T] -> audio features [B, T//2, D]."""
        return encode(self.params, self.cfg, torch.as_tensor(mel).to(self.device))

    def _quantize_xkv(self, xk, xv):
        """Window-time int8/int4 quantization of the loop's cross-K/V, in
        the form ``cfg.cross_kv_impl`` needs: the kernel layout under
        "kernel" (int4 is kernel-only, validated in ``__init__``), else
        the plain per-channel dicts."""
        H = self.cfg.decoder_attention_heads
        if self.quantize_cross_kv == "int4":
            return prep_cross_kv_kernel4(*quantize_cross_kv4(xk, xv), H)
        kq, vq = quantize_xkv8(xk, xv)
        if self.cfg.cross_kv_impl == "kernel":
            return prep_cross_kv_kernel(kq, vq, H)
        return kq, vq

    def _prefill_kv(self, prefix_tokens, xk, xv):
        """prefix_tokens [B, P] over cross-K/V -> (cache_k, cache_v,
        next_logits [B, V], no_speech_prob [B]).  The probe reads the
        logits at the SOT position (model.rs:300).  Under
        ``quantize_self_kv`` the caches come back int8 (the prefill pass
        itself is unquantized)."""
        logits, cache_k, cache_v = decoder_prefill(
            self.params, self.cfg, prefix_tokens, xk, xv
        )
        if self.quantize_self_kv:
            cache_k, cache_v = quantize_self_kv_cache(cache_k), quantize_self_kv_cache(cache_v)
        nsp = torch.softmax(logits[:, 0, :], dim=-1)[:, self.st.no_speech]
        return cache_k, cache_v, logits[:, -1, :].contiguous(), nsp

    def _loop_plan(self, n0: int) -> List[Tuple[int, int]]:
        """The token loop's chunks, as (crop S, steps k).

        The loop runs at most ``mtp - 1 - n0`` steps: a live row's length
        grows by at least one a step, so by then the ``mtp - 1`` guard has
        finished every row (the forward of the last step writes row
        ``mtp - 2``).  Chunks follow the ``decode_buckets`` segments, as the
        JAX package's one ``lax.while_loop`` per cache crop does: a chunk
        never crosses a bucket boundary, so its crop S is fixed, and the
        last chunk of a segment may be shorter than ``_loop_chunk``."""
        cfg = self.cfg
        mtp = cfg.max_target_positions
        buckets = sorted({int(b) for b in cfg.decode_buckets if 0 < int(b) < mtp})
        short = [b for b in buckets if b <= n0]
        if short:
            raise ValueError(
                f"decode_buckets {short} do not exceed the prefix length {n0}: "
                "cropping to them would drop prefill rows"
            )
        sizes = buckets + [mtp]
        budget = mtp - 1 - n0
        plan, s = [], 0
        while s < budget:
            pos = n0 + s
            S = next(x for x in sizes if pos < x)
            k = min(self._loop_chunk, budget - s, S - pos)
            plan.append((S, k))
            s += k
        return plan

    def _loop_buffers(self, xk, xv, cache_k, cache_v, next_logits, tokens_init):
        """The token loop's state and inputs as one :class:`_LoopBuffers`.
        On the CPU a fresh one per loop; on CUDA the engine's static one for
        these inputs' shapes, dtypes and strides (the quant tier and rows
        among them), whose addresses its captured graphs hold."""
        ins = (xk, xv, cache_k, cache_v, next_logits, tokens_init)
        if tokens_init.device.type != "cuda":
            return _LoopBuffers(ins)
        key = _signature(ins)
        buf = self._graph_buffers.get(key)
        if buf is None:
            buf = self._graph_buffers[key] = _LoopBuffers(ins, static=True)
        return buf

    def _token_loop(
        self,
        xk,
        xv,
        cache_k,
        cache_v,
        next_logits,  # [B, V] f32 — logits predicting the first sampled token
        tokens_init,  # [B, Tmax] int32 with the prefix written at [0, n0)
        n0: int,
        prev1,  # [B] int32 (task token)
        prev2,  # [B] int32 (lang or sot token)
        temp,  # [B] f32 per-row temperature
        seed: int,
        n_rungs: int = 1,
        fin_init=None,  # [B] bool — rows born finished (no-speech / settled)
        greedy_only: bool = False,
    ):
        """The autoregressive loop.  Returns (tokens [B, Tmax] int32, n [B]
        int32, sum_logprob [B] f32) on the device.

        The loop advances in chunks of up to ``_loop_chunk`` steps at one
        cache crop (:meth:`_loop_plan`) and reads the finished flags on the
        host once per chunk, before it.  On CUDA each chunk is a CUDA graph,
        captured on its first use per (buffers, crop, steps, rungs,
        ``greedy_only``) and replayed after; on the CPU the same steps run
        eagerly.  Steps after every row has finished change no state.

        On CUDA the inputs are copied into the loop's static buffers and the
        caller's caches are only read; on the CPU rows >= n0 of the caller's
        caches are written in place (rewritten before any read): either way
        callers may reuse them for another loop over the same prefix.
        ``cfg.decode_buckets`` runs each step against the
        smallest cache crop ``cache[:, :, :S]`` that holds its row (a view,
        so a bucket boundary copies nothing; rows beyond the fill are masked
        out whatever they hold, as the JAX chain's zero padding is).
        """
        ins = (xk, xv, cache_k, cache_v, next_logits, tokens_init)
        plan, buf, generator = self._loop_start(
            ins, self._loop_buffers(*ins), n0, prev1, prev2, temp, seed, fin_init, greedy_only
        )
        for S, k in plan:
            self.host_syncs += 1
            if not bool((~buf.fin).any()):
                break
            self._run_chunk(buf, S, k, n_rungs, greedy_only, generator)
            self.decode_steps += k
        return buf.tokens.clone(), buf.n.clone(), buf.slp.clone()

    def _loop_start(self, ins, buf, n0, prev1, prev2, temp, seed, fin_init, greedy_only):
        """(plan, ``buf`` started on ``ins``, the CPU's t>0 generator or None)."""
        plan = self._loop_plan(n0)
        buf.start(ins, n0, prev1, prev2, temp, seed, fin_init)
        generator = None
        if buf.fin.device.type == "cpu" and not greedy_only:
            generator = torch.Generator(device="cpu").manual_seed(int(seed))
        return plan, buf, generator

    def _run_chunk(self, buf, S: int, k: int, n_rungs: int, greedy_only: bool, generator) -> None:
        """Advance ``buf`` by ``k`` steps at crop ``S``: eagerly on the CPU;
        on CUDA by replaying the chunk's graph.  A chunk met for the first
        time runs eagerly on a side stream (the warm-up: the kernel library,
        cuBLAS and the allocator are ready before the capture), then is
        captured there.  A capture or replay error raises."""

        def chunk():
            for _ in range(k):
                self._loop_step(buf, S, n_rungs, greedy_only, generator)

        if buf.fin.device.type != "cuda":
            chunk()
            return
        key = (S, k, n_rungs, bool(greedy_only))
        graph = buf.graphs.get(key)
        if graph is not None:
            graph.replay()
            for c, d in buf.launches[key].items():
                c.launches += d
            return
        cur = torch.cuda.current_stream()
        side = self._side_stream = self._side_stream or torch.cuda.Stream(device=cur.device)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            chunk()  # the warm-up is this chunk's real run
        before = {c: c.launches for c in _kernel_counters()}
        # One memory pool for all the engine's graphs: a chunk's temporaries
        # are dead when it ends (its results are copied into ``buf``) and
        # chunks run one at a time on one stream, so they can share blocks.
        if self._graph_pool is None:
            self._graph_pool = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.stream(side):
            graph.capture_begin(pool=self._graph_pool, capture_error_mode="thread_local")
            try:
                chunk()
            finally:
                graph.capture_end()
        cur.wait_stream(side)
        # The wrappers counted launches while they were captured; they count
        # them again at each replay.
        buf.launches[key] = {c: c.launches - n for c, n in before.items() if c.launches != n}
        for c, n in before.items():
            c.launches = n
        buf.graphs[key] = graph

    def _loop_step(self, buf, S: int, n_rungs: int, greedy_only: bool, generator) -> None:
        """One step of the token loop on ``buf``'s tensors, in place: the
        fused grammar/sampling step, the row updates, the forward of the
        just-pushed token (unconditionally: the final forward's row is never
        read), then step and position advance on the device."""
        cfg, st = self.cfg, self.st
        mtp = cfg.max_target_positions
        nxt, prob_chosen, all_nan = sample_step(
            buf.ll, self._m_suppress, self._m_non_ts, self._m_ts, self._m_first,
            buf.p1, buf.p2, buf.last_ts, buf.step, buf.temp,
            eot=st.eot, no_timestamps=st.no_timestamps,
            seed=buf.seed, generator=generator, greedy_only=greedy_only,
        )
        fin, n = buf.fin, buf.n
        forced_nan_eot = buf.use_sampling & all_nan
        live = ~fin
        # Push at per-stream position n.
        tokens = torch.where((buf.slots == n[:, None]) & live[:, None], nxt[:, None], buf.tokens)
        buf.slp.add_(torch.where(fin | forced_nan_eot, 0.0, torch.log(prob_chosen)))
        hit_eot = nxt == st.eot
        # The reference pushes an extra EOT when len >= mtp - 1
        # (model.rs:367-370).
        len_limit = ((n + 1) >= (mtp - 1)) & ~hit_eot & ~forced_nan_eot
        buf.tokens.copy_(torch.where(
            (buf.slots == (n + 1)[:, None]) & (len_limit & live)[:, None], st.eot, tokens
        ))
        buf.n.copy_(torch.where(fin, n, n + 1 + len_limit.to(torch.int32)))
        buf.p2.copy_(torch.where(fin, buf.p2, buf.p1))
        buf.p1.copy_(torch.where(fin, buf.p1, nxt))
        buf.last_ts.copy_(torch.where(live & (nxt > st.no_timestamps), nxt, buf.last_ts))
        buf.fin.copy_(fin | hit_eot | forced_nan_eot | len_limit)
        ll, _, _ = decoder_step(
            self.params, cfg, nxt, buf.pos, _crop(buf.cache_k, S), _crop(buf.cache_v, S),
            buf.xk, buf.xv, n_rungs=n_rungs,
        )
        buf.ll.copy_(ll)
        buf.step.add_(1)
        buf.pos.add_(1)

    def _token_loop_eager(
        self, xk, xv, cache_k, cache_v, next_logits, tokens_init, n0: int, prev1, prev2, temp,
        seed: int, n_rungs: int = 1, fin_init=None, greedy_only: bool = False,
    ):
        """The loop step by step with a host read of the finished flags
        before each step and no graphs: :meth:`_token_loop`'s results from
        the same steps, for comparisons on the card."""
        ins = (xk, xv, cache_k, cache_v, next_logits, tokens_init)
        plan, buf, generator = self._loop_start(
            ins, _LoopBuffers(ins), n0, prev1, prev2, temp, seed, fin_init, greedy_only
        )
        for S, k in plan:
            for _ in range(k):
                self.host_syncs += 1
                if not bool((~buf.fin).any()):
                    return buf.tokens, buf.n, buf.slp
                self._loop_step(buf, S, n_rungs, greedy_only, generator)
                self.decode_steps += 1
        return buf.tokens, buf.n, buf.slp

    def _window_front(self, audio, langs, *, detect: bool):
        """mel -> encoder -> cross-K/V -> optional language detection ->
        [sot, lang, task] prefix.  Returns (feats, xk, xv, prefix, langs,
        lang_probs)."""
        cfg, st = self.cfg, self.st
        B = audio.shape[0]
        mel = log_mel_spectrogram(
            audio, n_mels=cfg.num_mel_bins, n_frames=2 * cfg.max_source_positions,
            center=self.mel_center,
        )
        feats = encode(self.params, cfg, mel)
        xk, xv = cross_kv(self.params, cfg, feats)
        dev = audio.device
        if detect:
            sot = torch.full((B, 1), st.sot, dtype=torch.int32, device=dev)
            logits1, _, _ = decoder_prefill(self.params, cfg, sot, xk, xv)
            lang_probs = torch.softmax(logits1[:, 0, self._lang_ids], dim=-1)
            detected = self._lang_ids[lang_probs.argmax(-1)]  # first of equal maxima
            langs = torch.where(langs < 0, detected.to(langs.dtype), langs)
        else:
            lang_probs = torch.zeros((B, 1), dtype=torch.float32, device=dev)
        prefix = torch.stack(
            [
                torch.full((B,), st.sot, dtype=torch.int32, device=dev),
                langs.to(torch.int32),
                torch.full((B,), st.task, dtype=torch.int32, device=dev),
            ],
            dim=1,
        )
        return feats, xk, xv, prefix, langs, lang_probs

    @torch.no_grad()
    def _ladder_impl(self, audio, langs, seed: int, active, *, detect: bool):
        """Whole-window transcription: mel -> encoder -> (detection) ->
        prefill -> no-speech gate -> the temperature-fallback ladder.

        audio: [B, S] padded PCM; langs: [B] language tokens (-1 = detect,
        only with ``detect=True``); active: [B] bool, False rows are batch
        padding (born finished, they decode nothing).  The ladder is:

          - ``B * len(TEMPERATURES) <= _SPECULATIVE_ROWS_MAX``: SPECULATIVE,
            every rung decodes at once as extra rows ``r*B + b`` of one
            token loop sharing the stream's cross-K/V, then the first rung
            passing the avg_logprob gate is selected per stream;
          - larger batches: SEQUENTIAL, rung after rung until every stream
            has settled.

        Both accept the reference's rung with the reference's gate; t>0
        rungs draw from another generator of the same law.  Returns the
        packed [B, Tmax+5+n_langs] f32 result (:meth:`_pack_ladder`).
        """
        cfg = self.cfg
        B = audio.shape[0]
        dev = audio.device
        feats, xk, xv, prefix, langs, lang_probs = self._window_front(
            audio, langs, detect=detect
        )
        cache_k, cache_v, next_logits, nsp = self._prefill_kv(prefix, xk, xv)
        if self.quantize_cross_kv:  # loop-side only; prefill/detect are unquantized
            xk, xv = self._quantize_xkv(xk, xv)

        Tmax = cfg.max_target_positions
        tokens_init = torch.zeros((B, Tmax), dtype=torch.int32, device=dev)
        tokens_init[:, :3] = prefix
        R = len(TEMPERATURES)
        # No-speech-gated streams and pad rows decode nothing
        # (reference early exit model.rs:308-315).
        gated0 = (nsp > NO_SPEECH_THRESHOLD) | ~active

        if B * R <= self._SPECULATIVE_ROWS_MAX:
            temps_row = torch.tensor(TEMPERATURES, dtype=torch.float32, device=dev)
            temps_row = temps_row.repeat_interleave(B)
            toks, n, slp = self._token_loop(
                xk, xv,
                _tile_rows(cache_k, R), _tile_rows(cache_v, R),
                next_logits.repeat(R, 1), tokens_init.repeat(R, 1), 3,
                prefix[:, -1].repeat(R), prefix[:, -2].repeat(R),
                temps_row, _rung_seed(seed, 0),
                n_rungs=R, fin_init=gated0.repeat(R),
            )
            avg = slp / torch.clamp(n, min=1).to(torch.float32)
            # A NaN avg (grammar deadlock) compares False => accepted, as
            # the reference's f64 comparison does.
            acc = (~(avg < LOGPROB_THRESHOLD)).reshape(R, B)
            any_acc = acc.any(0)
            first_r = acc.to(torch.int32).argmax(0)  # first accepting rung
            sel = first_r * B + torch.arange(B, device=dev)
            brung = torch.where(any_acc, first_r, -1)
            btoks = torch.where(any_acc[:, None], toks[sel], tokens_init)
            bn = torch.where(any_acc, n[sel], 3)
            bavg = torch.where(any_acc, avg[sel], 0.0)
            return self._pack_ladder(btoks, bn, bavg, brung, nsp, langs, lang_probs)

        btoks, bn, bavg, brung = self._sequential_rungs(
            xk, xv, cache_k, cache_v, next_logits, tokens_init, prefix, seed, gated0,
        )
        return self._pack_ladder(btoks, bn, bavg, brung, nsp, langs, lang_probs)

    def _sequential_rungs(
        self, xk, xv, cache_k, cache_v, next_logits, tokens_init, prefix, seed, settled0
    ):
        """Sequential temperature ladder: try rungs in order, stopping once
        every stream has settled.  Rung r draws with key
        ``_rung_seed(seed, r)``; settled rows are born finished.  Returns
        (btoks, bn, bavg, brung); rows never accepted carry brung = -1."""
        B = tokens_init.shape[0]
        dev = tokens_init.device
        settled = settled0.clone()
        btoks = tokens_init.clone()
        bn = torch.full((B,), 3, dtype=torch.int32, device=dev)
        bavg = torch.zeros(B, dtype=torch.float32, device=dev)
        brung = torch.full((B,), -1, dtype=torch.int64, device=dev)
        for r in range(len(TEMPERATURES)):
            self.host_syncs += 1
            if not bool((~settled).any()):
                break
            t = TEMPERATURES[r]
            toks, n, slp = self._token_loop(
                xk, xv, cache_k, cache_v, next_logits, tokens_init, 3,
                prefix[:, -1], prefix[:, -2],
                torch.full((B,), t, dtype=torch.float32, device=dev),
                _rung_seed(seed, r), fin_init=settled, greedy_only=t == 0.0,
            )
            avg = slp / torch.clamp(n, min=1).to(torch.float32)
            accept = ~(avg < LOGPROB_THRESHOLD)  # NaN avg accepted, as above
            take = ~settled & accept
            btoks = torch.where(take[:, None], toks, btoks)
            bn = torch.where(take, n, bn)
            bavg = torch.where(take, avg, bavg)
            brung = torch.where(take, r, brung)
            settled = settled | accept
        return btoks, bn, bavg, brung

    @staticmethod
    def _pack_ladder(btoks, bn, bavg, brung, nsp, langs, lang_probs):
        """Pack every ladder output into ONE f32 tensor [B, Tmax+5+L], so a
        window costs one device->host copy.  Token ids (< 2^24) and the
        small ints are exact in f32."""
        col = lambda t: t.to(torch.float32)[:, None]
        return torch.cat(
            [
                btoks.to(torch.float32), col(bn), col(bavg), col(brung), col(nsp),
                col(langs), lang_probs.to(torch.float32),
            ],
            dim=1,
        )

    # ------------------------------------------------------------------
    # Host-side orchestration
    # ------------------------------------------------------------------

    def _window_inputs(self, audio, langs, n_active):
        """Broadcast per-stream language tokens, derive the detect flag and
        mark batch-padding rows inactive."""
        langs_arr = np.broadcast_to(
            np.asarray(langs, np.int32).reshape(-1), (audio.shape[0],)
        )
        detect = bool((langs_arr < 0).any())
        if detect and self._lang_ids is None:
            raise ValueError("language detection requires language_token_ids")
        active = np.ones(audio.shape[0], bool)
        if n_active is not None:
            active[n_active:] = False
        return langs_arr, detect, active

    @instrument(
        fields={
            "B": lambda a: int(a["audio"].shape[0]),
            "samples": lambda a: int(a["audio"].shape[1]),
            "seed": lambda a: a["seed"],
        }
    )
    def transcribe_window(
        self, audio, langs, seed: int, n_active: Optional[int] = None
    ) -> Tuple[List[Optional[DecodingResult]], dict]:
        """Whole-window transcription.

        audio: [B, S] padded PCM (numpy or tensor); langs: per-stream
        language token ids, -1 requesting detection; seed: the ladder's
        draw key; n_active: rows [n_active, B) are batch padding.

        Returns (results, info): results[b] is the accepted DecodingResult
        — the prefix-only result when the no-speech probe fired, None when
        every temperature failed the logprob gate or the row is padding.
        info carries ``langs`` and, when detection ran, ``lang_probs``.
        """
        return self.transcribe_window_fetch(
            self.transcribe_window_async(audio, langs, seed, n_active)
        )

    # The window splits into dispatch and fetch (the batching scheduler
    # pipelines rounds on it).  The token loop reads its stop condition on
    # the host once per chunk, so the window's device work is finished or
    # nearly so when the dispatch returns: the split overlaps only the last
    # chunk, the final copy and the host unpack.
    supports_async_window = True

    def transcribe_window_async(self, audio, langs, seed: int, n_active: Optional[int] = None):
        """Run the window up to its packed device result, without the final
        device->host copy; :meth:`transcribe_window_fetch` completes it."""
        langs_arr, detect, active = self._window_inputs(audio, langs, n_active)
        if isinstance(audio, torch.Tensor):
            audio_t = audio.to(self.device, torch.float32)
        else:
            audio_t = torch.from_numpy(np.asarray(audio, np.float32)).to(self.device)
        packed = self._ladder_impl(
            audio_t,
            torch.from_numpy(np.array(langs_arr, np.int64)).to(self.device),
            int(seed),
            torch.from_numpy(active).to(self.device),
            detect=detect,
        )
        return packed, active, detect

    def transcribe_window_fetch(self, pending) -> Tuple[List[Optional[DecodingResult]], dict]:
        """Copy a :meth:`transcribe_window_async` result to the host and
        unpack it."""
        packed, active, detect = pending
        return self._unpack_ladder(self._host(packed), active, detect)

    def _unpack_ladder(
        self, packed: np.ndarray, active: np.ndarray, detect: bool
    ) -> Tuple[List[Optional[DecodingResult]], dict]:
        """Host-side unpack of :meth:`_pack_ladder`'s layout."""
        Tmax = self.cfg.max_target_positions
        btoks = packed[:, :Tmax].astype(np.int32)
        bn = packed[:, Tmax].astype(np.int32)
        bavg = packed[:, Tmax + 1]
        brung = packed[:, Tmax + 2].astype(np.int32)
        nsp = packed[:, Tmax + 3]
        langs_out = packed[:, Tmax + 4].astype(np.int32)
        lang_probs = packed[:, Tmax + 5 :]
        st = self.st
        out: List[Optional[DecodingResult]] = []
        for b in range(btoks.shape[0]):
            if not active[b]:
                out.append(None)  # batch padding: no result, no telemetry
                continue
            if nsp[b] > NO_SPEECH_THRESHOLD:
                out.append(
                    DecodingResult(
                        tokens=btoks[b, :3].tolist(),
                        avg_logprob=0.0,
                        no_speech_prob=float(nsp[b]),
                    )
                )
                continue
            if brung[b] < 0:
                out.append(None)  # failed at all temperatures
                continue
            toks = btoks[b, : bn[b]].tolist()
            # Trailing timestamp cleanup (reference: model.rs:375-381).
            while len(toks) >= 2 and toks[-2] > st.no_timestamps:
                del toks[-2]
            decode_telemetry(float(TEMPERATURES[brung[b]]), float(bavg[b]), float(nsp[b]))
            out.append(
                DecodingResult(
                    tokens=toks, avg_logprob=float(bavg[b]), no_speech_prob=float(nsp[b])
                )
            )
        info = {"langs": langs_out, "lang_probs": lang_probs if detect else None}
        return out, info

    def _prefix_array(self, B: int, lang_token) -> np.ndarray:
        """lang_token: None (no language slot), an int, or a per-stream
        sequence of ints."""
        if lang_token is None:
            return np.tile(np.asarray([self.st.sot, self.st.task], np.int32)[None], (B, 1))
        langs = np.broadcast_to(np.asarray(lang_token, np.int32).reshape(-1), (B,))
        return np.stack(
            [np.full(B, self.st.sot, np.int32), langs, np.full(B, self.st.task, np.int32)],
            axis=1,
        )

    @torch.no_grad()
    def prefill(self, feats: torch.Tensor, lang_token):
        feats = torch.as_tensor(feats).to(self.device)
        B = feats.shape[0]
        prefix_arr = self._prefix_array(B, lang_token)
        xk, xv = cross_kv(self.params, self.cfg, feats)
        ck, cv, nl, nsp = self._prefill_kv(torch.from_numpy(prefix_arr).to(self.device), xk, xv)
        if self.quantize_cross_kv:  # loop-side only
            xk, xv = self._quantize_xkv(xk, xv)
        return dict(
            prefix=prefix_arr, B=B, xk=xk, xv=xv, cache_k=ck, cache_v=cv,
            next_logits=nl, no_speech_prob=self._host(nsp),
        )

    @torch.no_grad()
    def run_loop(self, state, temperature: float, seed: int) -> List[DecodingResult]:
        """One token loop at one temperature over a :meth:`prefill` state
        (which it may reuse: see :meth:`_token_loop`)."""
        st = self.st
        prefix = np.asarray(state["prefix"])
        B, P = prefix.shape
        Tmax = self.cfg.max_target_positions
        tokens_init = np.zeros((B, Tmax), np.int32)
        tokens_init[:, :P] = prefix
        as_dev = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(self.device)
        tokens, n, slp = self._token_loop(
            state["xk"], state["xv"], state["cache_k"], state["cache_v"],
            state["next_logits"], as_dev(tokens_init), P,
            as_dev(prefix[:, -1]), as_dev(prefix[:, -2]),
            torch.full((B,), float(temperature), dtype=torch.float32, device=self.device),
            int(seed), greedy_only=temperature == 0.0,
        )
        packed = self._host(
            torch.cat([tokens.to(torch.float32), n.to(torch.float32)[:, None], slp[:, None]], 1)
        )
        tokens = packed[:, :Tmax].astype(np.int32)
        n = packed[:, Tmax].astype(np.int32)
        slp = packed[:, Tmax + 1]
        out = []
        for b in range(B):
            toks = tokens[b, : n[b]].tolist()
            avg_logprob = float(slp[b]) / max(len(toks), 1)
            while len(toks) >= 2 and toks[-2] > st.no_timestamps:
                del toks[-2]
            out.append(
                DecodingResult(
                    tokens=toks,
                    avg_logprob=avg_logprob,
                    no_speech_prob=float(state["no_speech_prob"][b]),
                )
            )
        return out

    @instrument  # reference #[instrument], model.rs:163
    def decode_with_fallback(
        self, feats, lang_token: Optional[int], seed: int
    ) -> Optional[DecodingResult]:
        """Temperature-fallback ladder (reference: model.rs:164-191), B=1.

        Fallback triggers on avg_logprob alone (the reference never
        computes compression_ratio).  When the no-speech probe fires the
        prefix-only result is returned; the long-form layer discards it.
        """
        state = self.prefill(feats, lang_token)
        nsp = float(state["no_speech_prob"][0])
        if nsp > NO_SPEECH_THRESHOLD:
            return DecodingResult(
                tokens=np.asarray(state["prefix"])[0].tolist(),
                avg_logprob=0.0,
                no_speech_prob=nsp,
            )
        for i, t in enumerate(TEMPERATURES):
            dr = self.run_loop(state, t, seed + i)[0]
            needs_fallback = dr.compression_ratio > 2.4 or dr.avg_logprob < LOGPROB_THRESHOLD
            if not needs_fallback or dr.no_speech_prob > NO_SPEECH_THRESHOLD:
                decode_telemetry(t, dr.avg_logprob, dr.no_speech_prob)
                return dr
        logger.debug("failed to decode at all temperatures, returning None")
        return None
