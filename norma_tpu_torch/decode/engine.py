"""Whisper decoding engine in PyTorch (``norma_tpu/decode/engine.py``;
speculation is ``decode/speculative.py``, data parallelism over a mesh
``parallel/data_parallel.py``).

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
stays on the device, and its stop tests run there: each cache crop's loop
is one :meth:`DecodeEngine._device_while` of one-step passes, as the JAX
package runs one ``lax.while_loop`` per crop, and a sequential rung whose
rows have all settled runs its loops zero times.

Every entry point that runs a loop is one device program with one host
read, as the JAX package's jitted programs are: a window
(:meth:`DecodeEngine.transcribe_window_async`), :meth:`DecodeEngine.
run_loop`, and the speculative engine's window and its t>0 fallback
(``decode/speculative.py``).  On CUDA each is one CUDA graph
(:class:`_Program`) per shape, captured on the shape's first call and
replayed after: a window's holds mel, encoder, cross-K/V, detection,
prefill, the no-speech gate, the ladder and its packing; ``run_loop``'s
the loop over copies of its prefill state.  Each ``_device_while`` in it
is a WHILE node whose body is one step (or one speculative round) followed
by the condition's kernel (``ops/loop_cond.py``).  The seed and the
temperatures are inputs of the graph.  The program's one host read is its
fetch of the packed result.  On the CPU the same structure runs eagerly,
the conditions read on the host.  This holds for every engine: without
tp, with tp ranks that share its process (a ``LocalGroup``) and for one
rank of worker processes over NCCL (a ``ProcessGroup``), whose collectives
the graph holds inside its WHILE bodies too, as GSPMD puts the psums
inside the JAX package's loops.  The ranks sample from the same gathered
logits, so their flags, hence their stop tests and passes, agree.
:meth:`DecodeEngine.transcribe_window_eager` and :meth:`DecodeEngine.
run_loop_eager` run the same steps with a host read of the finished flags
before each step and no graphs: the comparison paths on the card.
Every device->host read is counted in :attr:`DecodeEngine.host_syncs`.

Tensor parallelism: an engine built on
:class:`~norma_tpu_torch.parallel.collectives.TPParams` (the tp shards of
the ranks it runs in this process, and their group; ``parallel/
data_parallel.py`` builds it from a mesh) runs every model call on each
rank's shard, the ranks in lockstep through the group's collectives
(``model/whisper.py``'s layer generators).  Its per-rank values -- kernel
params, cross-K/V, self-attention caches -- are
:class:`~norma_tpu_torch.parallel.collectives.RankList`; what the ranks
share (logits, which every rank gets whole, tokens, the loop's state) is
held once, so the sampler and the ladder run once per process and every
rank's step reads the same token.  A program's graph holds every local
rank's work and its collectives.

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

import gc
import logging
import threading
import time
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..constants import LOGPROB_THRESHOLD, NO_SPEECH_THRESHOLD, TEMPERATURES
from ..errors import NormaError
from ..frontend.mel import log_mel_spectrogram
from ..model.config import WhisperConfig
from ..model.load import Params
from ..model.quant import prep_encoder_q8_kernel
from ..model.whisper import (
    _decoder_chunk,
    _decoder_prefill,
    _decoder_step,
    _encode,
    _quantize_self_kv_cache,
    cross_kv,
    decoder_chunk,
    decoder_prefill,
    decoder_step,
    encode,
    quantize_cross_kv as quantize_xkv8,
    quantize_cross_kv4,
    quantize_self_kv_cache,
)
from ..ops import _build
from ..ops.loop_cond import capture_nodes, census_text, loop_cond, while_node
from ..ops.paged_cross import prep_cross_kv_kernel, prep_cross_kv_kernel4
from ..ops.quant_matmul import head_kernel_layout
from ..ops.sample_step import sample_step
from ..parallel.collectives import Rank, RankList, TPParams, first, lockstep, per_rank, unzip
from ..parallel.sharding import ShardedParams
from .. import tracing
from ..tracing import Marks, clock_anchor, decode_telemetry, instrument, marking, prime_device_tracer, record, region
from ..tracing import regions as mark_regions
from ..tracing import span
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
    cache's {"q", "s"} (views, so row writes land in the full cache); each
    rank's of a :class:`RankList`."""
    if isinstance(cache, RankList):
        return RankList(_crop(c, S) for c in cache)
    if isinstance(cache, dict):
        return {k: v[:, :, :S] for k, v in cache.items()}
    return cache[:, :, :S]


def _tile_rows(cache, R: int):
    """The cache's stream axis repeated R times (rung r of stream b at row
    r*B + b), for a tensor or an int8 cache's {"q", "s"} (each rank's of a
    :class:`RankList`)."""
    if isinstance(cache, RankList):
        return RankList(_tile_rows(c, R) for c in cache)
    if isinstance(cache, dict):
        return {k: v.repeat(1, R, 1, 1) for k, v in cache.items()}
    return cache.repeat(1, R, 1, 1)


def _rung_seed(seed, rung: int):
    """The 64-bit draw key of ladder rung ``rung``: the low word is the
    caller's seed, the high word the rung.  An ``int`` for an ``int``
    seed; for a seed held in one int64 tensor (a window graph's input),
    the key computed on its device."""
    if isinstance(seed, torch.Tensor):
        return (seed & 0xFFFFFFFF) | (int(rung) << 32)
    return (int(seed) & 0xFFFFFFFF) | (int(rung) << 32)


# Time marks a window writes: the start and end of its regions -- the
# whole window, its front, each token loop (one a rung of the sequential
# ladder) and its finish.
_WINDOW_MARKS = 2 * (3 + len(TEMPERATURES))

# One CUDA graph capture at a time in the process: instantiating a graph
# that holds conditional (WHILE) nodes waits on the device, so two threads
# capturing at once on one card -- data-parallel replicas warming up --
# each waited for the other's capturing stream (both stuck in
# capture_end on the H100).
_CAPTURE_LOCK = threading.Lock()


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
    if isinstance(x, RankList):
        return RankList(_like(v) for v in x)
    return torch.empty_strided(x.shape, x.stride(), dtype=x.dtype, device=x.device)


def _copy_into(dst, src) -> None:
    if isinstance(dst, dict):
        for k in dst:
            dst[k].copy_(src[k])
    elif isinstance(dst, RankList):
        for d, v in zip(dst, src):
            _copy_into(d, v)
    else:
        dst.copy_(src)


class _LoopBuffers:
    """The token loop's tensors: its inputs (cross-K/V, self-attention
    caches, the caller's own: rows >= n0 of the caches are written in place,
    and rewritten before any read, so a caller may reuse them) and its state
    (logits, tokens, lengths, previous tokens, last timestamp, sum of
    logprobs, finished flags, step, position, seed), all on the device."""

    def __init__(self, ins):
        next_logits, tokens_init = ins[4], ins[5]
        B, Tmax = tokens_init.shape
        dev = tokens_init.device
        self.xk, self.xv, self.cache_k, self.cache_v = ins[:4]
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

    def start(self, ins, n0: int, prev1, prev2, temp, seed, fin_init) -> None:
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
        if isinstance(seed, torch.Tensor):  # the key's bits, on the device
            self.seed.copy_(seed.reshape(1))
            return
        self.seed.fill_(_signed_key(seed))


def _signed_key(seed: int) -> int:
    """A 64-bit draw key's bits as the int64 that holds them."""
    key = int(seed) & 0xFFFFFFFFFFFFFFFF
    return key - (1 << 64) if key >= 1 << 63 else key


class _Program:
    """One captured device program (module docstring): a window's, a
    ``run_loop``'s, a speculative window's or its fallback's CUDA graph.

    ``ins``: its static inputs on the device by name -- those named in
    ``host`` (``{name: (shape, dtype)}``) zeroed, and one like each tensor
    (or tree, :func:`_like`) of ``device``; the graph, its packed f32
    result ``out`` (``out_shape``) and what else it returns that a later
    program reads (``keep``); its WHILE nodes' pass counters ``iters``
    (zeroed by each replay); the launches each replay counts at once and,
    per WHILE node, the launches of one pass and whether a pass is a decode
    step (``loops``), which the fetch scales by the passes the device
    counted; and pinned host staging for the host inputs, the result and
    the passes, ``staging`` sets of it taken in turn by the replays in
    flight (one more is made when every set is in flight).  ``stats``: the
    graph's nodes (its own and its WHILE bodies'), and the seconds its
    capture took to record and to instantiate; ``passes``: the WHILE
    passes of the last fetch.  A window's program has ``marks`` more slots
    in ``iters``, after the ``n_nodes`` counters, for its regions' device
    time marks (``tracing.region``; ``mark_names`` in the order the
    capture wrote them), which the copy of ``iters`` brings to the host."""

    def __init__(self, dev: torch.device, n_nodes: int, out_shape, host: dict, device: Optional[dict] = None,
                 staging: int = 1, marks: int = 0):
        self.host = dict(host)
        self.ins = {k: torch.zeros(shape, dtype=dtype, device=dev) for k, (shape, dtype) in self.host.items()}
        self.ins.update({k: _like(v) for k, v in (device or {}).items()})
        self.n_nodes, self.n_marks = n_nodes, marks
        self.iters = torch.zeros(n_nodes + marks, dtype=torch.int64, device=dev)
        self.mark_names: list = []
        self._shapes = {**self.host, "out": (tuple(out_shape), torch.float32),
                        "iters": ((n_nodes + marks,), torch.int64)}
        self.graph = None
        self.out = self.keep = None
        self.passes: Optional[List[int]] = None  # per WHILE node, the last fetch's
        self.launches: dict = {}
        self.loops: list = []  # per WHILE node: ({counter: launches per pass}, a pass is a decode step)
        self.stats: dict = {}
        self._free = [self._staging() for _ in range(staging)]

    def _staging(self) -> dict:
        return {k: torch.empty(shape, dtype=dtype, pin_memory=True) for k, (shape, dtype) in self._shapes.items()}

    def take(self) -> dict:
        """A free staging set (a new one when every set is in flight)."""
        return self._free.pop() if self._free else self._staging()

    def give(self, staging: dict) -> None:
        self._free.append(staging)

    def load(self, staging: dict, **values) -> None:
        """Copy each input's value into ``ins``, on the current stream: a
        host input from the host through its pinned staging, unless it is
        a CUDA tensor already; a device input on the device."""
        for name, value in values.items():
            dst = self.ins[name]
            if name in self.host and not (isinstance(value, torch.Tensor) and value.device.type == "cuda"):
                staging[name].numpy()[...] = np.asarray(value)
                dst.copy_(staging[name], non_blocking=True)
            else:
                _copy_into(dst, value)


@dataclass
class _Pending:
    """A program's replay in flight: its staging set, whose packed result
    and pass counts are on their way to it, the event after those copies,
    what its fetch needs besides (a window's active rows and detect flag),
    and a window's record, which the fetch completes and stores."""

    prog: _Program
    staging: dict
    done: "torch.cuda.Event"
    meta: tuple = ()
    record: Optional[dict] = None


class _HostPending(tuple):
    """A window run outside a graph (the CPU, the eager path) up to its
    packed result: ``(packed, active, detect)``, with its record and its
    marks (their names, and their host stamps or a pinned copy of the
    card's)."""

    record = None
    marks = None


# The layer generators (model/whisper.py) of the model functions a tp
# engine runs on its ranks.
_RANK_FNS = {
    "encode": _encode, "decoder_prefill": _decoder_prefill, "decoder_step": _decoder_step,
    "decoder_chunk": _decoder_chunk, "quantize_self_kv_cache": _quantize_self_kv_cache,
}


class DecodeEngine:
    """Encode / prefill / decode-loop bundle for one model on one device.

    All functions are batched over a leading stream dimension B; the
    single-stream API uses B=1.

    Params sharded over a mesh (``parallel.shard_params``) give a
    :class:`~norma_tpu_torch.parallel.data_parallel.DataParallelEngine`
    instead: one engine of this class per dp position, each on its
    position's params, device, thread and stream.  The mesh is the
    params'; a ``mesh`` argument must name the same one.  An engine on
    :class:`~norma_tpu_torch.parallel.collectives.TPParams` runs tp ranks
    (module docstring).
    """

    def __new__(cls, params=None, *args, mesh=None, **kwargs):
        if mesh is not None or isinstance(params, ShardedParams):
            from ..parallel.data_parallel import DataParallelEngine

            return DataParallelEngine(cls, params, *args, mesh=mesh, **kwargs)
        return super().__new__(cls)

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
        mesh=None,  # read by __new__: a single-device engine has none
    ):
        self.cfg = cfg
        self.st = st
        self.device = params.device
        shards = params.shards if isinstance(params, TPParams) else [params]
        self._group = params.group if isinstance(params, TPParams) else None
        tp = 1 if self._group is None else self._group.size
        for n in ("d_model", "encoder_attention_heads", "decoder_attention_heads"):
            if getattr(cfg, n) % tp:
                raise ValueError(f"{n}={getattr(cfg, n)} does not split over tp={tp}")
        self._heads = cfg.decoder_attention_heads // tp  # the heads each rank runs
        if self.device.type == "cuda" and shards[0]["decoder"]["tok_emb"].dtype == torch.float32:
            # The exact f32 path: cuBLAS matmuls and cuDNN convolutions (the
            # encoder's conv stem) may otherwise run in TF32, which keeps
            # ~3 decimal digits.  These are process-wide torch settings.
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        kparams = [self._kernel_params(p, cfg, self.device) for p in shards]
        self.params = kparams[0]
        # The params the layer code runs on: each rank's under tp.
        self._rp = self.params if self._group is None else RankList(kparams)
        self._tp_ranks = None if self._group is None else [Rank(r, tp) for r in params.ranks]
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
        # Counters: device->host reads, decode steps run, and CUDA graphs
        # captured.
        self.host_syncs = 0
        self.decode_steps = 0
        self.graph_captures = 0
        # Device programs (module docstring): on CUDA their graphs by key,
        # the first item of which names the entry point; the memory pool
        # and side stream of their captures; the program being captured,
        # whose loops become WHILE nodes; the stream their bodies are
        # captured on.
        self._programs: dict = {}
        self._graph_pool = None
        self._side_stream = None
        self._capturing: Optional[_Program] = None
        self._warming = False  # a program's run before its capture
        self._body_stream = None
        # A rank in worker processes tells its group of every graph it
        # replays (``ProcessGroup.graph_launched``: no NCCL launch outside
        # a graph may start while one is in flight), and its fetches wait at
        # most ``fetch_timeout_s`` (``parallel/workers.py``).
        self._graph_launched = getattr(self._group, "graph_launched", None)
        self.fetch_timeout_s: Optional[float] = None
        # Window records (tracing.py): the card's clock anchor, taken at
        # the first window; the eager window's mark slots and their pinned
        # copy; the passes of each loop of a window run outside a graph.
        self._clock: Optional[dict] = None
        self._eager_marks = None
        self._loop_passes: Optional[list] = None

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

    def _fan(self, name: str, *args):
        """The model function ``name`` of this module over the engine's
        ranks: without tp the function itself, once; under tp its layer
        generator (:data:`_RANK_FNS`) on each local rank's
        :class:`RankList` values (the rest shared), the ranks in lockstep
        through the group (``cross_kv``, which meets no other rank, per
        rank), the results as RankLists (a tuple of them for tuple
        results)."""
        fn = globals()[name]
        if self._group is None:
            return fn(*args)
        gen = _RANK_FNS.get(name)
        if gen is None:
            return per_rank(fn, *args)
        pick = lambda a, i: a[i] if isinstance(a, RankList) else a
        gens = [gen(*(pick(a, i) for a in args), tp=r) for i, r in enumerate(self._tp_ranks)]
        return unzip(RankList(lockstep(self._group, gens)))

    # ------------------------------------------------------------------
    # Device-side pieces
    # ------------------------------------------------------------------

    @torch.no_grad()
    def encode(self, mel: torch.Tensor) -> torch.Tensor:
        """mel [B, n_mels, T] -> audio features [B, T//2, D]."""
        return first(self._fan("encode", self._rp, self.cfg, torch.as_tensor(mel).to(self.device)))

    def _quantize_xkv(self, xk, xv):
        """Window-time int8/int4 quantization of the loop's cross-K/V, in
        the form ``cfg.cross_kv_impl`` needs: the kernel layout under
        "kernel" (int4 is kernel-only, validated in ``__init__``), else
        the plain per-channel dicts (each rank's under tp)."""
        if isinstance(xk, RankList):
            return per_rank(self._quantize_xkv, xk, xv)
        H = self._heads
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
        logits, cache_k, cache_v = self._fan("decoder_prefill", self._rp, self.cfg, prefix_tokens, xk, xv)
        logits = first(logits)
        if self.quantize_self_kv:
            cache_k = self._fan("quantize_self_kv_cache", cache_k)
            cache_v = self._fan("quantize_self_kv_cache", cache_v)
        nsp = torch.softmax(logits[:, 0, :], dim=-1)[:, self.st.no_speech]
        return cache_k, cache_v, logits[:, -1, :].contiguous(), nsp

    def _loop_crops(self, n0: int) -> List[Tuple[int, int]]:
        """The token loop's cache crops, ``(S, pos_end)``: the loop runs each
        step against the smallest crop ``S`` of ``cfg.decode_buckets`` (and
        ``mtp``) that holds its row, as the JAX package's one
        ``lax.while_loop`` per cache crop does, and a crop's loop runs one
        step a pass while a row is unfinished and the position is below
        ``pos_end`` (one :meth:`_device_while`).

        The loop runs at most ``mtp - 1 - n0`` steps: a live row's length
        grows by at least one a step, so by then the ``mtp - 1`` guard has
        finished every row (the forward of the last step writes row
        ``mtp - 2``); the last crop ends there."""
        cfg = self.cfg
        mtp = cfg.max_target_positions
        buckets = sorted({int(b) for b in cfg.decode_buckets if 0 < int(b) < mtp})
        short = [b for b in buckets if b <= n0]
        if short:
            raise ValueError(
                f"decode_buckets {short} do not exceed the prefix length {n0}: "
                "cropping to them would drop prefill rows"
            )
        crops, pos = [], n0
        for S in buckets + [mtp]:
            if pos >= mtp - 1:
                break
            pos = min(S, mtp - 1)
            crops.append((S, pos))
        return crops

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
        seed,  # int, or the key's bits in one int64 on the device
        n_rungs: int = 1,
        fin_init=None,  # [B] bool — rows born finished (no-speech / settled)
        greedy_only: bool = False,
    ):
        """The autoregressive loop.  Returns (tokens [B, Tmax] int32, n [B]
        int32, sum_logprob [B] f32) on the device.

        Each cache crop's steps (:meth:`_loop_crops`) are one
        :meth:`_device_while` of one-step passes: a WHILE node while a
        program is captured, else a host read of the stop test before each
        pass on CUDA (none is counted on the CPU).  Steps after every row
        has finished change no state.  The loop works on its inputs in
        place: rows >= n0 of the caches are written (rewritten before any
        read), so callers may reuse them for another loop over the same
        prefix.  ``cfg.decode_buckets`` runs each step against the smallest
        cache crop ``cache[:, :, :S]`` that holds its row (a view, so a
        bucket boundary copies nothing; rows beyond the fill are masked out
        whatever they hold, as the JAX chain's zero padding is).
        """
        ins = (xk, xv, cache_k, cache_v, next_logits, tokens_init)
        buf, generator = self._loop_start(ins, n0, prev1, prev2, temp, seed, fin_init, greedy_only)
        with region("token_loop"):
            for S, pos_end in self._loop_crops(n0):
                self._device_while(buf, pos_end, lambda S=S: self._loop_step(buf, S, n_rungs, greedy_only, generator))
        return buf.tokens, buf.n, buf.slp

    def _loop_start(self, ins, n0, prev1, prev2, temp, seed, fin_init, greedy_only):
        """(a :class:`_LoopBuffers` started on ``ins``, the CPU's t>0
        generator or None)."""
        buf = _LoopBuffers(ins)
        buf.start(ins, n0, prev1, prev2, temp, seed, fin_init)
        generator = None
        if buf.fin.device.type == "cpu" and not greedy_only:
            generator = torch.Generator(device="cpu").manual_seed(int(seed))
        return buf, generator

    def _device_while(self, buf, pos_end: int, body) -> None:
        """``while loop_cond(buf.fin, buf.pos, pos_end): body()``, ``body``
        being one pass (a token loop's step, with ``buf`` a
        :class:`_LoopBuffers`, or a speculative round): while a program is
        captured, one WHILE node (:func:`~norma_tpu_torch.ops.loop_cond.
        while_node`), its passes counted on the device for the fetch; in
        the run before a capture, one pass whatever the condition (every
        kernel of the body runs before it is captured; the run's result is
        dropped, and the pass stays inside the crop: a loop's passes start
        at its first row); otherwise the condition is read on the host
        before each pass (counted on CUDA), and a window run outside a graph
        keeps the loop's passes (``_loop_passes``) for its record."""
        steps = isinstance(buf, _LoopBuffers)
        prog = self._capturing
        if prog is not None:
            i = len(prog.loops)
            if i >= prog.iters.numel():
                raise RuntimeError(f"a device program has more than {prog.iters.numel()} loops' WHILE nodes")
            if self._body_stream is None:
                self._body_stream = torch.cuda.Stream(device=buf.fin.device)
            tally, census = while_node(buf.fin, buf.pos, pos_end, body, pool=self._graph_pool,
                                       body_stream=self._body_stream, iters=prog.iters[i:i + 1])
            prog.loops.append((tally, steps))
            prog.stats["body_nodes"] = prog.stats.get("body_nodes", 0) + sum(census.values())
            types = prog.stats.setdefault("body_types", {})
            for k, v in census.items():
                types[k] = types.get(k, 0) + v
            return
        if self._warming:
            body()
            return
        cuda = buf.fin.device.type == "cuda"
        passes = 0
        while True:
            go = loop_cond(buf.fin, buf.pos, pos_end)
            if cuda:
                self.host_syncs += 1
            if not bool(go):
                break
            body()
            passes += 1
            self.decode_steps += steps
        if self._loop_passes is not None:
            self._loop_passes.append(passes)

    def _capture(self, dev: torch.device, fn):
        """Capture ``fn()`` into a new CUDA graph on the engine's side stream
        (after the current stream's work; the current stream then waits for
        the side stream).  Returns (graph, the launches it recorded, what
        ``fn`` returned, the seconds to record and to instantiate it).  A
        capture error raises."""
        cur = torch.cuda.current_stream(dev)
        side = self._side_stream = self._side_stream or torch.cuda.Stream(device=cur.device)
        side.wait_stream(cur)
        # One memory pool for all the engine's graphs: a graph's temporaries
        # are dead when it ends (its results are copied out) and graphs run
        # one at a time on one stream, so they can share blocks.  Each
        # engine (each data-parallel replica) has its own pool.
        if self._graph_pool is None:
            self._graph_pool = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph()
        # The wrappers' launches while captured are tallied, not counted;
        # each replay counts them.
        with _CAPTURE_LOCK, torch.cuda.stream(side), _build.recording_launches() as tally:
            # A graph destroyed while this one is captured invalidates the
            # capture (its destruction is a call a capturing stream does not
            # permit), and a dropped engine's graphs are freed by the cyclic
            # collector whenever it runs: collect first (as torch.cuda.graph
            # does) and keep the collector off until the capture ends.
            gc.collect()
            collecting = gc.isenabled()
            gc.disable()
            t0 = time.perf_counter()
            try:
                graph.capture_begin(pool=self._graph_pool, capture_error_mode="thread_local")
                try:
                    out = fn()
                finally:
                    t1 = time.perf_counter()
                    graph.capture_end()  # instantiates the graph
            finally:
                if collecting:
                    gc.enable()
        cur.wait_stream(side)
        self.graph_captures += 1
        return graph, tally, out, dict(record_s=t1 - t0, instantiate_s=time.perf_counter() - t1)

    def _warm_run(self, dev: torch.device, fn):
        """``fn()`` on the side stream, after the current stream's work: a
        first use's real run, which readies the kernel library, cuBLAS and
        the allocator before its capture."""
        cur = torch.cuda.current_stream(dev)
        side = self._side_stream = self._side_stream or torch.cuda.Stream(device=cur.device)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            return fn()

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
        ll, _, _ = self._fan(
            "decoder_step", self._rp, cfg, nxt, buf.pos, _crop(buf.cache_k, S), _crop(buf.cache_v, S),
            buf.xk, buf.xv, n_rungs,
        )
        buf.ll.copy_(first(ll))
        buf.step.add_(1)
        buf.pos.add_(1)

    def _token_loop_eager(
        self, xk, xv, cache_k, cache_v, next_logits, tokens_init, n0: int, prev1, prev2, temp,
        seed, n_rungs: int = 1, fin_init=None, greedy_only: bool = False,
    ):
        """The loop step by step with a host read of the finished flags
        before each step and no graphs: :meth:`_token_loop`'s results from
        the same steps, for comparisons on the card
        (:meth:`transcribe_window_eager`, :meth:`run_loop_eager`)."""
        ins = (xk, xv, cache_k, cache_v, next_logits, tokens_init)
        buf, generator = self._loop_start(ins, n0, prev1, prev2, temp, seed, fin_init, greedy_only)
        pos = n0
        crops = self._loop_crops(n0)
        passes = [0] * len(crops)  # per crop, as the graph's WHILE nodes count them
        with region("token_loop"):
            for i, (S, pos_end) in enumerate(crops):
                for _ in range(pos_end - pos):
                    self.host_syncs += 1
                    if not bool((~buf.fin).any()):
                        break
                    self._loop_step(buf, S, n_rungs, greedy_only, generator)
                    self.decode_steps += 1
                    passes[i] += 1
                else:
                    pos = pos_end
                    continue
                break
        if self._loop_passes is not None:
            self._loop_passes.extend(passes)
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
        feats = self._fan("encode", self._rp, cfg, mel)  # each rank's, whole
        xk, xv = self._fan("cross_kv", self._rp, cfg, feats)
        dev = audio.device
        if detect:
            sot = torch.full((B, 1), st.sot, dtype=torch.int32, device=dev)
            logits1 = first(self._fan("decoder_prefill", self._rp, cfg, sot, xk, xv)[0])
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
    def _ladder_impl(self, audio, langs, seed, active, *, detect: bool, eager: bool = False):
        """Whole-window transcription: mel -> encoder -> (detection) ->
        prefill -> no-speech gate -> the temperature-fallback ladder.

        audio: [B, S] padded PCM; langs: [B] language tokens (-1 = detect,
        only with ``detect=True``); seed: the ladder's draw key, an ``int``
        or its low word in one int64 on the device; active: [B] bool, False
        rows are batch padding (born finished, they decode nothing).  The
        loops' and rungs' stop tests run on the device: the window reads
        nothing on the host and is captured as one graph on CUDA; ``eager``
        runs the loops on :meth:`_token_loop_eager` instead.  The ladder
        is:

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
        loop = self._token_loop_eager if eager else self._token_loop
        with region("window_front"):  # mel, encoder, cross-K/V, detection, prefill
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
            temps_row = torch.cat([torch.full((B,), t, dtype=torch.float32, device=dev) for t in TEMPERATURES])
            toks, n, slp = loop(
                xk, xv,
                _tile_rows(cache_k, R), _tile_rows(cache_v, R),
                next_logits.repeat(R, 1), tokens_init.repeat(R, 1), 3,
                prefix[:, -1].repeat(R), prefix[:, -2].repeat(R),
                temps_row, _rung_seed(seed, 0),
                n_rungs=R, fin_init=gated0.repeat(R),
            )
            with region("ladder_finish"):
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
            xk, xv, cache_k, cache_v, next_logits, tokens_init, prefix, seed, gated0, eager=eager,
        )
        with region("ladder_finish"):
            return self._pack_ladder(btoks, bn, bavg, brung, nsp, langs, lang_probs)

    def _window_program(self, audio, langs, seed, active, *, detect: bool, eager: bool = False):
        """:meth:`_ladder_impl` as a window's program: the whole of it the
        region "window", inside which the front, each token loop and the
        finish are regions of their own (``tracing.region``)."""
        with region("window"):
            return self._ladder_impl(audio, langs, seed, active, detect=detect, eager=eager)

    def _sequential_rungs(
        self, xk, xv, cache_k, cache_v, next_logits, tokens_init, prefix, seed, settled0,
        *, start_rung: int = 0, eager: bool = False,
    ):
        """Sequential temperature ladder: try rungs in order, stopping once
        every stream has settled.  Rung r draws with key
        ``_rung_seed(seed, r)`` and reports TEMPERATURES[r]; settled rows are
        born finished; ``start_rung`` > 0 skips rungs a caller already ran
        (the speculative engine's t=0 pass).  The stop test is device work:
        every rung runs its loops, which run no step once every row is born
        finished, and a rung then takes no row.  ``eager`` (a comparison
        path): the host reads "any stream unsettled" before each rung and
        the rungs run :meth:`_token_loop_eager`.  Returns (btoks, bn, bavg,
        brung); rows never accepted carry brung = -1."""
        B = tokens_init.shape[0]
        dev = tokens_init.device
        settled = settled0.clone()
        btoks = tokens_init.clone()
        bn = torch.full((B,), 3, dtype=torch.int32, device=dev)
        bavg = torch.zeros(B, dtype=torch.float32, device=dev)
        brung = torch.full((B,), -1, dtype=torch.int64, device=dev)
        loop = self._token_loop_eager if eager else self._token_loop
        for r in range(start_rung, len(TEMPERATURES)):
            if eager:
                self.host_syncs += 1
                if not bool((~settled).any()):
                    break
            t = TEMPERATURES[r]
            toks, n, slp = loop(
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
        The window's record (:meth:`transcribe_window_async`) is in the
        process's store.
        """
        with span("DecodeEngine.transcribe_window", B=int(audio.shape[0]), samples=int(audio.shape[1]), seed=seed):
            return self.transcribe_window_fetch(
                self.transcribe_window_async(audio, langs, seed, n_active)
            )

    # The window splits into dispatch and fetch (the batching scheduler
    # pipelines rounds on it): on CUDA the dispatch queues the window's
    # graph and returns before its device work; the fetch is the window's
    # one host read.
    supports_async_window = True

    @torch.no_grad()
    def transcribe_window_async(self, audio, langs, seed: int, n_active: Optional[int] = None):
        """Queue the window: on CUDA its inputs' copies, its graph and the
        copies of its result to pinned host memory, all on the current
        stream, and return without waiting; several windows may be in
        flight, in stream order.  A window shape's first call runs the
        window once on the side stream (one pass of each loop), captures
        its graph, then replays it.  On the CPU the window runs up to its
        packed result.  :meth:`transcribe_window_fetch` completes it.

        Each window has a record (``tracing.py``; the fetch completes it and
        puts it in the process's store, and ``pending.record`` holds it):
        ``key`` (B, detect), ``graph``, ``n_active``, ``dispatch`` (this
        call's host start and end), ``regions`` (``[name, start, end]`` of
        the whole window, its front, each token loop and its finish: the
        card's time marks mapped onto ``perf_counter_ns`` within
        ``clock_err_ns``, or host stamps on the CPU), ``passes`` (per loop
        of decode steps) and ``fetched`` (when the fetch had the result)."""
        with span("window_dispatch") as sp:
            langs_arr, detect, active = self._window_inputs(audio, langs, n_active)
            key = int(seed) & 0xFFFFFFFF
            if self.device.type == "cuda":
                pending = self._window_graph_async(audio, langs_arr, key, active, detect)
            else:
                pending = self._window_run(audio, langs_arr, key, active, detect)
        pending.record.update(t0=sp["t0"], dispatch=[sp["t0"], sp["t1"]])
        return pending

    @torch.no_grad()
    def transcribe_window_eager(
        self, audio, langs, seed: int, n_active: Optional[int] = None
    ) -> Tuple[List[Optional[DecodingResult]], dict]:
        """:meth:`transcribe_window` with no graphs, its loops on
        :meth:`_token_loop_eager` (a host read of the finished flags before
        every step): the same results from the same steps, the comparison
        path on the card."""
        with span("window_dispatch") as sp:
            langs_arr, detect, active = self._window_inputs(audio, langs, n_active)
            pending = self._window_run(audio, langs_arr, int(seed) & 0xFFFFFFFF, active, detect, eager=True)
        pending.record.update(t0=sp["t0"], dispatch=[sp["t0"], sp["t1"]])
        return self.transcribe_window_fetch(pending)

    def _window_record(self, B: int, detect: bool, active, graph: bool) -> dict:
        """A window's record as its dispatch starts it (the fetch completes
        it); on the card the first one takes the engine's clock anchor."""
        if self.device.type == "cuda" and self._clock is None and tracing.ENABLED:
            with _CAPTURE_LOCK:  # no capture in flight in the process while it waits on the card
                self._clock = clock_anchor(self.device)
        return dict(key=[B, bool(detect)], graph=graph, n_active=int(np.count_nonzero(active)),
                    clock_err_ns=self._clock["err_ns"] if self._clock else 0)

    def _window_run(self, audio, langs_arr, seed: int, active, detect: bool, eager: bool = False) -> _HostPending:
        """The window run up to its packed device result, outside a graph
        (the CPU, and the eager comparison path), its regions marked (on the
        card into the engine's eager slots, copied to pinned memory after
        the window)."""
        cuda = self.device.type == "cuda"
        rec = self._window_record(int(audio.shape[0]), detect, active, graph=False)
        if cuda and self._eager_marks is None:
            self._eager_marks = (torch.zeros(_WINDOW_MARKS, dtype=torch.int64, device=self.device),
                                 torch.zeros(_WINDOW_MARKS, dtype=torch.int64, pin_memory=True))
        marks = Marks(self._eager_marks[0] if cuda else None)
        if isinstance(audio, torch.Tensor):
            audio_t = audio.to(self.device, torch.float32)
        else:
            audio_t = torch.from_numpy(np.asarray(audio, np.float32)).to(self.device)
        self._loop_passes = []
        try:
            with marking(marks):
                packed = self._window_program(
                    audio_t,
                    torch.from_numpy(np.array(langs_arr, np.int64)).to(self.device),
                    torch.tensor([seed], dtype=torch.int64, device=self.device),
                    torch.from_numpy(active).to(self.device),
                    detect=detect, eager=eager,
                )
            rec["passes"] = self._loop_passes
        finally:
            self._loop_passes = None
        if cuda:
            self._eager_marks[1].copy_(self._eager_marks[0], non_blocking=True)
        pending = _HostPending((packed, active, detect))
        pending.record, pending.marks = rec, marks
        return pending

    def _window_graph_async(self, audio, langs_arr, seed: int, active, detect: bool) -> _Pending:
        B, samples = int(audio.shape[0]), int(audio.shape[-1])
        rec = self._window_record(B, detect, active, graph=True)
        key = ("window", B, samples, detect)
        prog = self._programs.get(key)
        if prog is None:
            n_out = self.cfg.max_target_positions + 5 + (len(self._lang_ids) if detect else 1)  # _pack_ladder's
            # A pass counter per WHILE node: at most one node per cache crop
            # in each of the ladder's loops.
            prog = self._programs[key] = _Program(
                self.device, len(TEMPERATURES) * len(self._loop_crops(3)), (B, n_out),
                dict(audio=((B, samples), torch.float32), langs=((B,), torch.int64), active=((B,), torch.bool),
                     seed=((1,), torch.int64)),
                staging=2,  # two windows in flight take them in turn
                marks=_WINDOW_MARKS,
            )
        staging = prog.take()
        prog.load(staging, audio=audio, langs=langs_arr, active=active, seed=[seed])
        ins = prog.ins
        run = lambda: self._window_program(ins["audio"], ins["langs"], ins["seed"], ins["active"], detect=detect)
        pending = self._dispatch(prog, staging, run, "window_graph", meta=(active, detect))
        pending.record = rec
        return pending

    def _dispatch(self, prog: _Program, staging: dict, run, name: str, meta: tuple = ()) -> _Pending:
        """Replay ``prog`` on its inputs, as loaded into it, and queue the
        copies of its result and passes to ``staging``, all on the current
        stream, without waiting; a program's first call captures it first
        (:meth:`_capture_program` of ``run``).  ``name``: the region of the
        replay (a profiler's device span of its kernels)."""
        if prog.graph is None:
            self._capture_program(prog, run)
        with region(name):
            prog.graph.replay()
        _build.count_all(prog.launches)
        staging["out"].copy_(prog.out, non_blocking=True)
        staging["iters"].copy_(prog.iters, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        if self._graph_launched is not None:
            self._graph_launched(done)
        return _Pending(prog, staging, done, meta)

    def _capture_program(self, prog: _Program, run) -> None:
        """A program's first call: ``run()`` on the side stream on
        ``prog``'s inputs, one pass of each loop (it readies the kernel
        library, cuBLAS, cuFFT and the allocator before the capture; its
        result is dropped), then captured into ``prog``: ``run`` returns the
        packed result, or (the result, what the program keeps)."""
        dev = self.device
        with _CAPTURE_LOCK:  # no capture in flight in the process while the tracer starts
            prime_device_tracer()
        self._warming = True
        try:
            self._warm_run(dev, run)
        finally:
            self._warming = False

        def capture():
            prog.iters.zero_()
            prog.loops, prog.stats = [], {}
            marks = Marks(prog.iters[prog.n_nodes:]) if prog.n_marks else None
            self._capturing = prog
            try:
                with marking(marks):
                    out = run()
            finally:
                self._capturing = None
            prog.mark_names = marks.names if marks is not None else []
            prog.stats["nodes"] = capture_nodes(torch.cuda.current_stream(dev))
            return out

        try:
            prog.graph, prog.launches, out, seconds = self._capture(dev, capture)
        except RuntimeError as e:
            raise RuntimeError(f"a device program's capture failed: {e}; its WHILE bodies' nodes: "
                               f"{census_text(prog.stats.get('body_types', {}))}") from e
        prog.out, prog.keep = out if isinstance(out, tuple) else (out, None)
        prog.stats.update(seconds)

    @staticmethod
    def window_passes(pending) -> Optional[List[int]]:
        """The WHILE passes of a program's replay in flight, so far, per
        loop (read on a stream of their own, so a replay that does not end
        does not hold the read; None if the read does not end within 5 s,
        or ``pending`` is no replay)."""
        if not isinstance(pending, _Pending):
            return None
        side = torch.cuda.Stream(device=pending.prog.iters.device)
        out = torch.empty(pending.prog.iters.shape, dtype=torch.int64, pin_memory=True)
        with torch.cuda.stream(side):
            out.copy_(pending.prog.iters, non_blocking=True)
            done = torch.cuda.Event()
            done.record()
        t0 = time.monotonic()
        while not done.query():
            if time.monotonic() - t0 > 5.0:
                return None
            time.sleep(0.001)
        return out.tolist()[:len(pending.prog.loops)]

    def _await(self, pending) -> None:
        """Wait until a replay in flight (what has a ``done`` event; a CPU
        window has none) is done: at most ``fetch_timeout_s`` when set,
        since ranks whose loops ran different passes would wait on each
        other inside the graph, where NCCL's watchdog does not look; then
        raise ``NormaError`` naming this rank's WHILE passes so far."""
        done = getattr(pending, "done", None)
        if done is None:
            return
        limit = self.fetch_timeout_s
        if limit is None:
            done.synchronize()
            return
        t0 = time.monotonic()
        while not done.query():
            if time.monotonic() - t0 > limit:
                raise NormaError(f"rank {getattr(self._group, 'rank', 0)}: the device program is not done after "
                                 f"{limit:g} s; its loops' WHILE passes so far: {self.window_passes(pending)}")
            time.sleep(0.0002)

    def _fetch(self, pending: _Pending) -> np.ndarray:
        """A replay's one host read: wait for its copies (:meth:`_await`),
        then scale each WHILE node's launches, and steps, by its passes
        into the counters; a window's record gets its passes and marks and
        goes to the store.  Returns the packed result."""
        self._await(pending)
        self.host_syncs += 1
        prog, staging = pending.prog, pending.staging
        out = staging["out"].numpy().copy()
        counts = staging["iters"].tolist()
        prog.passes = counts[:len(prog.loops)]
        for passes, (tally, steps) in zip(prog.passes, prog.loops):
            _build.count_all({c: n * passes for c, n in tally.items()})
            if steps:
                self.decode_steps += passes
        prog.give(staging)
        if pending.record is not None:
            self._file_window(pending, prog.mark_names, counts[prog.n_nodes:], prog.passes)
        return out

    def _file_window(self, pending, names, times, passes, device_clock: bool = True) -> None:
        """Complete a window's record and put it in the store (``pending.
        record`` is then the stored record): its regions from its marks (the
        card's mapped by the engine's clock anchor), its loops' passes, the
        time its fetch had the result."""
        offset = self._clock["offset_ns"] if device_clock and self._clock else 0
        t = time.perf_counter_ns()
        pending.record = record("window", **pending.record, passes=list(passes), fetched=t, t1=t,
                                regions=mark_regions(names, [v + offset for v in times]))

    def transcribe_window_fetch(self, pending) -> Tuple[List[Optional[DecodingResult]], dict]:
        """Complete a :meth:`transcribe_window_async` window: the window's
        one host read (a graph window: :meth:`_fetch`), and the unpack."""
        if isinstance(pending, _Pending):
            return self._unpack_ladder(self._fetch(pending), *pending.meta)
        packed, active, detect = pending
        packed = self._host(packed)
        marks = getattr(pending, "marks", None)
        if marks is not None:
            on_card = marks.slots is not None
            times = self._eager_marks[1].tolist()[:len(marks.names)] if on_card else marks.host
            self._file_window(pending, marks.names, times, pending.record.pop("passes"), device_clock=on_card)
        return self._unpack_ladder(packed, active, detect)

    def _unpack_ladder(
        self,
        packed: np.ndarray,
        active: np.ndarray,
        detect: bool,
        *,
        trailing_cols: int = 0,
        reject_rung0_below_gate: bool = False,
    ) -> Tuple[List[Optional[DecodingResult]], dict]:
        """Host-side unpack of :meth:`_pack_ladder`'s layout (the speculative
        engine unpacks through here too).  ``trailing_cols``: telemetry
        columns after the lang_probs block.  ``reject_rung0_below_gate``:
        also reject rung-0 rows failing the logprob gate (the speculative
        host applies the gate after its fallback dispatch, whereas the plain
        ladder gated on the device: rung -1)."""
        Tmax = self.cfg.max_target_positions
        btoks = packed[:, :Tmax].astype(np.int32)
        bn = packed[:, Tmax].astype(np.int32)
        bavg = packed[:, Tmax + 1]
        brung = packed[:, Tmax + 2].astype(np.int32)
        nsp = packed[:, Tmax + 3]
        langs_out = packed[:, Tmax + 4].astype(np.int32)
        lang_probs = packed[:, Tmax + 5 : packed.shape[1] - trailing_cols]
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
            if brung[b] < 0 or (
                reject_rung0_below_gate and brung[b] == 0 and bavg[b] < LOGPROB_THRESHOLD
            ):
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
        if not isinstance(feats, RankList):  # each rank's features (prefill_window)
            feats = torch.as_tensor(feats).to(self.device)
        B = first(feats).shape[0]
        prefix_arr = self._prefix_array(B, lang_token)
        xk, xv = self._fan("cross_kv", self._rp, self.cfg, feats)
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
        (which it may reuse), as one device program with one host read, the
        fetch of its packed ``[tokens | n | sum_logprob]`` (the JAX
        package's one loop program and one fetch).  On CUDA a graph per
        (state's tensors' signature, prefix length, greedy): the state is
        copied into the graph's own inputs, so the caller's caches are only
        read, and the temperature and the seed are inputs too.  On the CPU
        the same structure runs eagerly, writing rows of the state's caches
        that it rewrites before any read (:meth:`_token_loop`)."""
        return self._run_loop(state, temperature, seed, eager=False)

    @torch.no_grad()
    def run_loop_eager(self, state, temperature: float, seed: int) -> List[DecodingResult]:
        """:meth:`run_loop` with no graphs, its loop on
        :meth:`_token_loop_eager` (a host read of the finished flags before
        every step): the same results from the same steps, the comparison
        path on the card."""
        return self._run_loop(state, temperature, seed, eager=True)

    def _run_loop(self, state, temperature: float, seed: int, eager: bool) -> List[DecodingResult]:
        prefix = np.asarray(state["prefix"], np.int32)
        B, P = prefix.shape
        Tmax = self.cfg.max_target_positions
        greedy = temperature == 0.0
        temps = np.full(B, temperature, np.float32)
        ins = {k: state[k] for k in ("xk", "xv", "cache_k", "cache_v", "next_logits")}
        if self.device.type == "cuda" and not eager:
            key = ("loop", _signature(tuple(ins.values())), P, greedy)
            prog = self._programs.get(key)
            if prog is None:
                prog = self._programs[key] = _Program(
                    self.device, len(self._loop_crops(P)), (B, Tmax + 2),
                    dict(prefix=((B, P), torch.int32), temp=((B,), torch.float32), seed=((1,), torch.int64)), ins,
                )
            staging = prog.take()
            prog.load(staging, prefix=prefix, temp=temps, seed=[_signed_key(seed)], **ins)
            run = lambda: self._loop_packed(**prog.ins, greedy_only=greedy)
            packed = self._fetch(self._dispatch(prog, staging, run, "loop_graph"))
        else:
            as_dev = lambda a: torch.from_numpy(a).to(self.device)
            packed = self._host(self._loop_packed(**ins, prefix=as_dev(prefix), temp=as_dev(temps), seed=int(seed),
                                                  greedy_only=greedy, eager=eager))
        tokens = packed[:, :Tmax].astype(np.int32)
        n = packed[:, Tmax].astype(np.int32)
        slp = packed[:, Tmax + 1]
        out = []
        for b in range(B):
            toks = tokens[b, : n[b]].tolist()
            avg_logprob = float(slp[b]) / max(len(toks), 1)
            while len(toks) >= 2 and toks[-2] > self.st.no_timestamps:
                del toks[-2]
            out.append(
                DecodingResult(
                    tokens=toks,
                    avg_logprob=avg_logprob,
                    no_speech_prob=float(state["no_speech_prob"][b]),
                )
            )
        return out

    def _loop_packed(self, xk, xv, cache_k, cache_v, next_logits, prefix, temp, seed, *, greedy_only: bool,
                     eager: bool = False):
        """:meth:`run_loop`'s device work: the token loop over a prefill
        state from the prefix [B, P], packed as [B, Tmax+2] f32 (tokens, n,
        sum of logprobs)."""
        B, P = prefix.shape
        tokens_init = torch.zeros((B, self.cfg.max_target_positions), dtype=torch.int32, device=prefix.device)
        tokens_init[:, :P] = prefix
        loop = self._token_loop_eager if eager else self._token_loop
        tokens, n, slp = loop(
            xk, xv, cache_k, cache_v, next_logits, tokens_init, P, prefix[:, -1], prefix[:, -2], temp, seed,
            greedy_only=greedy_only,
        )
        return torch.cat([tokens.to(torch.float32), n.to(torch.float32)[:, None], slp[:, None]], 1)

    @instrument  # reference #[instrument], model.rs:163
    def decode_with_fallback(
        self, feats, lang_token: Optional[int], seed: int
    ) -> Optional[DecodingResult]:
        """Temperature-fallback ladder (reference: model.rs:164-191), B=1.

        Fallback triggers on avg_logprob alone (the reference never
        computes compression_ratio).  When the no-speech probe fires the
        prefix-only result is returned; the long-form layer discards it.
        """
        return self._fallback_from_state(self.prefill(feats, lang_token), seed)

    def decode_with_fallback_windowed(self, audio, lang_token, seed: int) -> Optional[DecodingResult]:
        """:meth:`decode_with_fallback` from a raw padded PCM window."""
        return self._fallback_from_state(self.prefill_window(audio, lang_token), seed)

    def _fallback_from_state(self, state, seed: int) -> Optional[DecodingResult]:
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

    @torch.no_grad()
    def detect_language(self, feats) -> np.ndarray:
        """[B, n_languages] probabilities (``language_token_ids`` order) from
        one decoder pass over [sot] (reference: detect_language,
        model.rs:194-210)."""
        if self._lang_ids is None:
            raise ValueError("language detection requires language_token_ids")
        feats = torch.as_tensor(feats).to(self.device)
        B = feats.shape[0]
        xk, xv = self._fan("cross_kv", self._rp, self.cfg, feats)
        sot = torch.full((B, 1), self.st.sot, dtype=torch.int32, device=self.device)
        logits = first(self._fan("decoder_prefill", self._rp, self.cfg, sot, xk, xv)[0])
        return self._host(torch.softmax(logits[:, 0, self._lang_ids], dim=-1))

    def decode(
        self, feats, lang_token: Optional[int], temperature: float, seed: int, _prefill_state=None
    ) -> DecodingResult:
        """Single decode at one temperature (reference: decode, model.rs:279-389)."""
        state = _prefill_state or self.prefill(feats, lang_token)
        return self.run_loop(state, temperature, seed)[0]

    @torch.no_grad()
    def prefill_window(self, audio, lang_token):
        """:meth:`prefill` from raw padded PCM [B, samples] (mel, encoder,
        prefill in one call)."""
        if isinstance(audio, torch.Tensor):
            audio_t = audio.to(self.device, torch.float32)
        else:
            audio_t = torch.from_numpy(np.asarray(audio, np.float32)).to(self.device)
        cfg = self.cfg
        mel = log_mel_spectrogram(
            audio_t, n_mels=cfg.num_mel_bins, n_frames=2 * cfg.max_source_positions,
            center=self.mel_center,
        )
        return self.prefill(self._fan("encode", self._rp, cfg, mel), lang_token)
