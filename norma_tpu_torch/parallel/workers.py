"""One worker process per card: the engines of mesh positions that lie on
distinct cards (``parallel/data_parallel.py`` chooses them by the mesh).

A :class:`WorkerEngine` is one dp position's engine whose tp ranks (one,
or the position's tp group) each live in a spawned process on its own
device.  Each worker builds its engine on its rank's shard -- a plain
engine for tp 1, a tp engine over a :class:`~norma_tpu_torch.parallel.
collectives.ProcessGroup` (NCCL on the cards, gloo on the CPU) for its
group otherwise -- and answers the window entry points with host values.

An argument given as a :class:`~norma_tpu_torch.parallel.collectives.
RankList` of ``Params`` (a speculative engine's draft) reaches rank k as
rank k's shard, sent as the engine's own shard is; the worker wraps it,
under tp, in a ``TPParams`` over the same group (one communicator).

Shards travel as CPU tensors in shared memory (``torch.multiprocessing``
moves a CPU tensor's storage there when it is sent): the same transport
on the CPU and on the cards, no CUDA IPC handle whose owner must outlive
every reader, and each worker copies its shard onto its own card once.
``shard_params`` keeps a worker mesh's shards on the host for this, so
the parent holds no copy on the cards.
The parent builds the CUDA kernels before it spawns, so workers load the
library and never race on its build.

Every call goes to every rank of the position; the ranks must return the
same pickled bytes (their results bit for bit), else the call raises.  A
worker that dies, or a spawn that is not ready in time, raises
:class:`~norma_tpu_torch.errors.NormaError` in the parent; nothing falls
back to the parent's device.

Each entry point that runs a loop -- a window, ``run_loop``, a speculative
window and its fallback -- runs on each card as one CUDA graph whose loops
are WHILE nodes with the collectives inside (``decode/engine.py``); a
window dispatched with ``transcribe_window_async`` returns after the
dispatch.  Every fetch waits at most ``FETCH_TIMEOUT_S``: ranks whose
loops ran different passes would wait on each other inside the graph,
where NCCL's watchdog does not look, so a program not done by then raises
:class:`~norma_tpu_torch.errors.NormaError` naming each rank's WHILE passes
so far.
"""

from __future__ import annotations

import inspect
import itertools
import os
import pickle
import shutil
import sys
import tempfile
import threading
import time
import traceback
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..errors import NormaError

# Seconds a worker may take from spawn to a built engine (imports, the
# shard's copy, the communicator).
SPAWN_TIMEOUT_S = 600.0

# Seconds a worker waits at a fetch for its window's device work (a
# window takes well under a second on the card; a deadlock never ends).
FETCH_TIMEOUT_S = 60.0


def _tree(params) -> dict:
    """A Params tree as nested dicts of CPU tensors (shared when sent)."""
    return {k: _tree(v) if isinstance(v, torch.nn.Module) else v.detach().cpu() for k, v in params.items()}


class _Shard:
    """A rank's shard of a sharded engine argument, as :func:`_tree` sends it."""

    def __init__(self, tree: dict):
        self.tree = tree


def _rank_args(args, kwargs, k: int):
    """``args`` and ``kwargs`` for rank ``k``: each RankList argument as that
    rank's shard."""
    from .collectives import RankList

    one = lambda a: _Shard(_tree(a[k])) if isinstance(a, RankList) else a  # noqa: E731
    return tuple(one(a) for a in args), {n: one(v) for n, v in kwargs.items()}


# Attributes of a speculative engine that its WorkerEngine reads from the
# workers, beside WorkerEngine._REMOTE.
_SPEC_REMOTE = ("last_spec_rounds", "last_tokens_per_round", "last_spec_k", "spec_k")


# Process-wide numerics a worker takes from its parent, so that it computes
# as the parent's engine would (cuDNN's TF32 default, for one, rounds the
# encoder's f32 convolution stem otherwise).
_FLAGS = (
    (torch.backends.cuda.matmul, "allow_tf32"),
    (torch.backends.cuda.matmul, "allow_bf16_reduced_precision_reduction"),
    (torch.backends.cuda.matmul, "allow_fp16_reduced_precision_reduction"),
    (torch.backends.cudnn, "allow_tf32"),
    (torch.backends.cudnn, "deterministic"),
    (torch.backends.cudnn, "benchmark"),
)


def _flags() -> list:
    return [getattr(obj, name) for obj, name in _FLAGS]


def _host(x):
    """``x`` with tensors as numpy (what a worker sends back)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if isinstance(x, dict):
        return {k: _host(v) for k, v in x.items()}
    if isinstance(x, tuple):
        return tuple(_host(v) for v in x)
    if isinstance(x, list):
        return [_host(v) for v in x]
    return x


# The group's ranks are processes of this machine: NCCL's and gloo's
# sockets stay on the loopback interface, and NCCL takes no InfiniBand.
# NCCL's support for mixing graph and eager launches on one communicator
# adds event-record and event-wait nodes to each collective's capture,
# which a WHILE node's body does not admit (the window graph's
# instantiation fails with cudaErrorInvalidValue: NCCL 2.28, CUDA 12.8).
# Without it a body holds kernel nodes only, and NCCL supports neither
# graphs with the communicator's collectives in flight at once on streams
# that do not order them, nor a collective launched outside a graph while
# such a graph is in flight, whatever the streams' order.  A rank replays
# its graphs on one stream, and its ProcessGroup waits for the graphs in
# flight before a collective outside a capture (``ProcessGroup.
# graph_launched``).
WORKER_ENV = (("NCCL_SOCKET_IFNAME", "lo"), ("GLOO_SOCKET_IFNAME", "lo"), ("NCCL_IB_DISABLE", "1"),
              ("NCCL_GRAPH_MIXING_SUPPORT", "0"))


def _worker_main(conn, rank: int, size: int, device: str, store_path: str) -> None:
    """A worker: build the engine from the first message, then answer calls
    until "close" (module docstring).  It ends with ``os._exit``: tearing
    down an NCCL communicator whose peers are exiting too can wait out its
    timeout, and the process's end frees the card."""
    try:
        from ..model.load import Params
        from ..ops import launch_counters
        from ..tracing import idle_share, profiled_device_ms
        from .collectives import ProcessGroup, TPParams, first

        torch.set_num_threads(2)  # a worker's host work is dispatch, not math
        for k, v in WORKER_ENV:
            os.environ.setdefault(k, v)
        dev = torch.device(device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        cls, tree, args, kwargs, flags = conn.recv()
        for (obj, name), v in zip(_FLAGS, flags):
            setattr(obj, name, v)
        group = ProcessGroup(rank, size, dev, store_path) if size > 1 else None

        def place(tree):
            """This rank's shard on its device: under tp its TPParams over the group."""
            shard = Params(tree).to(dev)
            return shard if group is None else TPParams([shard], [rank], group)

        params = place(tree)
        args = tuple(place(a.tree) if isinstance(a, _Shard) else a for a in args)
        kwargs = {k: place(v.tree) if isinstance(v, _Shard) else v for k, v in kwargs.items()}
        del tree
        with torch.no_grad():
            engine = cls(params, *args, **kwargs)
        engine.fetch_timeout_s = FETCH_TIMEOUT_S  # every program's fetch (module docstring)
        conn.send_bytes(pickle.dumps(("ok", None)))
        pending, states, keys = {}, {}, itertools.count()  # keys alike on every rank
        while True:
            msg = conn.recv()
            if msg[0] == "close":
                break
            try:
                op, name, a, kw = msg
                if op == "get":
                    res = getattr(engine, name)
                elif op == "launches":  # this process's kernel launch counters (reset after reading)
                    res = {k: c.launches for k, c in launch_counters().items()}
                    if a[0]:
                        for c in launch_counters().values():
                            c.launches = 0
                elif op == "fetch":  # a pending async window, by key; its wait has a deadline
                    p = pending.pop(a[0])
                    engine._await(p)
                    res = engine.transcribe_window_fetch(p)
                elif op == "on_ranks":  # name: a function of the engine
                    res = name(engine, *a, **kw)
                elif op == "run_loop":  # a prefill state, by key (a ladder reruns one)
                    res = engine.run_loop(states[a[0]], *a[1:], **kw)
                elif op in ("idle_share", "profiled_device_ms"):
                    trace_dir, n, ops = kw.pop("trace_dir"), kw.pop("n", 1), kw.pop("ops", 0)
                    fn = lambda: getattr(engine, name)(*a, **kw)  # noqa: E731
                    res = (idle_share(fn, trace_dir) if op == "idle_share"
                           else profiled_device_ms(fn, n, trace_dir, ops=ops))
                else:
                    res = getattr(engine, name)(*a, **kw)
                    if name == "transcribe_window_async":
                        key = next(keys)
                        pending[key] = res
                        res = key
                    elif name in ("prefill", "prefill_window"):
                        key = next(keys)
                        states[key] = res
                        for k in sorted(states)[:-4]:  # the last four prefills stay
                            del states[k]
                        res = dict(prefix=res["prefix"], B=res["B"], no_speech_prob=res["no_speech_prob"],
                                   next_logits=first(res["next_logits"]), key=key)
                conn.send_bytes(pickle.dumps(("ok", _host(res))))
            except Exception:
                conn.send_bytes(pickle.dumps(("err", traceback.format_exc())))
    except Exception:
        try:
            conn.send_bytes(pickle.dumps(("err", traceback.format_exc())))
        except Exception:
            pass
    finally:
        conn.close()
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(0)


class WorkerEngine:
    """The engine of one dp position whose ranks run in worker processes,
    one per device of ``devices`` (rank k of the position's tp group on
    ``devices[k]``).  ``cfg``, ``st`` and ``device`` (the first rank's) are
    read here; the window entry points, the prefill / run_loop pair and the
    counters go to the workers, and for a speculative engine its telemetry
    and ``warmup_fallback``.  ``supports_async_window`` is the engine
    class's: a speculative window does not split into dispatch and fetch."""

    def __init__(self, cls, shards: Sequence, devices: Sequence, args=(), kwargs=None,
                 spawn_timeout_s: float = SPAWN_TIMEOUT_S):
        import torch.multiprocessing as mp

        kwargs = dict(kwargs or {})
        devices = [torch.device(d) for d in devices]
        cards = [d for d in devices if d.type == "cuda"]
        if len(set(cards)) != len(cards):  # NCCL takes one rank a card
            raise NormaError(f"one worker per card: {[str(d) for d in devices]} names a card twice")
        bound = inspect.signature(cls.__init__).bind(None, None, *args, **kwargs).arguments
        self.cfg, self.st = bound["cfg"], bound["st"]
        self.device = devices[0]
        self.devices = devices
        self.tp = len(devices)
        self.supports_async_window = bool(getattr(cls, "supports_async_window", False))
        self._speculative = hasattr(cls, "warmup_fallback")
        self._remote = WorkerEngine._REMOTE + (_SPEC_REMOTE if self._speculative else ())
        if any(d.type == "cuda" for d in devices):
            from ..ops import _build

            _build.lib()  # built (and loaded) here, once, before any worker starts
        self._lock = threading.Lock()  # one exchange with the workers at a time
        self._dir = tempfile.mkdtemp(prefix="norma_tp_")
        ctx = mp.get_context("spawn")
        self._procs, self._conns = [], []
        try:
            for k, dev in enumerate(devices):
                parent, child = ctx.Pipe()
                p = ctx.Process(target=_worker_main, daemon=True, name=f"norma-worker-{dev}",
                                args=(child, k, self.tp, str(dev), os.path.join(self._dir, "store")))
                p.start()
                child.close()
                self._procs.append(p)
                self._conns.append(parent)
            for k, (conn, shard) in enumerate(zip(self._conns, shards)):
                conn.send((cls, _tree(shard), *_rank_args(args, kwargs, k), _flags()))
            self._replies(spawn_timeout_s)
        except BaseException:
            self.close(wait=False)
            raise

    # ------------------------------------------------------------------

    def _replies(self, timeout_s: Optional[float] = None, compare: bool = True) -> list:
        """Every rank's reply to the last message: raises if a worker died,
        failed, missed ``timeout_s``, or (``compare``) answered differently
        from rank 0."""
        from multiprocessing.connection import wait

        raws = {}
        t0 = time.monotonic()
        while len(raws) < len(self._conns):
            for conn in wait([c for k, c in enumerate(self._conns) if k not in raws], timeout=0.05):
                k = self._conns.index(conn)
                try:
                    raws[k] = conn.recv_bytes()
                except EOFError:
                    raise NormaError(f"the worker on {self.devices[k]} closed its pipe "
                                     f"(exit code {self._procs[k].exitcode})") from None
            for k, p in enumerate(self._procs):  # a dead rank raises at once, not when its peers time out
                if k not in raws and not p.is_alive():
                    raise NormaError(f"the worker on {self.devices[k]} died (exit code {p.exitcode})")
            if timeout_s is not None and time.monotonic() - t0 > timeout_s:
                k = min(set(range(len(self._conns))) - set(raws))
                raise NormaError(f"the worker on {self.devices[k]} did not answer in {timeout_s:.0f} s")
        raws = [raws[k] for k in range(len(self._conns))]
        outs = [pickle.loads(r) for r in raws]
        failed = [f"the worker on {self.devices[k]} failed:\n{val}" for k, (status, val) in enumerate(outs)
                  if status != "ok"]
        if failed:
            raise NormaError("\n".join(failed))
        if compare and any(r != raws[0] for r in raws[1:]):
            raise NormaError(f"tp ranks on {[str(d) for d in self.devices]} returned different results")
        return [v for _, v in outs]

    def _send(self, msg) -> None:
        """``msg`` to every rank; a worker that is gone raises."""
        for k, (conn, p) in enumerate(zip(self._conns, self._procs)):
            try:
                conn.send(msg)
            except OSError:
                raise NormaError(f"the worker on {self.devices[k]} died (exit code {p.exitcode})") from None

    def _call(self, op: str, name, *args, timeout_s: Optional[float] = None, **kwargs):
        with self._lock:
            self._send((op, name, args, kwargs))
            return self._replies(timeout_s)[0]

    def call(self, name: str, *args, **kwargs):
        """``engine.name(*args, **kwargs)`` on every rank; rank 0's result."""
        return self._call("call", name, *_host(args), **_host(kwargs))

    def on_ranks(self, fn, *args, **kwargs) -> list:
        """``fn(engine, *args, **kwargs)`` in every worker (``fn`` a module's
        function, sent by name: a measurement or check of each rank's
        engine); every rank's result, not compared."""
        with self._lock:
            self._send(("on_ranks", fn, _host(args), _host(kwargs)))
            return self._replies(compare=False)

    def profile(self, kind: str, trace_dir: str, name: str, *args, n: int = 1, ops: int = 0, **kwargs):
        """``tracing.idle_share`` or ``tracing.profiled_device_ms`` (``kind``;
        ``n`` calls, ``ops`` top kernels) of ``engine.name(*args)`` in every
        worker, each tracing its own card into ``trace_dir``/rank<k>, where
        ``tracing.device_time_report`` reads it; returns every rank's result
        (the ranks' device times differ, so they are not compared)."""
        with self._lock:
            for k, (conn, p) in enumerate(zip(self._conns, self._procs)):
                if not p.is_alive():
                    raise NormaError(f"the worker on {self.devices[k]} died (exit code {p.exitcode})")
                conn.send((kind, name, _host(args),
                           dict(_host(kwargs), trace_dir=os.path.join(trace_dir, f"rank{k}"), n=n, ops=ops)))
            return self._replies(compare=False)

    def launches(self, reset: bool = False) -> List[dict]:
        """Each rank's kernel launch counters ``{kernel: launches}`` in its
        worker (zeroed after the read when ``reset``)."""
        with self._lock:
            self._send(("launches", "", (bool(reset),), {}))
            return self._replies(compare=False)

    # Engine attributes read from the workers (rank 0's; the ranks agree).
    _REMOTE = ("host_syncs", "decode_steps", "graph_captures")

    def __getattr__(self, name):
        if name == "warmup_fallback" and self.__dict__.get("_speculative"):
            # Only a speculative engine has it (DataParallelEngine and
            # WhisperModel.warmup test for it).
            return lambda batch=1: self.call("warmup_fallback", int(batch))
        if name not in self.__dict__.get("_remote", WorkerEngine._REMOTE):
            raise AttributeError(name)
        return self._call("get", name)

    # ------------------------------------------------------------------
    # The engine's entry points
    # ------------------------------------------------------------------

    def transcribe_window(self, audio, langs, seed: int, n_active: Optional[int] = None):
        return self.call("transcribe_window", audio, langs, int(seed), n_active=n_active)

    def transcribe_window_async(self, audio, langs, seed: int, n_active: Optional[int] = None):
        return self.call("transcribe_window_async", audio, langs, int(seed), n_active=n_active)

    def transcribe_window_fetch(self, pending):
        """The workers' fetch of a dispatched window: each waits at most
        ``FETCH_TIMEOUT_S`` for its device work (module docstring)."""
        return self._call("fetch", "transcribe_window_fetch", pending, timeout_s=FETCH_TIMEOUT_S + 30.0)

    def detect_language(self, feats) -> np.ndarray:
        return self.call("detect_language", feats)

    def encode(self, mel):
        return self.call("encode", mel)

    def prefill(self, feats, lang_token):
        """The workers' prefill: its state stays in them (``run_loop`` names
        it by ``key``); the caller gets ``prefix``, ``B``,
        ``no_speech_prob`` and rank 0's ``next_logits`` [B, V] (every
        rank's are the same full logits)."""
        return self.call("prefill", feats, lang_token)

    def prefill_window(self, audio, lang_token):
        return self.call("prefill_window", audio, lang_token)

    def run_loop(self, state, temperature: float, seed: int):
        return self._call("run_loop", "run_loop", state["key"], float(temperature), int(seed))

    def close(self, wait: bool = True) -> None:
        """Stop the workers: each finishes its call and exits, or is killed
        once 30 s have passed for them all (at once without ``wait``)."""
        for conn in getattr(self, "_conns", []):
            try:
                conn.send(("close",))
            except OSError:
                pass
        deadline = time.monotonic() + (30 if wait else 0)
        for p in getattr(self, "_procs", []):
            p.join(timeout=max(deadline - time.monotonic(), 0))
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
        for conn in getattr(self, "_conns", []):
            conn.close()
        self._procs, self._conns = [], []
        shutil.rmtree(getattr(self, "_dir", ""), ignore_errors=True)
