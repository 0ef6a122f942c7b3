"""Data and tensor parallelism over a mesh: one engine per dp position,
each over its position's tp ranks (the counterpart of the JAX package's dp
carry, ``norma_tpu/decode/engine.py:108-166, 262-330``, which runs the
single-device kernel program per device under ``shard_map`` over 'dp', and
of its tp-sharded params under GSPMD).

``DecodeEngine(params, ...)`` and ``SpeculativeEngine(params, ...,
draft_params, ...)`` return a :class:`DataParallelEngine` when their params
are :class:`~norma_tpu_torch.parallel.sharding.ShardedParams`: the engine
takes its mesh from the params.  The mesh's devices choose how each
position runs:

  - every position on one device (virtual devices: the CPU, or one card
    named several times): each position is an engine in this process --
    the engine class on the position's ``Params`` for tp 1, a tp engine over
    its ranks' shards and a :class:`~norma_tpu_torch.parallel.collectives.
    LocalGroup` above;
  - tp above 1, every rank on its own card (``sharding.in_workers``): each
    position is a :class:`~norma_tpu_torch.parallel.workers.WorkerEngine`,
    one worker process per card, its tp ranks reducing over NCCL (a
    speculative draft's shards go to the same workers and reduce over the
    same communicator);
  - tp 1 on distinct cards: each replica is an engine in this process, as
    on virtual devices.  Each replica's window is one CUDA graph replay
    and one host read, so the replicas' threads run at once (one row a
    card over four H100s: 1.01x the slowest replica alone; PERF.md
    section 6);
  - each position's ranks on one device of their own: engines in this
    process, one LocalGroup each.

Any other mesh (a tp group over distinct cards that also shares a card)
raises.  Each position's engine runs in its own thread, on its own CUDA
stream where it is in this process: a window's first call of its shape
runs with host reads inside the call (its run before the capture), and a
worker engine's calls wait on its pipes, so positions that shared a host
thread or the legacy default stream would run one after the other.

Every window entry point splits its rows over the replicas when the batch
B divides by dp (each replica chooses its ladder arm on its local batch,
as the JAX ``shard_map`` program does, so t=0 tokens equal JAX's dp
engine's); any other B runs whole on the first replica, the arm JAX's
unsharded program chooses.  Other attributes and methods are the first
replica's.  Every :class:`~norma_tpu_torch.parallel.sharding.ShardedParams`
argument (a speculative draft) reaches a position as its own ranks'
shards: its ``Params`` for tp 1, otherwise a
:class:`~norma_tpu_torch.parallel.collectives.TPParams` over the target's
group.
"""

from __future__ import annotations

import concurrent.futures
from typing import List, Optional

import numpy as np
import torch

from ..decode.engine import DecodeEngine
from ..errors import NormaError
from .collectives import LocalGroup, RankList, TPParams
from .sharding import Mesh, ShardedBatch, ShardedParams, in_workers
from .workers import WorkerEngine


class _Replica:
    """One replica engine with its worker thread and, on CUDA, its stream:
    every call it runs (:meth:`submit`) runs in that thread with the
    replica's device current and its stream the current stream."""

    def __init__(self, engine, index: int):
        self.engine = engine
        self.device = engine.device
        self.remote = isinstance(engine, WorkerEngine)  # its ranks are worker processes
        cuda = self.device.type == "cuda" and not self.remote
        self.stream = torch.cuda.Stream(device=self.device) if cuda else None
        self._pool = concurrent.futures.ThreadPoolExecutor(1, thread_name_prefix=f"dp-replica-{index}")

    def _run(self, fn, args, kwargs):
        if self.stream is None:
            return fn(*args, **kwargs)
        with torch.cuda.device(self.device), torch.cuda.stream(self.stream):
            return fn(*args, **kwargs)

    def submit(self, fn, *args, **kwargs) -> concurrent.futures.Future:
        return self._pool.submit(self._run, fn, args, kwargs)

    def take(self, x):
        """``x`` (numpy or a tensor) for this replica: a host tensor (the
        replica's engine moves it in its own thread), or a CUDA tensor on the
        replica's device.  That one is read on the replica's stream only
        after the caller's work so far (a copy from another card included:
        it completes before the caller's current stream on this device goes
        on), and is kept alive for that stream (``record_stream``)."""
        if self.remote:
            return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
        if not isinstance(x, torch.Tensor):
            return torch.from_numpy(np.ascontiguousarray(x))
        if x.device.type == "cuda" and self.stream is not None:
            x = x.to(self.device)
            self.stream.wait_stream(torch.cuda.current_stream(self.device))
            x.record_stream(self.stream)
        return x

    def close(self) -> None:
        self._pool.shutdown(wait=True)
        if self.remote:
            self.engine.close()


def _gather(futures) -> list:
    return [f.result() for f in futures]


class DataParallelEngine:
    """Replica engines over a mesh's dp axis (module docstring).

    ``replicas`` are the single-device engines; ``mesh`` the params' mesh;
    ``params`` the sharded params.  ``host_syncs``, ``decode_steps`` and
    ``graph_captures`` are sums over the replicas."""

    # Whether a mesh's positions run in worker processes (module docstring).
    _in_workers = staticmethod(in_workers)

    def __init__(self, cls, params: ShardedParams, *args, mesh: Optional[Mesh] = None, **kwargs):
        if not isinstance(params, ShardedParams):
            raise NormaError(
                "DecodeEngine(mesh=...) needs params sharded over that mesh "
                "(norma_tpu_torch.parallel.shard_params)"
            )
        if mesh is not None and mesh != params.mesh:
            raise NormaError(f"mesh {mesh} is not the params' mesh {params.mesh}")
        self.mesh = params.mesh
        self.dp, self.tp = self.mesh.shape["dp"], self.mesh.shape["tp"]
        for a in list(args) + list(kwargs.values()):
            if isinstance(a, ShardedParams) and a.mesh != self.mesh:
                raise NormaError(f"params sharded over two meshes: {self.mesh} and {a.mesh}")
        self.params = params
        self.remote = self._in_workers(self.mesh)
        if self.tp > 1 and not self.remote and any(len(set(row)) > 1 for row in self.mesh.devices):
            raise NormaError(
                f"tp ranks over {[str(d) for d in self.mesh.devices.flat]}: a tp group is on one device (one "
                "process) or, with every rank of the mesh on its own card, one worker process a card"
            )
        self.replicas: List[_Replica] = []
        try:
            for i in range(self.dp):
                devs = list(self.mesh.devices[i])
                if self.remote:  # each worker takes its rank's shard of every sharded argument
                    pick = lambda a: RankList(a.ranks(i))  # noqa: E731
                elif self.tp > 1:  # every sharded argument over the one group of the position
                    group = LocalGroup(devs)
                    pick = lambda a: TPParams(a.ranks(i), list(range(self.tp)), group)  # noqa: E731
                else:
                    pick = lambda a: a.shard(i)  # noqa: E731
                a_i = tuple(pick(a) if isinstance(a, ShardedParams) else a for a in args)
                kw_i = {k: pick(v) if isinstance(v, ShardedParams) else v for k, v in kwargs.items()}
                if self.remote:
                    engine = WorkerEngine(cls, params.ranks(i), devs, a_i, kw_i)
                else:
                    engine = cls(pick(params), *a_i, **kw_i)
                self.replicas.append(_Replica(engine, i))
        except BaseException:
            self.close()
            raise

    # ------------------------------------------------------------------

    def __getattr__(self, name):
        # Everything not split over the replicas is the first replica's.
        if name == "replicas":
            raise AttributeError(name)
        return getattr(self.replicas[0].engine, name)

    @property
    def device(self) -> torch.device:
        return self.replicas[0].device

    @property
    def host_syncs(self) -> int:
        return sum(r.engine.host_syncs for r in self.replicas)

    @property
    def decode_steps(self) -> int:
        return sum(r.engine.decode_steps for r in self.replicas)

    @property
    def graph_captures(self) -> int:
        return sum(r.engine.graph_captures for r in self.replicas)

    def close(self) -> None:
        """Stop the replicas' threads and worker processes."""
        for r in getattr(self, "replicas", []):
            r.close()

    # ------------------------------------------------------------------

    def _split(self, B: int):
        """[(replica, row slice)]: B's rows over every replica when dp
        divides B, else all of them on the first replica."""
        if B % self.dp:
            return [(self.replicas[0], slice(0, B))]
        b = B // self.dp
        return [(r, slice(i * b, (i + 1) * b)) for i, r in enumerate(self.replicas)]

    def _rows(self, x, rep: _Replica, rows: slice, i: int):
        """Rows ``rows`` of ``x`` for ``rep``; a batch sharded over this mesh
        gives replica ``i`` its own piece (its rows divide over dp)."""
        if isinstance(x, ShardedBatch):
            if x.mesh != self.mesh:
                raise ValueError(f"a batch sharded over {x.mesh} given to an engine on {self.mesh}")
            return rep.take(x.pieces[i])
        return rep.take(x[rows])

    @staticmethod
    def _batch(x) -> int:
        return int(x.shape[0])

    def _map(self, method: str, x, *per_row, window: bool = False, n_active: Optional[int] = None):
        """Call ``method`` of every replica engine on its rows of ``x`` and
        of each per-row argument (an array; anything else passes whole), in
        the replicas' threads at once; returns [(replica, future)].  A
        ``window`` call also gets its share of the ``n_active`` leading
        rows."""
        parts = self._split(self._batch(x))
        out = []
        for i, (rep, rows) in enumerate(parts):
            args = [self._rows(x, rep, rows, i)]
            args += [a[rows] if isinstance(a, np.ndarray) else a for a in per_row]
            kw = {}
            if window:
                n = rows.stop - rows.start
                kw["n_active"] = None if n_active is None else min(max(n_active - rows.start, 0), n)
            out.append((rep, rep.submit(getattr(rep.engine, method), *args, **kw)))
        return out

    @staticmethod
    def _merge_windows(results):
        """Concatenate replicas' ``(results, info)`` window outputs."""
        drs, langs, probs = [], [], []
        for d, info in results:
            drs += d
            langs.append(np.asarray(info["langs"]))
            probs.append(info["lang_probs"])
        if all(p is None for p in probs):
            lang_probs = None
        else:  # a replica whose rows asked no detection has no probabilities
            L = next(p for p in probs if p is not None).shape[1]
            lang_probs = np.concatenate(
                [p if p is not None else np.zeros((len(l), L), np.float32) for p, l in zip(probs, langs)]
            )
        return drs, {"langs": np.concatenate(langs), "lang_probs": lang_probs}

    def _langs(self, audio, langs):
        return np.broadcast_to(np.asarray(langs, np.int32).reshape(-1), (self._batch(audio),))

    # ------------------------------------------------------------------
    # Window entry points
    # ------------------------------------------------------------------

    def transcribe_window(self, audio, langs, seed: int, n_active: Optional[int] = None):
        parts = self._map("transcribe_window", audio, self._langs(audio, langs), seed, window=True, n_active=n_active)
        return self._merge_windows(_gather(f for _, f in parts))

    def transcribe_window_async(self, audio, langs, seed: int, n_active: Optional[int] = None):
        """Start every replica's window, in the replicas' threads at once;
        it returns once each replica has queued its window graph (a
        replica's dispatch, in this process or in its workers, returns
        before its device work).  :meth:`transcribe_window_fetch`
        completes them."""
        parts = self._map("transcribe_window_async", audio, self._langs(audio, langs), seed, window=True,
                          n_active=n_active)
        return [(rep, f.result()) for rep, f in parts]

    def transcribe_window_fetch(self, pending):
        fetches = [rep.submit(rep.engine.transcribe_window_fetch, p) for rep, p in pending]
        return self._merge_windows(_gather(fetches))

    def detect_language(self, feats) -> np.ndarray:
        return np.concatenate(_gather(f for _, f in self._map("detect_language", feats)))

    def _state(self, parts):
        """A dp prefill state: each replica's own state, and the fields a
        caller reads (``prefix``, ``B``, ``no_speech_prob``) over all rows."""
        states = _gather(f for _, f in parts)
        return dict(
            prefix=np.concatenate([s["prefix"] for s in states]),
            B=sum(s["B"] for s in states),
            no_speech_prob=np.concatenate([s["no_speech_prob"] for s in states]),
            parts=[(rep, s) for (rep, _), s in zip(parts, states)],
        )

    def _lang_rows(self, lang_token, B):
        """A per-stream language sequence as an array (split with the rows);
        None or one token passes whole."""
        if lang_token is None or np.ndim(lang_token) == 0:
            return lang_token
        return np.broadcast_to(np.asarray(lang_token, np.int32).reshape(-1), (B,))

    def prefill(self, feats, lang_token):
        return self._state(self._map("prefill", feats, self._lang_rows(lang_token, self._batch(feats))))

    def prefill_window(self, audio, lang_token):
        return self._state(self._map("prefill_window", audio, self._lang_rows(lang_token, self._batch(audio))))

    def run_loop(self, state, temperature: float, seed: int):
        futures = [rep.submit(rep.engine.run_loop, s, temperature, seed) for rep, s in state["parts"]]
        return [r for part in _gather(futures) for r in part]

    # Host-side entry points of the single-device engine that reach the
    # device only through the split methods above, reused as they are.
    decode_with_fallback = DecodeEngine.decode_with_fallback
    decode_with_fallback_windowed = DecodeEngine.decode_with_fallback_windowed
    _fallback_from_state = DecodeEngine._fallback_from_state
    decode = DecodeEngine.decode

    def warmup_fallback(self, batch: int = 1) -> None:
        """A speculative replica's t>0 fallback warmed at its share of
        ``batch`` rows (nothing for plain replicas)."""
        if not hasattr(self.replicas[0].engine, "warmup_fallback"):
            return
        parts = self._split(batch)
        _gather(rep.submit(rep.engine.warmup_fallback, rows.stop - rows.start) for rep, rows in parts)

