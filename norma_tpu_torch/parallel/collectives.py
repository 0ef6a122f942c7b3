"""Collectives over a tensor-parallel group, and the loop that runs a
process's ranks through the layer code in lockstep (the reductions GSPMD
inserts for the JAX package's tp-sharded params).

A :class:`TPGroup` holds the ranks of one tp group that live in this
process.  Each collective takes the list of those ranks' tensors, in rank
order, and returns the list of their results:

  - :meth:`TPGroup.all_reduce_sum` -- f32 sums (the row-parallel partials);
  - :meth:`TPGroup.all_reduce_max` -- maxima (row amax of split rows);
  - :meth:`TPGroup.all_gather` -- the shards concatenated along ``dim``,
    ``sizes`` giving every rank's width (ragged for a vocabulary tp does
    not divide).

:class:`LocalGroup` holds every rank in this process, all on one device
(virtual devices: the CPU, or one card named several times).  It combines
the tensors in rank order once and hands every rank the result (the same
tensor: results are read, never written in place).  :class:`ProcessGroup`
holds one rank of a group whose ranks are processes, one a card
(``parallel/workers.py``), over ``torch.distributed``: NCCL for CUDA
tensors, gloo for the CPU, on a ``FileStore`` in a directory the caller
gives.  The mesh's devices pick the group (``parallel/data_parallel.py``),
never a failure.

:func:`lockstep` drives one layer generator per local rank
(``model/whisper.py``: ``_encode``, ``_decoder_prefill``,
``_decoder_step``, ...) to the end, meeting the ranks' requests with the
group's collectives.
"""

from __future__ import annotations

import datetime
import time
from dataclasses import dataclass
from typing import List, Sequence

import torch

from ..errors import NormaError


@dataclass(frozen=True)
class Rank:
    """A rank's place on the tp axis, as the layer code reads it."""

    index: int
    size: int


class RankList(list):
    """One value per local rank, in rank order (an engine's per-rank
    caches, cross-K/V, params); anything else an engine passes to the layer
    code is shared by its ranks."""


def first(x):
    """Local rank 0's value of a :class:`RankList`, or ``x``."""
    return x[0] if isinstance(x, RankList) else x


def unzip(x):
    """A :class:`RankList` of tuples as a tuple of RankLists (``x`` as it
    is otherwise)."""
    if isinstance(x, RankList) and x and isinstance(x[0], tuple):
        return tuple(RankList(v) for v in zip(*x))
    return x


def per_rank(fn, *args):
    """``fn`` on each rank's arguments when any is a :class:`RankList`
    (results unzipped), else ``fn(*args)``."""
    n = next((len(a) for a in args if isinstance(a, RankList)), None)
    if n is None:
        return fn(*args)
    pick = lambda a, i: a[i] if isinstance(a, RankList) else a
    return unzip(RankList(fn(*(pick(a, i) for a in args)) for i in range(n)))


@dataclass
class TPParams:
    """The shards of the tp ranks one engine runs in this process:
    ``shards[k]`` is rank ``ranks[k]``'s ``Params``; ``group`` their
    :class:`TPGroup` (``group.size`` is the tp)."""

    shards: list
    ranks: List[int]
    group: "TPGroup"

    @property
    def device(self) -> torch.device:
        return self.shards[0].device

    def devices(self) -> List[torch.device]:
        """Each local rank's device (one position each)."""
        return [s.device for s in self.shards]


class TPGroup:
    """The ranks of one tp group that this process holds (module
    docstring).  ``size`` is the group's tp."""

    size: int
    collectives = 0  # collectives run (each counts once for the process's ranks)

    def all_reduce_sum(self, ts: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        raise NotImplementedError

    def all_reduce_max(self, ts: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        raise NotImplementedError

    def all_gather(self, ts: Sequence[torch.Tensor], dim: int, sizes: Sequence[int]) -> List[torch.Tensor]:
        raise NotImplementedError

    def run(self, op: str, ts: Sequence[torch.Tensor], **kw) -> List[torch.Tensor]:
        """One collective by name: "sum", "max", or "gather" (``dim``, and
        ``total``, the gathered width, split as ``parallel.sharding.
        split_sizes`` splits it)."""
        from .sharding import split_sizes

        self.collectives += 1
        if op == "sum":
            return self.all_reduce_sum(ts)
        if op == "max":
            return self.all_reduce_max(ts)
        if op == "gather":
            return self.all_gather(ts, kw["dim"], split_sizes(kw["total"], self.size))
        raise ValueError(f"unknown collective {op!r}")


class LocalGroup(TPGroup):
    """Every rank of the group in this process, on one device."""

    def __init__(self, devices: Sequence):
        devs = {torch.device(d) for d in devices}
        if len(devs) != 1:
            raise NormaError(f"a LocalGroup's ranks share one device, got {sorted(map(str, devs))}")
        self.device = devs.pop()
        self.size = len(devices)

    def _check(self, ts):
        if len(ts) != self.size:
            raise ValueError(f"{len(ts)} tensors for a group of {self.size} ranks")

    def all_reduce_sum(self, ts):
        self._check(ts)
        s = ts[0]
        for t in ts[1:]:
            s = s + t
        return [s] * self.size

    def all_reduce_max(self, ts):
        self._check(ts)
        m = ts[0]
        for t in ts[1:]:
            m = torch.maximum(m, t)
        return [m] * self.size

    def all_gather(self, ts, dim, sizes):
        self._check(ts)
        got = [t.shape[dim] for t in ts]
        if got != list(sizes):
            raise ValueError(f"shard widths {got} along dim {dim}, expected {list(sizes)}")
        return [torch.cat(list(ts), dim=dim)] * self.size


class ProcessGroup(TPGroup):
    """Rank ``rank`` of ``size`` processes over ``torch.distributed`` (NCCL
    on a card, gloo on the CPU), rendezvous on a ``FileStore`` at
    ``store_path``.  The communicator is set up by a first collective here,
    so it is warm before any CUDA graph capture.  A collective that waits
    ``timeout_s`` for a peer fails the process (the parent then raises).

    Every collective is synchronous, so NCCL runs it on the current stream
    (no side stream, event or ``record_stream``), and does no host-side
    work beyond its launch: no read, no event query, and no allocation but
    the gather's one output buffer, which a capture takes from its pool.  A
    window graph's WHILE bodies capture them as they capture kernels.

    The workers run NCCL without its support for mixing graph and eager
    launches (``parallel/workers.py``, ``WORKER_ENV``).  NCCL then supports
    no collective launched outside a graph while a graph that holds the
    communicator's collectives is in flight, whatever the streams' order.
    So the engine reports each such graph it replays
    (:meth:`graph_launched`), and a collective outside a capture first
    waits until those graphs are done (at most ``timeout_s``).  A rank
    replays its graphs on one stream, so no two of them run at once."""

    def __init__(self, rank: int, size: int, device, store_path: str, timeout_s: float = 180.0):
        import torch.distributed as dist

        self.device = torch.device(device)
        self.size, self.rank = size, rank
        backend = "nccl" if self.device.type == "cuda" else "gloo"
        store = dist.FileStore(store_path, size)
        kw = {"device_id": self.device} if backend == "nccl" else {}
        dist.init_process_group(
            backend, store=store, rank=rank, world_size=size,
            timeout=datetime.timedelta(seconds=timeout_s), **kw,
        )
        self._dist = dist
        self._timeout_s = timeout_s
        self._graphs: list = []  # done events of graphs in flight (graph_launched)
        # all_gather_into_tensor, renamed all_gather_single in newer torch
        self._gather_into = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
        warm = torch.ones(1, device=self.device)
        dist.all_reduce(warm)  # NCCL creates its communicator here, outside any capture
        if int(warm.item()) != size:
            raise NormaError(f"tp group of {size}: the first all-reduce gave {warm.item()}")

    def graph_launched(self, done) -> None:
        """Note a replayed graph that holds this group's collectives;
        ``done`` is an event recorded after it (class docstring)."""
        self._graphs = [e for e in self._graphs if not e.query()] + [done]

    def _quiet(self) -> None:
        """Wait until the graphs in flight are done, before a collective
        outside a capture; a graph not done in ``timeout_s`` raises (its
        ranks would wait on each other inside it)."""
        if not self._graphs or (self.device.type == "cuda" and torch.cuda.is_current_stream_capturing()):
            return  # a captured collective launches nothing now
        t0 = time.monotonic()
        while self._graphs:
            if self._graphs[0].query():
                self._graphs.pop(0)
            elif time.monotonic() - t0 > self._timeout_s:
                raise NormaError(f"rank {self.rank}: a graph with this group's collectives is not done after "
                                 f"{self._timeout_s:g} s; no collective outside a graph may start before it ends")
            else:
                time.sleep(0.0002)

    def all_reduce_sum(self, ts):
        (t,) = ts
        self._quiet()
        self._dist.all_reduce(t)
        return [t]

    def all_reduce_max(self, ts):
        (t,) = ts
        self._quiet()
        self._dist.all_reduce(t, op=self._dist.ReduceOp.MAX)
        return [t]

    def all_gather(self, ts, dim, sizes):
        """The shards along ``dim``: every rank sends the widest shard's rows
        (a narrower one padded with zeros) into one [size * widest, ...]
        buffer, which a ragged split then narrows to each rank's rows."""
        (t,) = ts
        if t.shape[dim] != sizes[self.rank]:
            raise ValueError(f"rank {self.rank}'s shard is {t.shape[dim]} wide along dim {dim}, "
                             f"expected {sizes[self.rank]}")
        w = max(sizes)
        x = t.movedim(dim, 0)
        if x.shape[0] < w:
            x = torch.cat([x, x.new_zeros((w - x.shape[0],) + tuple(x.shape[1:]))])
        x = x.contiguous()
        out = x.new_empty((self.size * w,) + tuple(x.shape[1:]))
        self._quiet()
        self._gather_into(out, x)
        if any(n != w for n in sizes):
            out = torch.cat([out[k * w:k * w + n] for k, n in enumerate(sizes)])
        return [out.movedim(0, dim).contiguous()]

    def close(self) -> None:
        if self._dist.is_initialized():
            self._dist.destroy_process_group()


def lockstep(group: TPGroup, gens: Sequence) -> list:
    """Run one layer generator per local rank to its end, in rank order,
    meeting every request (``(op, tensor, kwargs)``) with ``group``'s
    collective; returns each generator's value.  The ranks must make the
    same requests in the same order: a rank that ends early or asks for
    another collective raises (they would deadlock across processes)."""
    gens = list(gens)
    sends: list = [None] * len(gens)
    while True:
        reqs, done = [], []
        for i, g in enumerate(gens):
            try:
                reqs.append(g.send(sends[i]))
            except StopIteration as stop:
                done.append(stop.value)
        if len(done) == len(gens):
            return done
        if done or len({(r[0], tuple(sorted(r[2].items()))) for r in reqs}) != 1:
            raise NormaError(f"tp ranks diverged: {[r[0] for r in reqs]} with {len(done)} finished")
        sends = group.run(reqs[0][0], [r[1] for r in reqs], **reqs[0][2])
