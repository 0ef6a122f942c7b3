"""Device meshes and the Whisper params' layout over them
(``norma_tpu/parallel/sharding.py``).

  - :class:`Mesh` / :func:`make_mesh` — a ``[dp, tp]`` array of devices
    with the axis names ``("dp", "tp")``: a data-parallel axis over
    concurrent streams, a tensor-parallel axis over heads and FFN columns
  - :func:`param_shardings` — the partition spec of every leaf (the
    Megatron table of the JAX package), as a tuple of axis names
  - :func:`shard_params` — :class:`ShardedParams`: one ``Params`` per mesh
    position, on that position's device (on the host where the position's
    rank runs in a worker process, :func:`in_workers`), holding its tp
    slice
  - :func:`batch_sharding` / :func:`shard_batch` — the leading (stream)
    axis split over ``dp``

A mesh may name one device more than once: these are virtual devices, the
counterpart of the JAX tests' forced CPU devices.  ``make_mesh(dp=2,
devices=["cpu", "cpu"])`` is a dp mesh on the CPU, ``devices=["cuda:0",
"cuda:0"]`` two replicas on one card.  Positions on the device that
already holds a tensor share it (``.to`` copies nothing there).

``DecodeEngine`` runs sharded params as one engine per dp position
(``parallel/data_parallel.py``), each over that position's tp shards
(:meth:`ShardedParams.ranks`): one engine over every rank where the ranks
share a device, one worker process per card where a tp group spans
distinct cards (:func:`in_workers`, ``parallel/workers.py``).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..model.load import Params

AXES = ("dp", "tp")
Spec = Tuple[Optional[str], ...]


class Mesh:
    """A ``[dp, tp]`` array of ``torch.device`` (``devices``, a numpy object
    array) with ``axis_names`` ``("dp", "tp")``; ``shape`` is the dict
    ``{"dp": dp, "tp": tp}``, as a JAX mesh's is."""

    axis_names = AXES

    def __init__(self, devices):
        arr = np.asarray(devices, dtype=object)
        if arr.ndim != 2:
            raise ValueError(f"a mesh is a [dp, tp] array of devices, got shape {arr.shape}")
        self.devices = arr

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(AXES, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def __eq__(self, other) -> bool:
        return isinstance(other, Mesh) and self.devices.shape == other.devices.shape and all(
            a == b for a, b in zip(self.devices.flat, other.devices.flat)
        )

    def __hash__(self) -> int:
        return hash((self.devices.shape, tuple(str(d) for d in self.devices.flat)))

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, devices={[str(d) for d in self.devices.flat]})"


def _device(d) -> torch.device:
    """A device; a bare "cuda" names the first card."""
    d = torch.device(d)
    return torch.device("cuda", 0) if d.type == "cuda" and d.index is None else d


def make_mesh(dp: int = 1, tp: int = 1, devices: Optional[Sequence] = None) -> Mesh:
    """A ``dp x tp`` mesh over the first ``dp * tp`` of ``devices`` (default:
    every card, ``cuda:0 .. cuda:n-1``; there is no CPU default).  A list
    may name a device more than once: virtual devices, e.g.
    ``["cuda:0", "cuda:0"]`` for two replicas on one card."""
    if devices is None:
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [_device(d) for d in devices]
    if dp < 1 or tp < 1:
        raise ValueError(f"mesh axes must be >= 1, got dp={dp} tp={tp}")
    if dp * tp > len(devices):
        raise ValueError(f"mesh {dp}x{tp} needs {dp * tp} devices, have {len(devices)}")
    arr = np.empty(dp * tp, dtype=object)
    arr[:] = devices[: dp * tp]
    return Mesh(arr.reshape(dp, tp))


# Megatron-style tensor parallelism over the stacked-layer tree.  Keys are
# leaf names inside a layer dict; specs include the leading L axis.
_COL = ("q_w", "k_w", "v_w", "xq_w", "xk_w", "xv_w", "fc1_w")  # shard out-dim
_COL_B = ("q_b", "v_b", "xq_b", "xv_b", "fc1_b")  # shard bias
_ROW = ("o_w", "xo_w", "fc2_w")  # shard in-dim
# Fused QKV [L, D, 3, D]: the LAST axis keeps head sharding for q, k and v
# at once (axis 2 says which projection).
_QKV_W: Spec = (None, None, None, "tp")
_QKV_B: Spec = (None, None, "tp")  # [L, 3, D]


def _layer_leaf_spec(name: str) -> Spec:
    # int8 leaves (quantize_decoder): name_q shards like the base weight;
    # name_s is per output channel and follows the out dim.
    if name in ("qkv_w", "qkv_w_q"):
        return _QKV_W
    if name in ("qkv_b", "qkv_w_s"):
        return _QKV_B
    if name.endswith("_q"):
        base = name[:-2]
        if base in _COL:
            return (None, None, "tp")
        if base in _ROW:
            return (None, "tp", None)
    if name.endswith("_s"):
        base = name[:-2]
        if base in _COL:
            return (None, "tp")
        if base in _ROW:
            return ()  # scales over the unsharded out dim: replicated
    if name in _COL:
        return (None, None, "tp")
    if name in _COL_B:
        return (None, "tp")
    if name in _ROW:
        return (None, "tp", None)
    return ()  # LayerNorm params, o_b / fc2_b: replicated


def _leaf_spec(keys: Tuple[str, ...]) -> Spec:
    if "layers" in keys:
        return _layer_leaf_spec(keys[-1])
    if "tok_emb_q8" in keys:
        # The int8 head's vocab axis over tp: q [D, V], s [V].
        return (None, "tp") if keys[-1] == "q" else ("tp",)
    if "tok_emb_q4" in keys:
        # Replicated: int4 stays a single-card memory lever, as in the JAX
        # package (its head runs as a custom call GSPMD cannot partition).
        return ()
    if keys[-1] == "tok_emb":
        # Row-parallel tied embedding, D over tp: each rank streams D/tp of
        # the logits head and the [B, V] partials are summed.
        return (None, "tp")
    return ()  # conv weights, positions, final LayerNorm: replicated


def _items(tree):
    return tree.items() if isinstance(tree, (dict, Params)) else ()


def _map(tree, fn, path=()):
    """A nested dict with ``fn(path, leaf)`` at every leaf."""
    return {
        k: _map(v, fn, path + (k,)) if isinstance(v, (dict, Params)) else fn(path + (k,), v)
        for k, v in _items(tree)
    }


def param_shardings(params, mesh: Mesh):
    """The partition spec of every leaf of ``params``, as a nested dict of
    the same keys: a tuple naming, per axis, the mesh axis it is split
    over (None: not split; ``()``: replicated), as JAX's
    ``NamedSharding(mesh, spec).spec`` does."""
    del mesh  # the table does not depend on the mesh's sizes
    return _map(params, lambda path, leaf: _leaf_spec(path))


def split_sizes(n: int, tp: int) -> List[int]:
    """The sizes of ``n`` split over ``tp`` as GSPMD pads an axis tp does not
    divide: ceil-sized shards, the last one short (51866 over 4: 12967 x 3
    and 12965)."""
    c = -(-n // tp)
    return [max(min(c, n - j * c), 0) for j in range(tp)]


def _ragged(keys: Tuple[str, ...]) -> bool:
    """Whether a leaf's tp axis may split unevenly: the int8 head's vocab."""
    return "tok_emb_q8" in keys


def _slice(t: torch.Tensor, spec: Spec, mesh: Mesh, j: int, ragged: bool = False) -> torch.Tensor:
    """Position ``j`` of the tp axis's slice of ``t`` under ``spec``; an axis
    tp does not divide splits only where ``ragged`` (:func:`split_sizes`)."""
    tp = mesh.shape["tp"]
    if tp == 1 or "tp" not in spec:
        return t
    ax = spec.index("tp")
    if t.shape[ax] % tp and not ragged:
        raise ValueError(f"axis {ax} of size {t.shape[ax]} does not split over tp={tp}")
    sizes = split_sizes(t.shape[ax], tp)
    return t.narrow(ax, sum(sizes[:j]), sizes[j]).contiguous()


def in_workers(mesh: Mesh) -> bool:
    """Whether ``mesh``'s tp ranks run in worker processes, one a card: a tp
    above 1 over distinct cards (NCCL takes one rank a process).  Every
    other mesh runs in this process, dp of tp 1 on distinct cards in
    threads, which run the replicas' windows at once (each is one CUDA
    graph replay; PERF.md section 6)."""
    devs = list(mesh.devices.flat)
    return mesh.shape["tp"] > 1 and len(set(devs)) == len(devs) and all(d.type == "cuda" for d in devs)


class ShardedParams:
    """Params laid out over a mesh: ``shard(i, j)`` is the ``Params`` of
    mesh position (dp i, tp j) holding its tp slice of every leaf (the whole
    leaf where tp is 1 or the leaf is replicated), on that position's
    device -- or on the host where :func:`in_workers`: each worker process
    puts its own shard on its card, so a card holds it once; ``specs`` is
    :func:`param_shardings`'s tree."""

    def __init__(self, mesh: Mesh, specs, shards: List[Params]):
        if len(shards) != mesh.size:
            raise ValueError(f"{len(shards)} shards for a mesh of {mesh.size} positions")
        self.mesh = mesh
        self.specs = specs
        self._shards = list(shards)

    def shard(self, i: int, j: int = 0) -> Params:
        return self._shards[i * self.mesh.shape["tp"] + j]

    def replicas(self) -> List[Params]:
        """One full ``Params`` per dp position (tp must be 1)."""
        if self.mesh.shape["tp"] != 1:
            raise ValueError(
                f"params split over tp={self.mesh.shape['tp']} have no full replicas: "
                "ranks(i) gives dp position i's tp shards"
            )
        return list(self._shards)

    def ranks(self, i: int) -> List[Params]:
        """dp position ``i``'s tp shards, in rank order."""
        tp = self.mesh.shape["tp"]
        return self._shards[i * tp:(i + 1) * tp]

    @property
    def device(self) -> torch.device:
        """The first position's device."""
        return self.mesh.devices[0, 0]

    def devices(self) -> List[torch.device]:
        """Every mesh position's device, in mesh order (a device named twice
        counts twice)."""
        return list(self.mesh.devices.flat)


def shard_params(params, mesh: Mesh) -> ShardedParams:
    """``params`` laid out over ``mesh`` (:class:`ShardedParams`).  A
    position on the device that already holds a leaf shares it: ``.to``
    copies nothing there."""
    specs = param_shardings(params, mesh)
    dp, tp = mesh.shape["dp"], mesh.shape["tp"]
    host = in_workers(mesh)
    shards = []
    for i in range(dp):
        for j in range(tp):
            dev = torch.device("cpu") if host else mesh.devices[i, j]
            shards.append(Params(_map(
                params, lambda path, t: _slice(t, _leaf_spec(path), mesh, j, _ragged(path)).to(dev)
            )))
    return ShardedParams(mesh, specs, shards)


def batch_sharding(mesh: Mesh, ndim: int) -> Spec:
    """The spec of a batch: the leading (stream) axis over ``dp``, the rest
    whole."""
    del mesh
    return ("dp",) + (None,) * (ndim - 1)


class ShardedBatch:
    """A batch split over a mesh's dp axis: ``pieces[i]`` holds rows
    ``[i*b, (i+1)*b)`` on dp position i's device (tp positions of a row
    hold the same rows)."""

    def __init__(self, mesh: Mesh, pieces: Sequence[torch.Tensor]):
        self.mesh = mesh
        self.pieces = list(pieces)

    @property
    def shape(self) -> Tuple[int, ...]:
        return (sum(p.shape[0] for p in self.pieces),) + tuple(self.pieces[0].shape[1:])


def shard_batch(x, mesh: Mesh) -> ShardedBatch:
    """``x`` (numpy or tensor) split row-wise over ``dp``; the row count must
    divide."""
    t = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(x))
    dp = mesh.shape["dp"]
    if t.shape[0] % dp:
        raise ValueError(f"a batch of {t.shape[0]} rows does not split over dp={dp}")
    b = t.shape[0] // dp
    return ShardedBatch(mesh, [t[i * b:(i + 1) * b].to(mesh.devices[i, 0]) for i in range(dp)])
