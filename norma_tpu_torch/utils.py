"""Small host-side helpers (``norma_tpu/utils.py``): where a params tree
lives (the mesh helpers, :func:`params_platform` ..
:func:`np_devices`), and the segment helpers."""

from __future__ import annotations

from typing import Callable, Iterator, List, Sequence, TypeVar

import torch

T = TypeVar("T")


def _leaves(tree) -> Iterator[object]:
    """Every leaf of a params tree: tensors and numpy arrays, and each
    sharded tree (``parallel.ShardedParams``, a tp engine's
    ``parallel.collectives.TPParams``) as one leaf-spanning unit."""
    from .parallel.collectives import TPParams
    from .parallel.sharding import ShardedParams

    if isinstance(tree, (ShardedParams, TPParams)):
        yield tree
    elif hasattr(tree, "items"):  # a dict or a Params
        for _, v in tree.items():
            yield from _leaves(v)
    else:
        yield tree


def default_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; None names the card where there is
    one, else the CPU -- the port's entry points run on the card unless
    asked for the CPU."""
    if device is not None:
        return torch.device(device)
    return torch.device("cuda" if torch.cuda.is_available() else "cpu")


def params_platform(params) -> str:
    """The device type a computation over ``params`` runs on: that of the
    first tensor leaf (``"cuda"``, ``"cpu"``; a sharded tree's first
    position); for a host-side (numpy) tree, ``"cuda"`` where there is a
    card, else ``"cpu"`` -- the port's entry points run on the card unless
    asked for the CPU."""
    for leaf in _leaves(params):
        device = getattr(leaf, "device", None)
        if isinstance(device, torch.device):
            return device.type
    return default_device().type


def params_device_count(params) -> int:
    """Mesh positions the params span (1 for unsharded): dp x tp of sharded
    params, the local ranks of a tp engine's shards.  Positions, not
    distinct devices, so virtual devices (one card named twice) count.

    Takes the MAXIMUM over all leaves, not the first one that answers: with
    heterogeneous placement (a small unsharded leaf beside weights that
    span the mesh) the first leaf could report 1."""
    n = 1
    for leaf in _leaves(params):
        devices = getattr(leaf, "devices", None)
        if callable(devices):
            n = max(n, len(devices()))
    return n


def params_replicated_on_mesh(params, mesh) -> bool:
    """True when every leaf is whole on every position of ``mesh``: params
    sharded over exactly this mesh whose tp is 1 (pure data parallelism:
    each dp replica engine holds the full weights).  A plain tensor counts
    only on a one-position mesh of its own device."""
    saw = False
    for leaf in _leaves(params):
        if not isinstance(leaf, torch.Tensor) and not hasattr(leaf, "mesh"):
            continue
        saw = True
        if hasattr(leaf, "mesh"):
            if leaf.mesh != mesh or mesh.shape["tp"] != 1:
                return False
        elif np_devices(mesh) != [leaf.device]:
            return False
    return saw


def np_devices(mesh) -> list:
    """The mesh's devices, flat, in mesh order."""
    return list(mesh.devices.flat)


def inclusive_segments(
    seq: Sequence[T], pred: Callable[[T], bool]
) -> Iterator[Sequence[T]]:
    """Yield sub-slices of ``seq`` bounded inclusively by ``pred`` matches.

    Consecutive segments do not share boundary elements: for boundaries
    b0, b1, b2 the segments are ``[b0..b1]`` and then ``[b2..b3]`` (the
    search restarts *after* each segment's closing boundary).
    """
    i = 0
    n = len(seq)
    while i < n:
        start = None
        for j in range(i, n):
            if pred(seq[j]):
                start = j
                break
        if start is None:
            return
        end = None
        for j in range(start + 1, n):
            if pred(seq[j]):
                end = j
                break
        if end is None:
            return
        yield seq[start : end + 1]
        i = end + 1


def segments_list(seq: Sequence[T], pred: Callable[[T], bool]) -> List[Sequence[T]]:
    return list(inclusive_segments(seq, pred))
