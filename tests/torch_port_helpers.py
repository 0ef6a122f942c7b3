"""Shared helpers for the norma_tpu_torch parity tests (tests/test_torch_*.py).

The port is held against the JAX package on the CPU: the same numpy inputs
and the same weights (JAX params -> numpy -> ``params_from_numpy``) go
through both.  Torch threads are capped because tier-1 runs several
pytest-xdist workers side by side.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

torch.set_num_threads(2)

import jax  # noqa: E402

from norma_tpu_torch.decode.masks import SpecialTokens as PortSpecialTokens  # noqa: E402
from norma_tpu_torch.model.config import WhisperConfig as PortConfig  # noqa: E402
from norma_tpu_torch.model.load import params_from_numpy  # noqa: E402


def port_cfg(cfg) -> PortConfig:
    """A JAX-package WhisperConfig as the port's (same field set)."""
    return PortConfig(**dataclasses.asdict(cfg))


def port_st(st) -> PortSpecialTokens:
    return PortSpecialTokens(**dataclasses.asdict(st))


def to_numpy_tree(params):
    """JAX params -> numpy: floating leaves as f32 (bf16 widened exactly),
    integer leaves (int8 codes) as they are."""

    def leaf(a):
        a = np.asarray(a)
        return a if a.dtype.kind in "iub" else a.astype(np.float32)

    return jax.tree.map(leaf, params)


def port_params(jax_params, dtype=torch.float32):
    """The JAX package's params as the port's, on the CPU."""
    return params_from_numpy(to_numpy_tree(jax_params), "cpu", dtype)


def port_tree_numpy(params):
    """The port's Params as nested f32 numpy arrays."""
    return {
        k: port_tree_numpy(v) if isinstance(v, torch.nn.Module) else n(v)
        for k, v in params.items()
    }


def t(a, dtype=None) -> torch.Tensor:
    """numpy (or a JAX array) -> CPU tensor."""
    x = torch.from_numpy(np.array(a))
    return x if dtype is None else x.to(dtype)


def n(x) -> np.ndarray:
    """CPU tensor or JAX array -> f32 numpy (bf16 widened)."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        return (x.float() if x.is_floating_point() else x).numpy()
    a = np.asarray(x)
    return a if a.dtype.kind in "iub" else a.astype(np.float32)
