"""Kernel wrappers: each launches a hand-written CUDA kernel on CUDA
tensors and runs its plain PyTorch version on CPU tensors."""

from __future__ import annotations

import functools

import torch


def _tensors(args):
    for a in args:
        if isinstance(a, torch.Tensor):
            yield a
        elif isinstance(a, dict):
            yield from _tensors(a.values())
        elif isinstance(a, (list, tuple)):
            yield from _tensors(a)


def inference_only(fn):
    """Run a kernel wrapper without autograd, and refuse a gradient.

    The kernels have no backward (neither have the JAX package's Pallas
    kernels), so a wrapper called with grad enabled on a tensor that
    requires grad raises instead of returning a result detached from the
    graph, on either device: a gradient is never served quietly by the
    plain version.  Fits run the plain routes (``model/whisper.py``
    without the kernel knobs)."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        if torch.is_grad_enabled() and any(
            t.requires_grad for t in _tensors((args, kwargs))
        ):
            raise RuntimeError(
                f"{fn.__name__}: the kernel has no backward; run the plain route "
                "(the config without kernel knobs) to differentiate"
            )
        with torch.no_grad():
            return fn(*args, **kwargs)

    return wrapper


def launch_counters() -> dict:
    """The wrappers of the kernels the engines run, by kernel name, each
    with its ``launches`` counter (what a path reads to show it ran its
    kernels)."""
    from . import flash_encoder, paged_cross, quant_matmul, sample_step, self_decode

    return {
        "sample_step": sample_step.sample_step, "self_decode": self_decode.self_attention_decode,
        "cross_decode": paged_cross.cross_attention_q8_kernel_stacked,
        "flash_encoder": flash_encoder.flash_self_attention, "q8a8": quant_matmul.q8a8_dense,
        "w8_matmul": quant_matmul.w8_matmul, "w4_matmul": quant_matmul.w4_matmul,
    }
