"""Flash attention for the encoder's self-attention
(``norma_tpu/ops/flash_encoder.py``).

The plain encoder attention materializes a [B, H, T, T] score tensor per
layer (T = 1500); the kernel keeps score tiles on chip.

  - :func:`flash_attention_torch` — the plain PyTorch version (the CPU
    path and the kernel's oracle): f32 logits from the input-dtype
    operands times dh**-0.5, an exact f32 softmax, p rounded to the input
    dtype for the PV product with f32 accumulation;
  - :func:`flash_self_attention` — the wrapper: the CUDA kernel
    (``csrc/flash_encoder.cu``, online softmax over 64-key tiles, bounds
    masks at T instead of padding) for CUDA tensors, the plain version for
    CPU tensors; any other device raises.
    ``flash_self_attention.launches`` counts kernel launches.  It serves
    both ``encoder_attn_impl="flash"`` and ``"jax_flash"``, the JAX
    package's ``flash_self_attention`` and ``jax_flash_self_attention``
    (whose TPU tile sizes have no counterpart here).

q/k/v are [B, T, D] projected inputs, read through their batch and row
strides (the fused QKV projection's slices need no copy); the output is a
contiguous [B, T, D] in the input dtype.
"""

from __future__ import annotations

import torch

from . import _build

_DTYPES = (torch.float32, torch.bfloat16)
_KERNEL_HEAD_DIM = 64


def _validate(q, k, v, n_heads):
    if q.dim() != 3 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(
            f"q, k, v must be [B, T, D] of one shape, got {tuple(q.shape)}, "
            f"{tuple(k.shape)}, {tuple(v.shape)}"
        )
    if {q.dtype, k.dtype, v.dtype} != {q.dtype} or q.dtype not in _DTYPES:
        raise TypeError(f"q, k, v must share one dtype of {_DTYPES}")
    if len({q.device, k.device, v.device}) != 1:
        raise ValueError("q, k, v must be on one device")
    if q.shape[2] % n_heads:
        raise ValueError(f"d_model {q.shape[2]} not divisible by n_heads {n_heads}")


@torch.no_grad()
def flash_attention_torch(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, n_heads: int
) -> torch.Tensor:
    """Plain version -> [B, T, D] in q's dtype."""
    _validate(q, k, v, n_heads)
    B, T, D = q.shape
    dh = D // n_heads
    heads = lambda x: x.reshape(B, T, n_heads, dh).transpose(1, 2).float()
    logits = torch.matmul(heads(q), heads(k).transpose(-1, -2)) * float(dh) ** -0.5
    p = torch.exp(logits - logits.amax(-1, keepdim=True))
    l = p.sum(-1, keepdim=True)
    o = torch.matmul(p.to(q.dtype).float(), heads(v)) / l  # [B, H, T, dh]
    return o.transpose(1, 2).reshape(B, T, D).to(q.dtype)


@torch.no_grad()
def flash_self_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, n_heads: int
) -> torch.Tensor:
    """Same contract as :func:`flash_attention_torch`.  CUDA tensors launch
    the kernel, CPU tensors run the plain version."""
    _validate(q, k, v, n_heads)
    dev = q.device
    if dev.type == "cpu":
        return flash_attention_torch(q, k, v, n_heads)
    if dev.type != "cuda":
        raise ValueError(f"flash_self_attention: unsupported device {dev}")
    B, T, D = q.shape
    dh = D // n_heads
    if dh != _KERNEL_HEAD_DIM:
        raise ValueError(f"kernel head_dim must be {_KERNEL_HEAD_DIM}, got {dh}")
    if any(x.stride(2) != 1 for x in (q, k, v)):
        raise ValueError("q, k, v must be contiguous in their last axis")
    out = torch.empty((B, T, D), dtype=q.dtype, device=dev)
    code = _build.lib().norma_flash_encoder(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        q.stride(0), q.stride(1), k.stride(0), k.stride(1), v.stride(0), v.stride(1),
        out.data_ptr(), B, T, n_heads, dh, int(q.dtype == torch.bfloat16),
        float(dh) ** -0.5, _build.stream_ptr(dev),
    )
    _build.check(code, "flash_encoder kernel")
    flash_self_attention.launches += 1
    return out


flash_self_attention.launches = 0

