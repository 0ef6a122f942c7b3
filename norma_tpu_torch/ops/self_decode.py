"""Self-attention decode step over the stacked KV cache
(``norma_tpu/ops/self_decode.py``).

One query row per stream attends over layer ``li``'s cache rows below
``pos`` plus the step's new K/V row (at ``pos``), and that row is written
into the caches IN PLACE.  Both whisper ``dh**-0.25`` factors fold onto q
in f32 (then q is rounded to the cache dtype, as the TPU kernel does).

  - :func:`self_attention_decode_torch` — the plain PyTorch version (the
    CPU path and the kernel's oracle);
  - :func:`self_attention_decode` — the wrapper: the CUDA kernel
    (``csrc/self_decode.cu``) for CUDA tensors, the plain version for CPU
    tensors.  It validates dtypes, shapes and strides on both and raises on
    what the kernel does not take; it never falls back.
    ``self_attention_decode.launches`` counts kernel launches.

``pos`` is an ``int`` or a one-element int64 tensor on the caches'
device (the engine's captured token loop advances it on the device).  An
``int`` is checked against the crop here; a device position is checked by
the kernel, which traps on one outside ``[0, T)``.

Reading only rows < ``pos`` is exact: the masked rows contribute zero.  So
a bucket view ``cache[:, :, :S]`` (non-contiguous in the layer and batch
axes) is taken as it is, and rows at or beyond ``pos`` are never read.
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import _build

_DTYPES = (torch.float32, torch.bfloat16)
_KERNEL_HEAD_DIMS = (32, 64, 128)
# The kernel keeps T + 1 f32 logits in (non-opt-in) shared memory.
_KERNEL_MAX_T = 8192


def _validate(q, k_new, v_new, cache_k, cache_v, li, pos, n_heads) -> None:
    if cache_k.dim() != 4 or cache_v.shape != cache_k.shape:
        raise ValueError(
            f"caches must be [L, B, T, D] of one shape, got {tuple(cache_k.shape)} "
            f"and {tuple(cache_v.shape)}"
        )
    L, B, T, D = cache_k.shape
    for name, t in (("q", q), ("k_new", k_new), ("v_new", v_new)):
        if tuple(t.shape) != (B, 1, D):
            raise ValueError(f"{name} must be [{B}, 1, {D}], got {tuple(t.shape)}")
        if t.stride(-1) != 1:
            raise ValueError(f"{name} must be contiguous in its last axis")
    dts = {t.dtype for t in (q, k_new, v_new, cache_k, cache_v)}
    if len(dts) != 1 or cache_k.dtype not in _DTYPES:
        raise TypeError(f"q, k/v rows and caches must share one dtype of {_DTYPES}, got {dts}")
    devs = {t.device for t in (q, k_new, v_new, cache_k, cache_v)}
    if len(devs) != 1:
        raise ValueError(f"all tensors must be on one device, got {devs}")
    for c in (cache_k, cache_v):
        if c.stride(3) != 1 or c.stride(2) != D:
            raise ValueError(
                "cache rows must be contiguous [.., T, D] (a crop of the T axis "
                f"is fine); got strides {c.stride()}"
            )
    if D % n_heads:
        raise ValueError(f"d_model {D} not divisible by n_heads {n_heads}")
    if not 0 <= li < L:
        raise ValueError(f"layer {li} outside [0, {L})")
    if isinstance(pos, torch.Tensor):
        if pos.dtype != torch.int64 or pos.numel() != 1 or pos.device != cache_k.device:
            raise ValueError(f"a device position must be one int64 on {cache_k.device}")
    elif not 0 <= pos < T:
        raise ValueError(f"position {pos} outside the cache's {T} rows")


@torch.no_grad()
def self_attention_decode_torch(
    q: torch.Tensor,  # [B, 1, D] — projected query, unscaled
    k_new: torch.Tensor,  # [B, 1, D] — the step's new K row
    v_new: torch.Tensor,
    cache_k: torch.Tensor,  # [L, B, T, D]
    cache_v: torch.Tensor,
    li: int,
    pos: "int | torch.Tensor",
    n_heads: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version.  Returns (attn_out [B, 1, D] in q.dtype,
    cache_k, cache_v) with row ``(li, :, pos)`` written in place.  A tensor
    ``pos`` is read to the host (free on the CPU, where the engine runs this
    version)."""
    pos = int(pos)
    _, B, _, D = cache_k.shape
    H, dh = n_heads, D // n_heads
    cdt = cache_k.dtype
    qh = (q.float() * dh**-0.5).to(cdt).float().reshape(B, H, dh)
    kn = k_new.to(cdt)
    vn = v_new.to(cdt)
    kh = cache_k[li, :, :pos].float().reshape(B, pos, H, dh)
    vh = cache_v[li, :, :pos].float().reshape(B, pos, H, dh)
    hist = torch.einsum("bhd,bthd->bht", qh, kh)
    new = (qh * kn.float().reshape(B, H, dh)).sum(-1, keepdim=True)
    logits = torch.cat([hist, new], dim=-1)  # [B, H, pos + 1]
    p = torch.exp(logits - logits.amax(-1, keepdim=True))
    l = p.sum(-1, keepdim=True)
    p_hist = p[..., :pos].to(cdt).float()  # the PV operand, in the cache dtype
    o = torch.einsum("bht,bthd->bhd", p_hist, vh) + p[..., pos:] * vn.float().reshape(B, H, dh)
    o = o / l
    cache_k[li, :, pos] = kn[:, 0]
    cache_v[li, :, pos] = vn[:, 0]
    return o.reshape(B, 1, D).to(q.dtype), cache_k, cache_v


@torch.no_grad()
def self_attention_decode(
    q: torch.Tensor,
    k_new: torch.Tensor,
    v_new: torch.Tensor,
    cache_k: torch.Tensor,
    cache_v: torch.Tensor,
    li: int,
    pos: "int | torch.Tensor",
    n_heads: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fused write-row + self-attention; same contract as
    :func:`self_attention_decode_torch`.  CUDA tensors launch the kernel,
    CPU tensors run the plain version; any other device raises."""
    li = int(li)
    if not isinstance(pos, torch.Tensor):
        pos = int(pos)
    _validate(q, k_new, v_new, cache_k, cache_v, li, pos, n_heads)
    dev = cache_k.device
    if dev.type == "cpu":
        return self_attention_decode_torch(q, k_new, v_new, cache_k, cache_v, li, pos, n_heads)
    if dev.type != "cuda":
        raise ValueError(f"self_attention_decode: unsupported device {dev}")
    _, B, T, D = cache_k.shape
    dh = D // n_heads
    if dh not in _KERNEL_HEAD_DIMS:
        raise ValueError(f"kernel head_dim must be one of {_KERNEL_HEAD_DIMS}, got {dh}")
    if T > _KERNEL_MAX_T:
        raise ValueError(f"kernel cache length must be <= {_KERNEL_MAX_T}, got {T}")
    out = torch.empty((B, 1, D), dtype=q.dtype, device=dev)
    dev_pos = isinstance(pos, torch.Tensor)
    code = _build.lib().norma_self_decode(
        q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(),
        cache_k.data_ptr(), cache_v.data_ptr(), out.data_ptr(),
        q.stride(0), k_new.stride(0), v_new.stride(0),
        cache_k.stride(0), cache_k.stride(1), cache_v.stride(0), cache_v.stride(1),
        li, 0 if dev_pos else pos, pos.data_ptr() if dev_pos else None, B, n_heads, dh, T,
        int(cache_k.dtype == torch.bfloat16), dh**-0.5,
        _build.stream_ptr(dev),
    )
    _build.check(code, "self_decode kernel")
    self_attention_decode.launches += 1
    return out, cache_k, cache_v


self_attention_decode.launches = 0
