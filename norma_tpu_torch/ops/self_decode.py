"""Self-attention decode step over the stacked KV cache
(``norma_tpu/ops/self_decode.py``).

One query row per stream attends over layer ``li``'s cache rows below
``pos`` plus the step's new K/V row (at ``pos``), and that row is written
into the caches IN PLACE.  Both whisper ``dh**-0.25`` factors fold onto q
in f32 (then q is rounded to the cache dtype, as the TPU kernel does).

  - :func:`self_attention_decode_torch` — the plain PyTorch version (the
    CPU path and the kernel's oracle);
  - :func:`self_attention_decode` — the wrapper: the CUDA kernel
    (``csrc/self_decode.cu``: each (row, head) on a thread-block cluster
    whose CTAs split the positions below ``pos``, :func:`self_decode_plan`,
    :func:`self_decode_ranges`) for CUDA tensors, the plain version for CPU
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

import functools
from typing import List, Tuple

import torch

from . import _build

_DTYPES = (torch.float32, torch.bfloat16)
_KERNEL_HEAD_DIMS = (32, 64, 128)
# csrc/self_decode.cu: largest cluster (16 is the H100's non-portable
# limit; above 8 the launcher sets the attribute), warps per CTA, the most
# rows a thread holds in registers.
_SD_MAX_CLUSTER, _SD_WARPS, _SD_ROWS = 16, 8, 8


@functools.lru_cache(maxsize=None)
def self_decode_plan(B: int, H: int, S: int, dtype: torch.dtype, dh: int = 64) -> dict:
    """Launch shape of the self-decode kernel at crop ``S``: each (row,
    head) on a cluster of ``cluster`` CTAs (a power of two up to 16) that
    split the history rows 0..pos-1 (:func:`self_decode_ranges`), at most
    ``share`` rows each.  A CTA's threads hold their rows' K and V chunks
    in registers, at most ``max_rows`` rows per CTA (8 per thread); rank 0
    gathers the cluster's partial sums in ``smem_bytes`` of dynamic shared
    memory.  It depends on the crop, not the position, so one shape serves
    a graph's whole chunk.  The cluster is the fewest CTAs that hold the
    rows: at 6 and 8 rows every doubling cost 1-4 us more than the rows
    it spread (the sweep of chip_smoke.py phase 3; PERF.md, Findings), so a
    crop of 128 or 256 bf16 rows runs on one CTA, launched without a
    cluster, and 448 on two."""
    if B < 1 or H < 1 or S < 1:
        raise ValueError(f"self_decode_plan: B, H and S must be positive, got {B}, {H}, {S}")
    if dh not in _KERNEL_HEAD_DIMS:
        raise ValueError(f"kernel head_dim must be one of {_KERNEL_HEAD_DIMS}, got {dh}")
    if dtype not in _DTYPES:
        raise ValueError(f"kernel dtype must be one of {_DTYPES}, got {dtype}")
    lanes = dh * dtype.itemsize // 16  # lanes per row: 16-byte chunks
    max_rows = _SD_ROWS * _SD_WARPS * (32 // lanes)
    hist = max(S - 1, 1)
    C = 1
    while C < _SD_MAX_CLUSTER and -(-hist // C) > max_rows:
        C *= 2
    share = -(-hist // C)
    if share > max_rows:
        raise ValueError(
            f"self_decode kernel: a crop of {S} rows at dh={dh} {dtype} needs more than "
            f"{_SD_MAX_CLUSTER} CTAs of {max_rows} rows"
        )
    return dict(cluster=C, share=share, max_rows=max_rows, smem_bytes=4 * C * (dh + 1),
                grid=(C, H, B), nonportable=C > 8)


def self_decode_ranges(pos: int, cluster: int) -> List[Tuple[int, int]]:
    """The history rows [lo, hi) each CTA of a cluster takes at ``pos``:
    the kernel's own formula, rank * pos / C (integer division)."""
    return [(r * pos // cluster, (r + 1) * pos // cluster) for r in range(cluster)]


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
    plan = self_decode_plan(B, n_heads, T, cache_k.dtype, dh)
    if cache_k.data_ptr() % 16 or cache_v.data_ptr() % 16:
        raise ValueError("the kernel's 16-byte loads need 16-byte aligned caches")
    out = torch.empty((B, 1, D), dtype=q.dtype, device=dev)
    dev_pos = isinstance(pos, torch.Tensor)
    code = _build.lib().norma_self_decode(
        q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(),
        cache_k.data_ptr(), cache_v.data_ptr(), out.data_ptr(),
        q.stride(0), k_new.stride(0), v_new.stride(0),
        cache_k.stride(0), cache_k.stride(1), cache_v.stride(0), cache_v.stride(1),
        li, 0 if dev_pos else pos, pos.data_ptr() if dev_pos else None, B, n_heads, dh, T,
        int(cache_k.dtype == torch.bfloat16), plan["cluster"], dh**-0.5,
        _build.stream_ptr(dev),
    )
    _build.check(code, "self_decode kernel")
    self_attention_decode.launches += 1
    return out, cache_k, cache_v


self_attention_decode.launches = 0
