"""Int8 quantized matmuls (``norma_tpu/ops/quant_matmul.py``).

  - :func:`quantize_per_channel` — [in, out] float -> (int8 codes, f32
    per-out-channel scales), bit-equal to the JAX package's numpy grid;
  - :func:`w8_matmul` — w8a16: x and the int8 codes as bf16, f32
    accumulation, times the scale (the int8 logits head; the JAX package
    computes it in XLA too, ``w8_matmul_jnp``);
  - :func:`quantize_activations` — per-row dynamic int8 activations;
  - :func:`q8a8_dense_torch` — the plain w8a8 product, with the integer
    accumulation exact (float64 on every device: every partial sum of
    int8 x int8 products stays far below 2**53);
  - :func:`q8a8_dense` — the wrapper: the CUDA kernel (``csrc/q8a8.cu``,
    the port of ``q8a8_dense_pallas``) for CUDA tensors, the plain version
    for CPU tensors; any other device raises.  ``q8a8_dense.launches``
    counts kernel launches.  Both of the JAX package's w8a8 modes
    (``encoder_q8_mode`` "w8a8" and "w8a8_pallas") run it: on the card it
    is the int8 GEMM;
  - :func:`q8a8_qkv` — the fused-QKV form over [in, 3, out] weights.

The epilogue is ``acc * xs[m] * ws[n] (+ b[n])`` in f32, in that order, in
every version.  The int4 helpers (``quantize_blockwise_int4``,
``w4_matmul_*``) are not ported yet (ROADMAP queue 2 #7).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import _build


def mm_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [..., K] @ w [K, N] with an f32 result and one rounding.

    f32 operands multiply in f32.  bf16 operands accumulate into f32 and
    the result is NOT rounded to bf16 (the JAX package's
    ``preferred_element_type=f32``): cuBLAS with an f32 output on the card,
    an f32 product of the (exactly) widened operands on the CPU.  The
    weight is never widened on the card.
    """
    if x.dtype != w.dtype:
        raise TypeError(f"mm_f32: operand dtypes differ ({x.dtype}, {w.dtype})")
    if x.dtype == torch.float32:
        return torch.matmul(x, w)
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if x.device.type == "cuda":
        y = torch.mm(x2, w, out_dtype=torch.float32)
    elif x.device.type == "cpu":
        y = torch.mm(x2.float(), w.float())
    else:
        raise ValueError(f"mm_f32: unsupported device {x.device}")
    return y.reshape(*lead, w.shape[-1])


def quantize_per_channel(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """[in, out] float weights -> (int8 [in, out], f32 scale [out]).

    Symmetric per output channel: scale = amax / 127 (1.0 for an all-zero
    channel), codes = clip(round_half_even(w / scale), -127, 127), all in
    f32 — the JAX package's numpy arithmetic, so codes and scales are
    bit-equal."""
    return quantize_axis(w, axis=0)


def quantize_axis(w: torch.Tensor, axis: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 over ``axis`` (the contraction axis) of any float
    tensor: returns (codes like ``w``, f32 scales without ``axis``)."""
    wf = w.float()
    amax = wf.abs().amax(dim=axis)
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    q = torch.clamp(torch.round(wf / scale.unsqueeze(axis)), -127, 127).to(torch.int8)
    return q, scale


@torch.no_grad()
def w8_matmul(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """w8a16: [B, in] @ int8 [in, out] * scale -> [B, out] f32
    (``w8_matmul_jnp``: bf16 operands, f32 accumulation)."""
    y = mm_f32(x.to(torch.bfloat16), q.to(torch.bfloat16))
    return y * scale.float()


def quantize_activations(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row (last-axis) symmetric dynamic int8 quantization.

    x [..., in] -> (int8 codes [..., in], f32 scale [..., 1]); the floor
    keeps an all-subnormal row finite and an all-zero row gets scale 1.
    |x| <= amax, so the codes need no clip."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1, keepdim=True)
    scale = torch.where(amax > 0, torch.clamp(amax, min=1e-8) / 127.0, torch.ones_like(amax))
    return torch.round(xf / scale).to(torch.int8), scale


def _flatten(xq, xs, wq, ws, b):
    if xq.dtype != torch.int8 or wq.dtype != torch.int8:
        raise TypeError(f"q8a8: codes must be int8, got {xq.dtype} and {wq.dtype}")
    K = xq.shape[-1]
    if wq.dim() != 2 or wq.shape[0] != K:
        raise ValueError(f"q8a8: weight must be [{K}, N], got {tuple(wq.shape)}")
    N = wq.shape[1]
    if tuple(xs.shape) != tuple(xq.shape[:-1]) + (1,):
        raise ValueError(f"q8a8: row scales must be {tuple(xq.shape[:-1]) + (1,)}, got {tuple(xs.shape)}")
    if tuple(ws.shape) != (N,) or (b is not None and tuple(b.shape) != (N,)):
        raise ValueError(f"q8a8: column scales and bias must be [{N}]")
    devs = {t.device for t in (xq, xs, wq, ws) + ((b,) if b is not None else ())}
    if len(devs) != 1:
        raise ValueError(f"q8a8: all tensors must be on one device, got {devs}")
    return xq.reshape(-1, K), xs.reshape(-1, 1), N


@torch.no_grad()
def q8a8_dense_torch(
    xq: torch.Tensor,  # [..., K] int8
    xs: torch.Tensor,  # [..., 1] f32
    wq: torch.Tensor,  # [K, N] int8
    ws: torch.Tensor,  # [N] f32
    b: Optional[torch.Tensor] = None,  # [N]
) -> torch.Tensor:
    """Plain version: int8 x int8 accumulated exactly, then
    ``acc * xs * ws (+ b)`` in f32 -> [..., N] f32."""
    x2, s2, N = _flatten(xq, xs, wq, ws, b)
    acc = torch.matmul(x2.double(), wq.double()).to(torch.int32)
    y = acc.float() * s2.float() * ws.float()
    if b is not None:
        y = y + b.float()
    return y.reshape(*xq.shape[:-1], N)


@torch.no_grad()
def q8a8_dense(
    xq: torch.Tensor,
    xs: torch.Tensor,
    wq: torch.Tensor,
    ws: torch.Tensor,
    b: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Same contract as :func:`q8a8_dense_torch`.  CUDA tensors launch the
    int8 GEMM kernel, CPU tensors run the plain version."""
    x2, s2, N = _flatten(xq, xs, wq, ws, b)
    dev = xq.device
    if dev.type == "cpu":
        return q8a8_dense_torch(xq, xs, wq, ws, b)
    if dev.type != "cuda":
        raise ValueError(f"q8a8_dense: unsupported device {dev}")
    M, K = x2.shape
    if K % 32 or N % 16:
        raise ValueError(f"q8a8 kernel needs K % 32 == 0 and N % 16 == 0, got K={K} N={N}")
    if not (x2.is_contiguous() and wq.is_contiguous()):
        raise ValueError("q8a8 kernel needs contiguous [M, K] codes and a contiguous [K, N] weight")
    if s2.dtype != torch.float32 or ws.dtype != torch.float32:
        raise TypeError("q8a8 kernel needs f32 scales")
    s2, ws = s2.contiguous(), ws.contiguous()
    bias = b.float().contiguous() if b is not None else None  # added in f32, as in the plain version
    out = torch.empty((M, N), dtype=torch.float32, device=dev)
    code = _build.lib().norma_q8a8(
        x2.data_ptr(), s2.data_ptr(), wq.data_ptr(), ws.data_ptr(),
        bias.data_ptr() if bias is not None else None, out.data_ptr(),
        M, N, K, _build.stream_ptr(dev),
    )
    _build.check(code, "q8a8 kernel")
    q8a8_dense.launches += 1
    return out.reshape(*xq.shape[:-1], N)


q8a8_dense.launches = 0


@torch.no_grad()
def q8a8_qkv(
    xq: torch.Tensor, xs: torch.Tensor, wq: torch.Tensor, ws: torch.Tensor, b: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fused-QKV w8a8: xq [..., in] @ wq [in, 3, out] -> three [..., out]
    f32, ws/b [3, out] (zero bias in the K slot).  One product over the
    flattened [in, 3*out] weight, through :func:`q8a8_dense`."""
    K, three, O = wq.shape
    y = q8a8_dense(xq, xs, wq.reshape(K, three * O), ws.reshape(-1), b.reshape(-1))
    y = y.unflatten(-1, (three, O))
    return y[..., 0, :], y[..., 1, :], y[..., 2, :]
