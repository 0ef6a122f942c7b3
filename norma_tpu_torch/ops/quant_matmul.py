"""Quantized matmuls (``norma_tpu/ops/quant_matmul.py``).

  - :func:`quantize_per_channel` — [in, out] float -> (int8 codes, f32
    per-out-channel scales), bit-equal to the JAX package's numpy grid;
  - :func:`w8_matmul` — w8a16 with ``w8_matmul_jnp``'s contract (x cast
    to bf16; the int8 logits head) and :func:`w8_dense` — the same product
    with x in the model dtype (the int8 decoder layers).  Both route
    through one wrapper: the CUDA kernel (``csrc/w8_matmul.cu``, the port
    of ``w8_matmul_pallas``: one launch, bf16 tensor cores, launch shape
    from :func:`w8_plan`; code rows 16-byte aligned, :func:`pitched_codes`,
    other layouts copied for the call) for CUDA tensors, the plain version
    (:func:`w8_matmul_torch` / :func:`w8_dense_torch`: exact widening, f32
    accumulation, times the scale) for CPU tensors; ``w8_matmul.launches``
    counts the kernel's launches through either;
  - :func:`quantize_blockwise_int4` / :func:`unpack_int4` — the int4 head's
    split-half nibble packing with bf16 scales per (block, column),
    bit-equal to the JAX package's;
  - :func:`w4_matmul` — w4a16 over those codes: the CUDA kernel
    (``csrc/w4_matmul.cu``, the port of ``w4_matmul_pallas``: w8's design
    with the nibbles widened per half and the block scales applied per
    scale block, launch shape from :func:`w4_plan`, pitched code rows) for
    CUDA tensors, the plain :func:`w4_matmul_torch` (``w4_matmul_jnp``:
    per-block f32 partials times the f32 scale, summed) for CPU tensors;
    ``w4_matmul.launches`` counts kernel launches;
  - :func:`head_kernel_layout` — the logits heads' codes in the kernels'
    pitched layout, set where the params reach the card (``DecodeEngine``);
  - :func:`quantize_activations` — per-row dynamic int8 activations;
  - :func:`q8a8_dense_torch` — the plain w8a8 product, with the integer
    accumulation exact (float64 on every device: every partial sum of
    int8 x int8 products stays far below 2**53);
  - :func:`q8a8_dense` — the wrapper: the CUDA kernel (``csrc/q8a8.cu``,
    the port of ``q8a8_dense_pallas``: s8 wgmma fed by TMA, tile chosen by
    :func:`q8a8_plan`) for CUDA tensors, the plain version for CPU
    tensors; any other device raises.  ``q8a8_dense.launches`` counts
    kernel launches.  Both of the JAX package's w8a8 modes
    (``encoder_q8_mode`` "w8a8" and "w8a8_pallas") run it: on the card it
    is the int8 GEMM.  The kernel reads the weight codes K-major: a [K, N]
    view with strides (1, K) (:func:`kmajor_codes`; ``DecodeEngine`` holds
    such copies of the encoder's, ``model/quant.py::
    prep_encoder_q8_kernel``); a CUDA weight in another layout is copied
    K-major for the call (a bare ``encode`` on unprepped params);
  - :func:`q8a8_qkv` — the fused-QKV form over [in, 3, out] weights.

The w8a8 epilogue is ``acc * xs[m] * ws[n] (+ b[n])`` in f32, in that
order, in every version, then (``out_dtype``) one rounding to bf16 where
asked.  Any device other than the CPU or CUDA raises.
"""

from __future__ import annotations

import math
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
    tensor: returns (codes like ``w``, f32 scales without ``axis``), both
    contiguous whatever ``w``'s strides (the kernels read them row-major;
    the head quantizes a transposed view)."""
    wf = w.float()
    amax = wf.abs().amax(dim=axis)
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    q = torch.clamp(torch.round(wf / scale.unsqueeze(axis)), -127, 127).to(torch.int8)
    return q.contiguous(), scale.contiguous()


# -- weight-streaming kernels (csrc/wstream.cuh: w8_matmul.cu, w4_matmul.cu) --

_H100_SMS = 132
_X_DTYPES = (torch.float32, torch.bfloat16)


# Tiles of csrc/w8_matmul.cu: output columns per block, warps per block,
# contraction rows per ring stage, largest cluster along K.
_W8_BN, _W8_WARPS, _W8_KB, _W8_CLUSTER = 128, 4, 32, 8


def w8_plan(M: int, N: int, K: int) -> dict:
    """Launch shape of the w8 kernel: ``rt`` row tiles of 8 (1 up to 8
    rows, 2 up to 16, else 4: up to 32 rows every code byte is read once),
    ``row_blocks`` x ``tiles`` blocks of 128 columns, each split along K
    over a cluster of ``cluster`` blocks of 4 warps that share the
    contraction's 32-row stages evenly.  The cluster doubles while the
    blocks still fit one per SM of the H100 and every warp keeps a stage:
    the fastest cluster size at 6 rows on each of the decoder's shapes and
    the head (PERF.md)."""
    rt = 1 if M <= 8 else 2 if M <= 16 else 4
    row_blocks, tiles = math.ceil(M / (8 * rt)), math.ceil(N / _W8_BN)
    nst = math.ceil(K / _W8_KB)
    cluster = 1
    while (cluster < _W8_CLUSTER and row_blocks * tiles * 2 * cluster <= _H100_SMS
           and _W8_WARPS * 2 * cluster <= nst):
        cluster *= 2
    return dict(rt=rt, row_blocks=row_blocks, tiles=tiles, cluster=cluster)


def pitched_codes(q: torch.Tensor) -> torch.Tensor:
    """The same [K, N] int8 codes with each row starting 16-byte aligned: a
    [K, N] view of a zero-padded [K, round_up(N, 16)] tensor (``q`` itself
    when its rows already are).  The w8 kernel streams code rows with
    16-byte copies; the int8 head (N = 51866) needs the padding."""
    K, N = q.shape
    if q.stride(1) == 1 and q.stride(0) % 16 == 0 and q.stride(0) >= N and q.data_ptr() % 16 == 0:
        return q
    P = -(-N // 16) * 16
    buf = torch.zeros((K, P), dtype=q.dtype, device=q.device)
    buf[:, :N] = q
    return buf[:, :N]


# Tiles of csrc/w4_matmul.cu: warps per block it may run (the block's
# ring and totals fit the shared memory at 4-6 warps up to 16 rows, at 4
# warps at 32), largest cluster, the scale blocks it takes.
_W4_WARPS, _W4_WARPS_RT4, _W4_CLUSTER, _W4_BLOCKS = (4, 5, 6), (4,), 8, (32, 64)


def w4_plan(M: int, N: int, K: int, blk: int) -> dict:
    """Launch shape of the w4 kernel for x [M, K] and packed codes [K/2, N]
    with scale blocks of ``blk`` rows: ``rt`` row tiles of 8 (as
    :func:`w8_plan`: up to 32 rows every code byte is read once),
    ``row_blocks`` x ``tiles`` blocks of 128 columns, and the ``units``
    (K/2/blk packed blocks, one scale block of each half) shared by a
    cluster of ``cluster`` blocks of ``warps`` warps.  The cluster doubles
    while the blocks still fit one per SM of the H100 and every warp of 4
    keeps a unit (at the head's 406 column tiles it stays 1, as w8's); then
    the warps (4-6 up to 16 rows) are the fewest that leave the fewest
    units to the busiest warp."""
    if blk not in _W4_BLOCKS or K % 2 or (K // 2) % blk:
        raise ValueError(f"w4 kernel needs a scale block in {_W4_BLOCKS} dividing K/2, got block {blk}, K={K}")
    rt = 1 if M <= 8 else 2 if M <= 16 else 4
    row_blocks, tiles = math.ceil(M / (8 * rt)), math.ceil(N / _W8_BN)
    units = K // 2 // blk
    cluster = 1
    while (cluster < _W4_CLUSTER and row_blocks * tiles * 2 * cluster <= _H100_SMS
           and 4 * 2 * cluster <= units):
        cluster *= 2
    warps = min(_W4_WARPS_RT4 if rt == 4 else _W4_WARPS, key=lambda w: (math.ceil(units / (w * cluster)), w))
    return dict(rt=rt, row_blocks=row_blocks, tiles=tiles, cluster=cluster, warps=warps, units=units)


def head_kernel_layout(dec):
    """The decoder subtree with the heads' codes in the kernels' layout:
    ``tok_emb_q8.q`` and ``tok_emb_q4.q`` with rows starting 16-byte
    aligned (:func:`pitched_codes`: the same values), every other leaf and
    subtree shared as it is; ``dec`` itself when nothing changes.  A tree
    carried from numpy (``model/load.py::params_from_numpy``) or moved by
    ``.to(device)`` has contiguous head codes, whose rows at V = 51866 are
    not aligned.  ``DecodeEngine`` applies this on CUDA to its own tree, so
    the caller's params stay as they are."""
    heads = {}
    for name in ("tok_emb_q8", "tok_emb_q4"):
        if name in dec:
            q = pitched_codes(dec[name]["q"])
            if q is not dec[name]["q"]:
                heads[name] = {**dict(dec[name].items()), "q": q}
    if not heads:
        return dec
    tree = {**dict(dec.items()), **heads}
    return tree if isinstance(dec, dict) else type(dec)(tree)


def _w8_shapes(x, q, scale):
    if q.dtype != torch.int8 or q.dim() != 2:
        raise TypeError(f"w8: codes must be int8 [K, N], got {q.dtype} {tuple(q.shape)}")
    K, N = q.shape
    if x.shape[-1] != K or tuple(scale.shape) != (N,):
        raise ValueError(f"w8: x [..., {K}] and scale [{N}] expected, got {tuple(x.shape)}, {tuple(scale.shape)}")
    if len({x.device, q.device, scale.device}) != 1:
        raise ValueError("w8: x, codes and scale must be on one device")
    return K, N


@torch.no_grad()
def w8_dense_torch(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Plain w8a16: x [..., K] @ int8 [K, N] * scale [N] -> [..., N] f32,
    x and the codes widened exactly to f32, f32 accumulation."""
    K, N = _w8_shapes(x, q, scale)
    y = torch.mm(x.reshape(-1, K).float(), q.float()) * scale.float()
    return y.reshape(*x.shape[:-1], N)


def w8_matmul_torch(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`w8_matmul` (``w8_matmul_jnp``: x cast to
    bf16, f32 accumulation)."""
    return w8_dense_torch(x.to(torch.bfloat16), q, scale)


@torch.no_grad()
def w8_dense(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Same contract as :func:`w8_dense_torch`, x f32 or bf16.  CUDA
    tensors launch the w8 kernel, CPU tensors run the plain version.  The
    kernel reads code rows that start 16-byte aligned (:func:`pitched_codes`:
    the int8 head's layout from the quantizer and ``DecodeEngine``); codes
    in any other layout are copied into it for this call."""
    K, N = _w8_shapes(x, q, scale)
    dev = x.device
    if dev.type == "cpu":
        return w8_dense_torch(x, q, scale)
    if dev.type != "cuda":
        raise ValueError(f"w8_dense: unsupported device {dev}")
    if x.dtype not in _X_DTYPES or scale.dtype != torch.float32:
        raise TypeError(f"w8 kernel needs x in {_X_DTYPES} and f32 scales, got {x.dtype}, {scale.dtype}")
    q = pitched_codes(q)  # a copy for this call unless the rows start 16-byte aligned
    if K % 16:
        raise ValueError(f"w8 kernel needs K a multiple of 16, got {K}")
    x2 = x.reshape(-1, K)
    if not x2.is_contiguous() or x2.data_ptr() % 16:
        x2 = x2.clone(memory_format=torch.contiguous_format)
    M = x2.shape[0]
    out = torch.empty((M, N), dtype=torch.float32, device=dev)
    if M == 0:
        return out.reshape(*x.shape[:-1], N)
    plan = w8_plan(M, N, K)
    scale = scale.contiguous()
    code = _build.lib().norma_w8_matmul(
        x2.data_ptr(), q.data_ptr(), scale.data_ptr(), out.data_ptr(), M, N, K, q.stride(0),
        plan["rt"], plan["cluster"], int(x.dtype == torch.bfloat16), _build.stream_ptr(dev),
    )
    _build.check(code, "w8 kernel")
    w8_matmul.launches += 1
    return out.reshape(*x.shape[:-1], N)


def w8_matmul(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """w8a16 with ``w8_matmul_jnp``'s contract: [..., in] (cast to bf16) @
    int8 [in, out] * scale -> [..., out] f32, through :func:`w8_dense`."""
    return w8_dense(x.to(torch.bfloat16), q, scale)


w8_matmul.launches = 0


def quantize_blockwise_int4(w: torch.Tensor, block: int = 64) -> Tuple[torch.Tensor, torch.Tensor]:
    """[in, out] float -> (nibble-packed int8 [in/2, out], bf16 [in/block, out]).

    Symmetric 4-bit grid (+-7) per (input block, output column): scale =
    amax / 7 (1 for an all-zero block), codes = clip(round_half_even(w /
    scale), -7, 7), in f32; the scales are then stored in bf16.  Byte i
    holds row i in the low nibble and row i + in/2 in the high one (split
    half).  The JAX package's numpy arithmetic, so bit-equal.  Both
    results are contiguous whatever ``w``'s strides."""
    wf = w.float()
    IN, OUT = wf.shape
    if IN % block or IN % 2:
        raise ValueError(f"in={IN} must divide by block={block} and by 2")
    wb = wf.reshape(IN // block, block, OUT)
    amax = wb.abs().amax(dim=1)
    scale = torch.where(amax > 0, amax / 7.0, torch.ones_like(amax))
    q = torch.clamp(torch.round(wb / scale[:, None, :]), -7, 7).to(torch.int32).reshape(IN, OUT)
    packed = (q[: IN // 2] & 0xF) | ((q[IN // 2 :] & 0xF) << 4)
    return packed.to(torch.uint8).view(torch.int8).contiguous(), scale.to(torch.bfloat16).contiguous()


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """Nibble-packed int8 [in/2, out] -> int8 codes [in, out] (sign-extended)."""
    v = packed.to(torch.int32)
    lo, hi = v & 0xF, (v >> 4) & 0xF
    return torch.cat([lo - ((lo & 8) << 1), hi - ((hi & 8) << 1)], dim=0).to(torch.int8)


def _w4_shapes(x, q, scale):
    if q.dtype != torch.int8 or q.dim() != 2 or scale.dim() != 2:
        raise TypeError(f"w4: codes must be int8 [K/2, N], scales [nb, N], got {q.dtype} {tuple(q.shape)}")
    K, N = 2 * q.shape[0], q.shape[1]
    nb = scale.shape[0]
    if x.shape[-1] != K or scale.shape[1] != N or K % nb:
        raise ValueError(f"w4: x [..., {K}] and scale [nb, {N}] with nb | K expected, got "
                         f"{tuple(x.shape)}, {tuple(scale.shape)}")
    if len({x.device, q.device, scale.device}) != 1:
        raise ValueError("w4: x, codes and scale must be on one device")
    return K, N, K // nb


@torch.no_grad()
def w4_matmul_torch(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Plain w4a16 (``w4_matmul_jnp`` off the TPU): x [..., in] @ packed
    int4 [in/2, out] -> [..., out] f32.  Per block of rows, the x . code
    partial in f32, times the block's f32 scale, summed over blocks."""
    K, N, block = _w4_shapes(x, q, scale)
    nb = K // block
    w = unpack_int4(q).float().reshape(nb, block, N)
    xb = x.reshape(-1, nb, block).float()
    partial = torch.einsum("bnk,nko->bno", xb, w)
    y = (partial * scale.float()[None]).sum(dim=1)
    return y.reshape(*x.shape[:-1], N)


@torch.no_grad()
def w4_matmul(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Same contract as :func:`w4_matmul_torch`, x f32 or bf16.  CUDA
    tensors launch the w4 kernel (bf16 scales; launch shape from
    :func:`w4_plan`), CPU tensors run the plain version.  The kernel reads
    code rows that start 16-byte aligned (:func:`pitched_codes`, the
    layout the quantizer and ``DecodeEngine`` give the head); codes in any
    other layout are copied into it for this call, as :func:`q8a8_dense`
    copies unprepped codes."""
    K, N, block = _w4_shapes(x, q, scale)
    dev = x.device
    if dev.type == "cpu":
        return w4_matmul_torch(x, q, scale)
    if dev.type != "cuda":
        raise ValueError(f"w4_matmul: unsupported device {dev}")
    if x.dtype not in _X_DTYPES or scale.dtype != torch.bfloat16:
        raise TypeError(f"w4 kernel needs x in {_X_DTYPES} and bf16 scales, got {x.dtype}, {scale.dtype}")
    x2 = x.reshape(-1, K)
    M = x2.shape[0]
    plan = w4_plan(M, N, K, block)
    q = pitched_codes(q)
    if not x2.is_contiguous() or x2.data_ptr() % 16:
        x2 = x2.clone(memory_format=torch.contiguous_format)
    out = torch.empty((M, N), dtype=torch.float32, device=dev)
    if M == 0:
        return out.reshape(*x.shape[:-1], N)
    scale = scale.contiguous()
    code = _build.lib().norma_w4_matmul(
        x2.data_ptr(), q.data_ptr(), scale.data_ptr(), out.data_ptr(), M, N, K, q.stride(0), block,
        plan["rt"], plan["cluster"], plan["warps"], int(x.dtype == torch.bfloat16), _build.stream_ptr(dev),
    )
    _build.check(code, "w4 kernel")
    w4_matmul.launches += 1
    return out.reshape(*x.shape[:-1], N)


w4_matmul.launches = 0


def quantize_activations(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row (last-axis) symmetric dynamic int8 quantization.

    x [..., in] -> (int8 codes [..., in], f32 scale [..., 1]); the floor
    keeps an all-subnormal row finite and an all-zero row gets scale 1.
    |x| <= amax, so the codes need no clip."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1, keepdim=True)
    scale = torch.where(amax > 0, torch.clamp(amax, min=1e-8) / 127.0, torch.ones_like(amax))
    return torch.round(xf / scale).to(torch.int8), scale


# csrc/q8a8.cu's tiles: output rows per CTA, contraction bytes per TMA
# slice, ring stages, threads (two consumer warpgroups and a producer warp).
_Q8_BM, _Q8_BK, _Q8_STAGES, _Q8_THREADS = 128, 128, 4, 288
_Q8_OUT = (torch.float32, torch.bfloat16)


def q8a8_plan(M: int, N: int, K: int) -> dict:
    """Launch shape of the int8 GEMM kernel for [M, K] x [K, N]: 128 x 128
    output tiles, or 128 x 64 where 128-wide tiles would give the card's
    132 SMs fewer than two waves (M = 1500 at N = 1280: 120 tiles become
    240).  K and N must be multiples of 128."""
    if K <= 0 or N <= 0 or K % _Q8_BK or N % 128:
        raise ValueError(f"q8a8 kernel needs K and N multiples of 128, got K={K} N={N}")
    m_tiles = math.ceil(M / _Q8_BM)
    bn = 128 if m_tiles * (N // 128) >= 2 * _H100_SMS else 64
    smem = 1024 + _Q8_STAGES * (_Q8_BM + bn) * _Q8_BK + 2 * _Q8_STAGES * 8
    return dict(bm=_Q8_BM, bn=bn, bk=_Q8_BK, stages=_Q8_STAGES, threads=_Q8_THREADS,
                grid=(N // bn, m_tiles), smem_bytes=smem)


def kmajor_codes(q: torch.Tensor, axis: int = -2) -> torch.Tensor:
    """The same values as ``q`` with the contraction ``axis`` stored
    innermost: a view of one new [..., K]-contiguous tensor (e.g. stacked
    [L, K, N] codes come back as a [L, K, N] view with strides (N*K, 1,
    K), fused [L, K, 3, O] ones as strides (3*O*K, 1, O*K, K)).  The int8
    GEMM kernel needs its weight K-major."""
    return torch.movedim(torch.movedim(q, axis, -1).contiguous(), -1, axis)


def is_kmajor(wq: torch.Tensor) -> bool:
    """Whether [K, N] codes lie K-major (strides (1, K)): the layout the
    int8 GEMM kernel reads (the wrapper copies other layouts)."""
    K, N = wq.shape
    return wq.stride(0) == 1 and (wq.stride(1) == K or N == 1)


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
    out_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Plain version: int8 x int8 accumulated exactly, then
    ``acc * xs * ws (+ b)`` in f32 -> [..., N], rounded once to
    ``out_dtype``."""
    x2, s2, N = _flatten(xq, xs, wq, ws, b)
    acc = torch.matmul(x2.double(), wq.double()).to(torch.int32)
    y = acc.float() * s2.float() * ws.float()
    if b is not None:
        y = y + b.float()
    return y.to(out_dtype).reshape(*xq.shape[:-1], N)


@torch.no_grad()
def q8a8_dense(
    xq: torch.Tensor,
    xs: torch.Tensor,
    wq: torch.Tensor,
    ws: torch.Tensor,
    b: Optional[torch.Tensor] = None,
    out_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Same contract as :func:`q8a8_dense_torch`.  CUDA tensors launch the
    int8 GEMM kernel (K-major weight codes only), CPU tensors run the plain
    version."""
    x2, s2, N = _flatten(xq, xs, wq, ws, b)
    if out_dtype not in _Q8_OUT:
        raise TypeError(f"q8a8: out_dtype must be one of {_Q8_OUT}, got {out_dtype}")
    dev = xq.device
    if dev.type == "cpu":
        return q8a8_dense_torch(xq, xs, wq, ws, b, out_dtype)
    if dev.type != "cuda":
        raise ValueError(f"q8a8_dense: unsupported device {dev}")
    M, K = x2.shape
    plan = q8a8_plan(M, N, K)
    if not is_kmajor(wq):
        # Unprepped codes (a bare ``encode``): a K-major copy for this call.
        wq = kmajor_codes(wq)
    if not x2.is_contiguous() or x2.data_ptr() % 16:
        raise ValueError("q8a8 kernel needs contiguous, 16-byte aligned [M, K] activation codes")
    if s2.dtype != torch.float32 or ws.dtype != torch.float32:
        raise TypeError("q8a8 kernel needs f32 scales")
    s2, ws = s2.contiguous(), ws.contiguous()
    bias = b.float().contiguous() if b is not None else None  # added in f32, as in the plain version
    out = torch.empty((M, N), dtype=out_dtype, device=dev)
    if M == 0:
        return out.reshape(*xq.shape[:-1], N)
    code = _build.lib().norma_q8a8(
        x2.data_ptr(), s2.data_ptr(), wq.data_ptr(), ws.data_ptr(),
        bias.data_ptr() if bias is not None else None, out.data_ptr(),
        M, N, K, plan["bn"], int(out_dtype == torch.bfloat16), _build.stream_ptr(dev),
    )
    _build.check(code, "q8a8 kernel")
    q8a8_dense.launches += 1
    return out.reshape(*xq.shape[:-1], N)


q8a8_dense.launches = 0


@torch.no_grad()
def q8a8_qkv(
    xq: torch.Tensor,
    xs: torch.Tensor,
    wq: torch.Tensor,
    ws: torch.Tensor,
    b: torch.Tensor,
    out_dtype: torch.dtype = torch.float32,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fused-QKV w8a8: xq [..., in] @ wq [in, 3, out] -> three [..., out]
    of ``out_dtype`` (slices of one [..., 3, out] result), ws/b [3, out]
    (zero bias in the K slot).  One product over the flattened [in, 3*out]
    weight, through :func:`q8a8_dense`; for K-major codes (strides (1,
    out*in, in)) the flattening is a view."""
    K, three, O = wq.shape
    y = q8a8_dense(xq, xs, wq.reshape(K, three * O), ws.reshape(-1), b.reshape(-1), out_dtype)
    y = y.unflatten(-1, (three, O))
    return y[..., 0, :], y[..., 1, :], y[..., 2, :]
