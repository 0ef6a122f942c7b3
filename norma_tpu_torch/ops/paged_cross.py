"""Cross-attention decode over int8 / int4 cross-K/V codes
(``norma_tpu/ops/paged_cross.py``).

The token loop's cross-attention reads the window's cross-K/V every step;
quantized per channel (``model/whisper.py::quantize_cross_kv`` /
``quantize_cross_kv4``) that stream halves (int8) or quarters (int4).  The
kernel reads the codes and never a dequantized copy.

  - :func:`prep_cross_kv_kernel` / :func:`prep_cross_kv_kernel4` build the
    kernel layout once per window: codes [L, B, H, Ta, dh] int8 (one
    contiguous Ta x dh block per layer, stream and head), or for int4
    [L, B, H, Ta/2, dh] with keys 2r and 2r+1 of one channel in the low and
    high nibble of a byte.  (The TPU layout was transposed,
    [L, H, B, dh, Ta], to put Ta on lanes; parity is on outputs.)  The
    per-channel scales stay [L, B, D] f32;
  - :func:`cross_attention_decode_torch` — the plain PyTorch version (the
    CPU path and the kernel's oracle);
  - :func:`cross_attention_q8_kernel_stacked` — the wrapper over the
    stacked layout with a layer index ``li`` (the arrays are never
    sliced): the CUDA kernel (``csrc/cross_decode.cu``: each (stream, head)
    on a thread-block cluster whose CTAs split the keys,
    :func:`cross_decode_plan`, :func:`cross_decode_ranges`) for CUDA tensors,
    the plain version for CPU tensors; any other device raises.
    ``cross_attention_q8_kernel_stacked.launches`` counts kernel launches;
  - :func:`cross_attention_q8_kernel` — the per-layer form (one layer's
    slices), the same kernel over a stack of one.

Rounding points (the TPU kernel's): q' = bf16((q * k_scale) * dh**-0.5);
f32 logits from bf16 q' and exact integer codes; f32 softmax; bf16(p) for
the PV product with f32 accumulation; (o / l) * v_scale, cast to q's
dtype.  ``n_groups`` G query rows (row g*B + b) share stream b's codes.
"""

from __future__ import annotations

import functools
from typing import Dict, List, Tuple

import torch

from . import _build

XKV = Dict[str, torch.Tensor]

_KERNEL_HEAD_DIM = 64
_KERNEL_MAX_GROUPS = 8
# csrc/cross_decode.cu: largest cluster (16 is the H100's non-portable
# limit; above 8 the launcher sets the attribute), dynamic shared memory a
# CTA may take beside its ~25 KB of static arrays.
_XD_MAX_CLUSTER, _XD_SMEM = 16, 232448 - 28672
# The plan's cluster doubles while the grid has fewer CTAs than this and
# each CTA keeps at least _XD_MIN_ROWS stored code rows: the sweeps of
# 4-warp CTAs (chip_smoke.py phase 6; PERF.md, Findings) put 2 CTAs per
# (stream, head) first at 8 streams and 8 at one.
_XD_TARGET_CTAS, _XD_MIN_ROWS = 256, 128


@functools.lru_cache(maxsize=None)
def cross_decode_plan(B: int, H: int, G: int, Ta: int, int4: bool) -> dict:
    """Launch shape of the cross-decode kernel: each (stream, head) on a
    cluster of ``cluster`` CTAs (a power of two up to 16) that split the
    stored code rows (Ta, or Ta/2 for int4; :func:`cross_decode_ranges`),
    at most ``share`` rows each; a CTA's warps stream their tiles of codes
    through registers and keep the [G, ``pitch``] f32 logits in
    ``smem_bytes`` of dynamic shared memory.  The cluster doubles while the
    grid has fewer than ``_XD_TARGET_CTAS`` CTAs and each CTA keeps
    ``_XD_MIN_ROWS`` rows, and further while the logits would not fit."""
    if B < 1 or H < 1:
        raise ValueError(f"cross_decode_plan: B and H must be positive, got {B}, {H}")
    if not 1 <= G <= _KERNEL_MAX_GROUPS:
        raise ValueError(f"kernel takes 1 to {_KERNEL_MAX_GROUPS} groups, got G={G}")
    if Ta < 1 or (int4 and Ta % 2):
        raise ValueError(f"kernel needs Ta >= 1 (even for int4), got Ta={Ta}")
    R = Ta // 2 if int4 else Ta
    share = lambda c: -(-R // c)
    # The keys of a share rounded up to whole 16-key tiles, padded so that
    # the rungs' rows of p start on other banks (4 words apart for int8's
    # scalar reads, 8 for int4's pairs).
    pitch = lambda c: -(-share(c) // 16) * 16 * (2 if int4 else 1) + (8 if int4 else 4)
    smem = lambda c: 4 * G * pitch(c)
    C = 1
    while C < _XD_MAX_CLUSTER and (
        (B * H * C < _XD_TARGET_CTAS and share(2 * C) >= _XD_MIN_ROWS) or smem(C) > _XD_SMEM
    ):
        C *= 2
    if smem(C) > _XD_SMEM:
        raise ValueError(
            f"cross_decode kernel: Ta={Ta} at G={G} needs more than {_XD_MAX_CLUSTER} CTAs of shared memory"
        )
    return dict(cluster=C, share=share(C), pitch=pitch(C), smem_bytes=smem(C), grid=(C, H, B),
                nonportable=C > 8)


def cross_decode_ranges(Ta: int, cluster: int, int4: bool) -> List[Tuple[int, int]]:
    """The keys [lo, hi) each CTA of a cluster takes: the kernel's own
    formula over the stored rows R (rank * R / C, integer division), two
    keys per stored row for int4."""
    R, k = (Ta // 2, 2) if int4 else (Ta, 1)
    return [(k * (r * R // cluster), k * ((r + 1) * R // cluster)) for r in range(cluster)]


def _to_kernel_layout(codes: torch.Tensor, n_heads: int) -> torch.Tensor:
    L, B, Ta, D = codes.shape
    dh = D // n_heads
    return codes.reshape(L, B, Ta, n_heads, dh).permute(0, 1, 3, 2, 4).contiguous()


def prep_cross_kv_kernel(kq: XKV, vq: XKV, n_heads: int) -> Tuple[XKV, XKV]:
    """``quantize_cross_kv`` output ({"q": [L, B, Ta, D] int8, "s":
    [L, B, D] f32}) -> ({"codes": [L, B, H, Ta, dh] int8, "s"}, ...)."""
    return (
        {"codes": _to_kernel_layout(kq["q"], n_heads), "s": kq["s"]},
        {"codes": _to_kernel_layout(vq["q"], n_heads), "s": vq["s"]},
    )


def pack_int4(codes: torch.Tensor) -> torch.Tensor:
    """[..., Ta, dh] int8 codes in [-7, 7] -> [..., Ta/2, dh] bytes holding
    key 2r in the low nibble and key 2r+1 in the high nibble."""
    lo = codes[..., 0::2, :].to(torch.int32)
    hi = codes[..., 1::2, :].to(torch.int32)
    packed = (hi << 4) | (lo & 0xF)
    return torch.where(packed > 127, packed - 256, packed).to(torch.int8)


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pack_int4` (sign-extended nibbles)."""
    w = packed.to(torch.int32)
    lo = (w << 28) >> 28
    hi = w >> 4
    out = torch.stack([lo, hi], dim=-2)  # [..., Ta/2, 2, dh]
    return out.flatten(-3, -2).to(torch.int8)


def prep_cross_kv_kernel4(kq: XKV, vq: XKV, n_heads: int) -> Tuple[XKV, XKV]:
    """``quantize_cross_kv4`` output -> ({"codes4": [L, B, H, Ta/2, dh]
    int8, "s"}, ...).  Ta must be even."""
    Ta = kq["q"].shape[2]
    if Ta % 2:
        raise ValueError(f"Ta {Ta} must be even for nibble packing")
    return (
        {"codes4": pack_int4(_to_kernel_layout(kq["q"], n_heads)), "s": kq["s"]},
        {"codes4": pack_int4(_to_kernel_layout(vq["q"], n_heads)), "s": vq["s"]},
    )


def _codes(kp: XKV) -> Tuple[torch.Tensor, bool]:
    if "codes4" in kp:
        return kp["codes4"], True
    return kp["codes"], False


def _validate(q, kp, vp, li, n_heads, n_groups):
    kc, int4 = _codes(kp)
    vc, vint4 = _codes(vp)
    if int4 != vint4 or kc.shape != vc.shape or kc.dtype != torch.int8 or vc.dtype != torch.int8:
        raise ValueError("K and V codes must share one int8 layout")
    if kc.dim() != 5:
        raise ValueError(f"codes must be [L, B, H, Ta(/2), dh], got {tuple(kc.shape)}")
    L, B, H, rows, dh = kc.shape
    Ta = 2 * rows if int4 else rows
    D = H * dh
    if H != n_heads:
        raise ValueError(f"codes carry {H} heads, expected {n_heads}")
    if q.dim() != 3 or q.shape[1] != 1 or q.shape[0] != n_groups * B or q.shape[2] != D:
        raise ValueError(
            f"q must be [{n_groups}*{B}, 1, {D}] (single-query decode), got {tuple(q.shape)}"
        )
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"q must be f32 or bf16, got {q.dtype}")
    for s in (kp["s"], vp["s"]):
        if tuple(s.shape) != (L, B, D) or s.dtype != torch.float32:
            raise ValueError(f"scales must be [{L}, {B}, {D}] f32, got {tuple(s.shape)} {s.dtype}")
    devs = {t.device for t in (q, kc, vc, kp["s"], vp["s"])}
    if len(devs) != 1:
        raise ValueError(f"all tensors must be on one device, got {devs}")
    if not 0 <= li < L:
        raise ValueError(f"layer {li} outside [0, {L})")
    return kc, vc, int4, L, B, H, Ta, dh


@torch.no_grad()
def cross_attention_decode_torch(
    q: torch.Tensor,  # [G*B, 1, D]
    kp: XKV,
    vp: XKV,
    li: int,
    n_heads: int,
    n_groups: int = 1,
) -> torch.Tensor:
    """Plain version over the stacked kernel layout -> [G*B, 1, D] in
    q's dtype."""
    kc, vc, int4, L, B, H, Ta, dh = _validate(q, kp, vp, li, n_heads, n_groups)
    G, D = n_groups, H * dh
    k = unpack_int4(kc[li]) if int4 else kc[li]  # [B, H, Ta, dh]
    v = unpack_int4(vc[li]) if int4 else vc[li]
    ks, vs = kp["s"][li], vp["s"][li]  # [B, D]
    qf = (q.float().reshape(G, B, D) * ks[None] * float(dh) ** -0.5).to(torch.bfloat16).float()
    qh = qf.reshape(G, B, H, dh).permute(1, 2, 0, 3)  # [B, H, G, dh]
    logits = torch.matmul(qh, k.float().transpose(-1, -2))  # [B, H, G, Ta]
    p = torch.exp(logits - logits.amax(-1, keepdim=True))
    l = p.sum(-1, keepdim=True)
    o = torch.matmul(p.to(torch.bfloat16).float(), v.float()) / l  # [B, H, G, dh]
    o = o.permute(2, 0, 1, 3).reshape(G, B, D) * vs[None]
    return o.to(q.dtype).reshape(G * B, 1, D)


@torch.no_grad()
def cross_attention_q8_kernel_stacked(
    q: torch.Tensor,
    kp: XKV,
    vp: XKV,
    li: int,
    n_heads: int,
    n_groups: int = 1,
) -> torch.Tensor:
    """Same contract as :func:`cross_attention_decode_torch`.  CUDA
    tensors launch the kernel, CPU tensors run the plain version."""
    li = int(li)
    kc, vc, int4, L, B, H, Ta, dh = _validate(q, kp, vp, li, n_heads, n_groups)
    dev = q.device
    if dev.type == "cpu":
        return cross_attention_decode_torch(q, kp, vp, li, n_heads, n_groups)
    if dev.type != "cuda":
        raise ValueError(f"cross_attention_q8_kernel_stacked: unsupported device {dev}")
    if dh != _KERNEL_HEAD_DIM:
        raise ValueError(f"kernel head_dim must be {_KERNEL_HEAD_DIM}, got {dh}")
    plan = cross_decode_plan(B, H, n_groups, Ta, int4)
    for c in (kc, vc):
        if (c.stride()[2:] != (c.shape[3] * dh, dh, 1) or c.data_ptr() % 16
                or c.stride(0) % 16 or c.stride(1) % 16):
            raise ValueError("codes must be contiguous per (layer, stream) and 16-byte aligned")
        if c.stride() != kc.stride():
            raise ValueError("K and V codes must share strides")
    if q.stride(2) != 1:
        raise ValueError("q must be contiguous in its last axis")
    ks, vs = kp["s"].contiguous(), vp["s"].contiguous()
    D = H * dh
    out = torch.empty((n_groups * B, 1, D), dtype=q.dtype, device=dev)
    code = _build.lib().norma_cross_decode(
        q.data_ptr(), q.stride(0), kc.data_ptr(), vc.data_ptr(), kc.stride(0), kc.stride(1),
        ks.data_ptr(), vs.data_ptr(), ks.stride(0), ks.stride(1), out.data_ptr(), D,
        li, B, H, dh, n_groups, Ta, int(q.dtype == torch.bfloat16), int(int4),
        plan["cluster"], plan["pitch"], float(dh) ** -0.5, _build.stream_ptr(dev),
    )
    _build.check(code, "cross_decode kernel")
    cross_attention_q8_kernel_stacked.launches += 1
    return out


cross_attention_q8_kernel_stacked.launches = 0


def cross_attention_q8_kernel(
    q: torch.Tensor, kp: XKV, vp: XKV, n_heads: int, n_groups: int = 1
) -> torch.Tensor:
    """Per-layer form: ``kp``/``vp`` are one layer's slices ({"codes":
    [B, H, Ta, dh], "s": [B, D]}); runs the stacked kernel over a stack of
    one layer."""
    return cross_attention_q8_kernel_stacked(
        q, {k: v[None] for k, v in kp.items()}, {k: v[None] for k, v in vp.items()},
        0, n_heads, n_groups,
    )
