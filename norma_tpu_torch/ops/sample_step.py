"""Fused per-step grammar + sampling for the decode loop
(``norma_tpu/ops/sample_step.py``).

One decode step's post-logits work — softmax, the stateful timestamp-grammar
mask algebra (reference ``supress_tokens``/``supress_past_timestamps``,
``model.rs:225-277,331-357``), greedy argmax, Gumbel-max temperature
sampling and the chosen token's probability:

  - :func:`sample_step_torch` — the plain PyTorch version (the CPU path and
    the kernel's oracle).  Its t>0 draw takes uniforms ``u`` (or draws them
    from a ``torch.Generator``);
  - :func:`sample_step` — the wrapper: the CUDA kernel
    (``csrc/sample_step.cu``: each row on a thread-block cluster of CTAs
    that each hold a slice of the vocab, :func:`sample_step_plan`) for CUDA
    tensors, whose t>0 draw uses Philox keyed by ``seed`` with counter
    (group, row, step); the plain version for CPU tensors.  It raises on
    dtypes, shapes and devices the kernel does not take, and never falls
    back.  ``sample_step.launches`` counts
    kernel launches;
  - :func:`philox_uniform` — the kernel's uniforms for (seed, step, row,
    token), so a test can feed the plain version the kernel's exact draws:
    the probe kernel for CUDA devices, :func:`philox_uniform_torch` (Philox
    in PyTorch integer arithmetic, bit-equal) for the CPU.

Grammar semantics (in prob space, post-softmax):
  - base = probs + suppress_mask                      (model.rs:331-334)
  - first sampled token: ONLY probs + first_token mask (model.rs:336-338)
  - last token was timestamp: pair rule               (model.rs:252-262)
  - else: sum-of-ts-prob vs max-text-prob rule        (model.rs:263-276)
  - monotonic timestamps via past-ts mask             (model.rs:225-243)
  - deadlock (no finite masked weight): greedy picks V-1, t>0 pushes EOT
                                                      (model.rs:343-346)
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import _build, inference_only

_INF = float("inf")


def _first_index_of_max(x: torch.Tensor) -> torch.Tensor:
    """Per-row first index attaining max(x), NaN treated as +inf: x [B, V]
    -> [B] int64.  (``torch.argmax``'s tie and NaN rules are not part of
    its contract, so the rule is written out.)"""
    V = x.shape[-1]
    key = torch.where(torch.isnan(x), _INF, x)
    ids = torch.arange(V, device=x.device)
    hit = key == key.amax(-1, keepdim=True)
    return torch.where(hit, ids, V).amin(-1)


@torch.no_grad()
def sample_step_torch(
    ll: torch.Tensor,  # [B, V] f32 raw logits for the next token
    m_suppress: torch.Tensor,  # [V] f32 0/-inf
    m_non_ts: torch.Tensor,
    m_ts: torch.Tensor,
    m_first: torch.Tensor,
    prev1: torch.Tensor,  # [B] int last pushed token
    prev2: torch.Tensor,  # [B] int token before that
    last_ts: torch.Tensor,  # [B] int largest timestamp token seen (0 = none)
    step: "int | torch.Tensor",  # scalar or [B] — 0 selects the first-token mask
    temp: torch.Tensor,  # [B] f32 per-row temperature (0 = greedy)
    *,
    eot: int,
    no_timestamps: int,
    u: Optional[torch.Tensor] = None,  # [B, V] uniforms for the t>0 draw
    generator: Optional[torch.Generator] = None,
    greedy_only: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version.  Returns (nxt [B] int32, prob_chosen [B] f32,
    deadlock [B] bool).  ``greedy_only`` promises every row has temp == 0
    and skips the draw."""
    B, V = ll.shape
    dev = ll.device
    ids = torch.arange(V, device=dev)[None]
    m = ll.amax(-1, keepdim=True)  # NaN-propagating
    e = torch.exp(ll - m)
    probs = e / e.sum(-1, keepdim=True)

    base = probs + m_suppress[None]
    past = torch.where(
        (ids > no_timestamps) & (ids <= last_ts[:, None]), -_INF, 0.0
    )
    mask_a = torch.where((prev2 >= eot)[:, None], m_ts[None], m_non_ts[None] + past)
    sum_ts = torch.where(ids > no_timestamps, base, 0.0).sum(-1)
    max_txt = torch.where(ids < no_timestamps, base, -_INF).amax(-1)
    force_ts = (sum_ts >= max_txt)[:, None]
    mask_b = torch.where(force_ts, m_non_ts[None] + past, past)
    extra = torch.where((prev1 > no_timestamps)[:, None], mask_a, mask_b)
    masked = base + extra
    step_b = torch.as_tensor(step, device=dev).expand(B)
    masked = torch.where((step_b == 0)[:, None], probs + m_first[None], masked)

    deadlock = ~torch.isfinite(masked.amax(-1))
    greedy = torch.where(deadlock, V - 1, _first_index_of_max(masked))
    if greedy_only:
        nxt = greedy
    else:
        if u is None:
            u = torch.rand((B, V), generator=generator, device=dev)
        g = -torch.log(-torch.log(torch.clamp(u, min=1e-12)))
        z = masked / torch.clamp(temp, min=1e-6)[:, None] + g
        cat = _first_index_of_max(z)
        use_sampling = temp > 0.0
        nxt = torch.where(use_sampling, cat, greedy)
        nxt = torch.where(use_sampling & deadlock, eot, nxt)
    prob = masked.gather(1, nxt[:, None])[:, 0]
    return nxt.to(torch.int32), prob, deadlock


# csrc/sample_step.cu: largest cluster (16 is the H100's non-portable
# limit), largest slice (f32 logits in shared memory).
_SS_MAX_CLUSTER, _SS_MAX_SLICE = 16, 229376 // 4
_H100_SMS = 132


def sample_step_plan(B: int, V: int) -> dict:
    """Launch shape of the sampling kernel for B rows of V logits: each
    row on a cluster of ``cluster`` CTAs (a power of two up to 16) holding
    ``slice`` vocab ids each (a multiple of 4, so no Philox group of 4
    straddles two CTAs) in ``smem_bytes`` of shared memory.  The cluster
    doubles while B x cluster stays within the H100's 132 SMs (8 rows x 16
    = 128) and every CTA keeps some of the row, and further if a slice
    would not fit the shared memory."""
    if B <= 0 or V <= 0:
        raise ValueError(f"sample_step_plan: B and V must be positive, got {B}, {V}")
    slice_of = lambda c: -(-(-(-V // c)) // 4) * 4
    cluster = 1
    while cluster < _SS_MAX_CLUSTER and (
        (B * 2 * cluster <= _H100_SMS and (2 * cluster - 1) * slice_of(2 * cluster) < V)
        or slice_of(cluster) > _SS_MAX_SLICE
    ):
        cluster *= 2
    if slice_of(cluster) > _SS_MAX_SLICE:
        raise ValueError(f"sample_step kernel: V={V} needs more than {_SS_MAX_CLUSTER} slices of shared memory")
    L = slice_of(cluster)
    return dict(cluster=cluster, slice=L, smem_bytes=4 * L, grid=(cluster, B))


def _validate(ll, masks, rows, temp, step) -> None:
    if ll.dim() != 2 or ll.dtype != torch.float32 or not ll.is_contiguous():
        raise ValueError(f"logits must be contiguous f32 [B, V], got {ll.dtype} {tuple(ll.shape)}")
    B, V = ll.shape
    for mk in masks:
        if mk.dtype != torch.float32 or tuple(mk.shape) != (V,) or not mk.is_contiguous():
            raise ValueError(f"masks must be contiguous f32 [{V}]")
    for t in rows:
        if t.dtype != torch.int32 or tuple(t.shape) != (B,) or not t.is_contiguous():
            raise ValueError(f"prev1/prev2/last_ts must be contiguous int32 [{B}]")
    if temp.dtype != torch.float32 or tuple(temp.shape) != (B,) or not temp.is_contiguous():
        raise ValueError(f"temp must be contiguous f32 [{B}]")
    if isinstance(step, torch.Tensor) and (
        step.dtype != torch.int32 or tuple(step.shape) != (B,) or not step.is_contiguous()
    ):
        raise ValueError(f"a per-row step must be contiguous int32 [{B}]")
    tensors = [ll, *masks, *rows, temp] + ([step] if isinstance(step, torch.Tensor) else [])
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"all tensors must be on one device, got {devs}")


@inference_only
def sample_step(
    ll: torch.Tensor,
    m_suppress: torch.Tensor,
    m_non_ts: torch.Tensor,
    m_ts: torch.Tensor,
    m_first: torch.Tensor,
    prev1: torch.Tensor,
    prev2: torch.Tensor,
    last_ts: torch.Tensor,
    step: "int | torch.Tensor",
    temp: torch.Tensor,
    *,
    eot: int,
    no_timestamps: int,
    seed: "int | torch.Tensor" = 0,
    generator: Optional[torch.Generator] = None,
    greedy_only: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fused step; same contract as :func:`sample_step_torch`.  CUDA tensors
    launch the kernel (t>0 draws from Philox keyed by the 64-bit ``seed``,
    an ``int`` or one int64 on the device holding its bits; ``generator``
    is unused), CPU tensors run the plain version (t>0 draws from
    ``generator``; ``seed`` is unused)."""
    masks = (m_suppress, m_non_ts, m_ts, m_first)
    _validate(ll, masks, (prev1, prev2, last_ts), temp, step)
    dev = ll.device
    if dev.type == "cpu":
        return sample_step_torch(
            ll, *masks, prev1, prev2, last_ts, step, temp,
            eot=eot, no_timestamps=no_timestamps, generator=generator,
            greedy_only=greedy_only,
        )
    if dev.type != "cuda":
        raise ValueError(f"sample_step: unsupported device {dev}")
    B, V = ll.shape
    plan = sample_step_plan(B, V)
    nxt = torch.empty(B, dtype=torch.int32, device=dev)
    prob = torch.empty(B, dtype=torch.float32, device=dev)
    dead = torch.empty(B, dtype=torch.bool, device=dev)
    per_row = isinstance(step, torch.Tensor)
    dev_seed = isinstance(seed, torch.Tensor)
    if dev_seed and (seed.dtype != torch.int64 or seed.numel() != 1 or seed.device != dev):
        raise ValueError(f"a device seed must be one int64 on {dev}")
    _build.launch(
        "norma_sample_step", sample_step, dev,
        ll.data_ptr(), *(mk.data_ptr() for mk in masks),
        prev1.data_ptr(), prev2.data_ptr(), last_ts.data_ptr(),
        0 if per_row else int(step), step.data_ptr() if per_row else None,
        temp.data_ptr(), 0 if dev_seed else seed & 0xFFFFFFFFFFFFFFFF,
        seed.data_ptr() if dev_seed else None,
        B, V, plan["cluster"], plan["slice"], eot, no_timestamps, int(greedy_only),
        nxt.data_ptr(), prob.data_ptr(), dead.data_ptr(),
    )
    return nxt, prob, dead


sample_step.launches = 0


# Philox4x32-10 (Salmon et al., SC'11), as csrc/common.cuh has it.
_PHILOX_M0, _PHILOX_M1 = 0xD2511F53, 0xCD9E8D57
_PHILOX_W0, _PHILOX_W1 = 0x9E3779B9, 0xBB67AE85
_U32 = 0xFFFFFFFF


def _mul_hi_lo(m: int, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) 32-bit halves of the 64-bit product m * x, m and x below
    2^32, in int64 without overflow: x in 16-bit limbs, each partial
    product below 2^48."""
    p_lo = m * (x & 0xFFFF)
    mid = m * (x >> 16) + (p_lo >> 16)
    return mid >> 16, ((mid & 0xFFFF) << 16) | (p_lo & 0xFFFF)


def philox4x32_10(ctr: torch.Tensor, key: Tuple[int, int]) -> torch.Tensor:
    """Philox4x32-10 over counters ``ctr`` [..., 4] (int64 holding uint32
    words) with the 64-bit key (k0, k1) -> the four 32-bit outputs [..., 4]
    as int64."""
    c0, c1, c2, c3 = ctr.unbind(-1)
    k0, k1 = key[0] & _U32, key[1] & _U32
    for _ in range(10):
        hi0, lo0 = _mul_hi_lo(_PHILOX_M0, c0)
        hi1, lo1 = _mul_hi_lo(_PHILOX_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0, k1 = (k0 + _PHILOX_W0) & _U32, (k1 + _PHILOX_W1) & _U32
    return torch.stack((c0, c1, c2, c3), -1)


def uniform_from_bits(bits: torch.Tensor) -> torch.Tensor:
    """32 random bits (int64 holding uint32) -> f32 uniforms in [1e-12, 1):
    the top 23 bits times 2^-23, clamped away from 0 (``norma::
    uniform_from_bits``; the JAX package's ``uniform_from_bits``)."""
    return torch.clamp((bits >> 9).to(torch.float32) * (1.0 / (1 << 23)), min=1e-12)


@torch.no_grad()
def philox_uniform_torch(seed: int, step: int, rows: int, V: int, device="cpu") -> torch.Tensor:
    """Plain version of the Philox probe: uniforms [rows, V] f32, token j of
    row r from word j % 4 of Philox4x32-10 at counter (j // 4, r, step, 0)
    and key (seed bits 0-31, 32-63) -- the sampling kernel's t>0 draws."""
    seed &= 0xFFFFFFFFFFFFFFFF
    groups = -(-V // 4)
    c = torch.arange(groups, dtype=torch.int64, device=device)[None].expand(rows, groups)
    r = torch.arange(rows, dtype=torch.int64, device=device)[:, None].expand(rows, groups)
    ctr = torch.stack((c, r, torch.full_like(c, int(step) & _U32), torch.zeros_like(c)), -1)
    bits = philox4x32_10(ctr, (seed & _U32, seed >> 32))
    return uniform_from_bits(bits.reshape(rows, 4 * groups)[:, :V]).contiguous()


@torch.no_grad()
def philox_uniform(seed: int, step: int, rows: int, V: int, device) -> torch.Tensor:
    """The uniforms [rows, V] the CUDA sampler draws at (seed, step): feed
    them to :func:`sample_step_torch` as ``u`` to replay a kernel draw.  A
    CUDA device launches the probe kernel (``philox_uniform.launches``
    counts it), the CPU runs :func:`philox_uniform_torch`; any other device
    raises."""
    device = torch.device(device)
    if device.type == "cpu":
        return philox_uniform_torch(seed, step, rows, V)
    if device.type != "cuda":
        raise ValueError(f"philox_uniform: unsupported device {device}")
    if rows <= 0 or V <= 0 or rows > 65535:
        raise ValueError(f"philox_uniform: rows must be in 1..65535 and V positive, got {rows}, {V}")
    out = torch.empty((rows, V), dtype=torch.float32, device=device)
    _build.launch(
        "norma_philox_uniform", philox_uniform, device,
        seed & 0xFFFFFFFFFFFFFFFF, int(step), rows, V, out.data_ptr(),
    )
    return out


philox_uniform.launches = 0
