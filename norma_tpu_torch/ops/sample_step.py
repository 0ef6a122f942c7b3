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
    token), so a test can feed the plain version the kernel's exact draws.

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

from . import _build

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


@torch.no_grad()
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
    code = _build.lib().norma_sample_step(
        ll.data_ptr(), *(mk.data_ptr() for mk in masks),
        prev1.data_ptr(), prev2.data_ptr(), last_ts.data_ptr(),
        0 if per_row else int(step), step.data_ptr() if per_row else None,
        temp.data_ptr(), 0 if dev_seed else seed & 0xFFFFFFFFFFFFFFFF,
        seed.data_ptr() if dev_seed else None,
        B, V, plan["cluster"], plan["slice"], eot, no_timestamps, int(greedy_only),
        nxt.data_ptr(), prob.data_ptr(), dead.data_ptr(),
        _build.stream_ptr(dev),
    )
    _build.check(code, "sample_step kernel")
    sample_step.launches += 1
    return nxt, prob, dead


sample_step.launches = 0


@torch.no_grad()
def philox_uniform(seed: int, step: int, rows: int, V: int, device) -> torch.Tensor:
    """The uniforms [rows, V] the CUDA sampler draws at (seed, step): feed
    them to :func:`sample_step_torch` as ``u`` to replay a kernel draw."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"philox_uniform runs on CUDA only, got {device}")
    out = torch.empty((rows, V), dtype=torch.float32, device=device)
    code = _build.lib().norma_philox_uniform(
        seed & 0xFFFFFFFFFFFFFFFF, int(step), rows, V, out.data_ptr(),
        _build.stream_ptr(device),
    )
    _build.check(code, "philox_uniform kernel")
    return out
