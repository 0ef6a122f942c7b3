"""Whisper encoder/decoder in PyTorch (``norma_tpu/model/whisper.py``, exact
non-quantized path).

Functions take a :class:`~norma_tpu_torch.model.load.Params` tree and keep
the JAX package's layouts at their boundaries: mel [B, n_mels, T], audio
features [B, Ta, D], cross-K/V and self-attention caches stacked as
[L, B, T, D].  Inference only (no autograd).

Differences from the JAX form, all outcome-neutral:
  - the layer scans are Python loops over per-layer views;
  - :func:`decoder_step` writes the step's K/V row into the caches IN PLACE
    and returns the same tensors (JAX returns updated copies);
  - bf16 matmuls return bf16 (JAX accumulates into f32 and casts after the
    bias add); the f32 path is exact either way.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..ops.self_decode import self_attention_decode
from .config import WhisperConfig
from .load import Params, sinusoids  # noqa: F401  (sinusoids re-exported)

Layer = Dict[str, torch.Tensor]

LN_EPS = 1e-5


def layer_norm(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """LayerNorm over the last axis, computed in f32, eps 1e-5."""
    y = F.layer_norm(x.float(), (x.shape[-1],), g.float(), b.float(), LN_EPS)
    return y.to(x.dtype)


def dense(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x [..., in] @ w [in, out] (+ b)."""
    y = torch.matmul(x, w)
    return y if b is None else y + b


def qkv_proj(lp: Layer, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Self-attention Q/K/V projection: one matmul over a fused ``qkv_w``
    [D, 3, D] (:func:`~norma_tpu_torch.model.load.fuse_qkv`), else three."""
    if "qkv_w" in lp:
        w = lp["qkv_w"]
        d_in = w.shape[0]
        y = torch.matmul(x, w.reshape(d_in, -1)).unflatten(-1, (3, -1))
        y = y + lp["qkv_b"]
        return y[..., 0, :], y[..., 1, :], y[..., 2, :]
    q = dense(x, lp["q_w"], lp["q_b"])
    k = dense(x, lp["k_w"])  # whisper k_proj has no bias
    v = dense(x, lp["v_w"], lp["v_b"])
    return q, k, v


def _split_heads(x: torch.Tensor, n_heads: int) -> torch.Tensor:
    # [B, T, D] -> [B, H, T, dh]
    b, t, d = x.shape
    return x.reshape(b, t, n_heads, d // n_heads).transpose(1, 2)


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    # [B, H, T, dh] -> [B, T, D]
    b, h, t, dh = x.shape
    return x.transpose(1, 2).reshape(b, t, h * dh)


def attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    n_heads: int,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Multi-head attention core; q/k/v: [B, T, D] projected inputs.

    Whisper scales q and k each by (D/H)**-0.25 before the dot product.
    Plain matmul + f32 softmax (not SDPA): the reference form a fused
    attention kernel is held against.
    """
    dh = q.shape[-1] // n_heads
    scale = dh**-0.25
    qh = _split_heads(q, n_heads) * scale
    kh = _split_heads(k, n_heads) * scale
    vh = _split_heads(v, n_heads)
    logits = torch.matmul(qh, kh.transpose(-1, -2)).float()  # [B, H, Tq, Tk]
    if mask is not None:
        logits = logits + mask
    w = torch.softmax(logits, dim=-1).to(q.dtype)
    return _merge_heads(torch.matmul(w, vh))


def attention_grouped(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, n_heads: int, n_groups: int
) -> torch.Tensor:
    """Cross-attention where ``n_groups`` query rows share one K/V stream.

    q: [G*B, Tq, D] with row ``g*B + b`` attending to k/v row ``b``;
    k, v: [B, Tk, D].  The temperature ladder's G rungs of one window
    share the encoder's cross-K/V instead of tiling it G times.
    """
    gb, tq, d = q.shape
    b = k.shape[0]
    g = n_groups
    dh = d // n_heads
    scale = dh**-0.25
    qh = q.reshape(g, b, tq, n_heads, dh).permute(0, 1, 3, 2, 4) * scale
    kh = _split_heads(k, n_heads)[None] * scale  # [1, B, H, Tk, dh]
    vh = _split_heads(v, n_heads)[None]
    logits = torch.matmul(qh, kh.transpose(-1, -2)).float()  # [G, B, H, Tq, Tk]
    w = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.matmul(w, vh)  # [G, B, H, Tq, dh]
    return out.permute(0, 1, 3, 2, 4).reshape(gb, tq, d)


def _mlp(lp: Layer, x: torch.Tensor) -> torch.Tensor:
    h = F.gelu(dense(x, lp["fc1_w"], lp["fc1_b"]), approximate="none")
    return dense(h, lp["fc2_w"], lp["fc2_b"])


# --------------------------------------------------------------------------
# Encoder
# --------------------------------------------------------------------------


def _conv1d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, stride: int) -> torch.Tensor:
    """x: [B, Cin, T]; w: [W, Cin, Cout] (the JAX layout; torch wants
    [Cout, Cin, W]); 'same' padding for W=3.  Returns [B, Cout, T']."""
    return F.conv1d(x, w.permute(2, 1, 0), b, stride=stride, padding=1)


def encoder_layer(lp: Layer, x: torch.Tensor, n_heads: int) -> torch.Tensor:
    h = layer_norm(x, lp["attn_ln_g"], lp["attn_ln_b"])
    q, k, v = qkv_proj(lp, h)
    x = x + dense(attention(q, k, v, n_heads), lp["o_w"], lp["o_b"])
    h = layer_norm(x, lp["mlp_ln_g"], lp["mlp_ln_b"])
    return x + _mlp(lp, h)


@torch.no_grad()
def encode(params: Params, cfg: WhisperConfig, mel: torch.Tensor) -> torch.Tensor:
    """mel: [B, n_mels, T_frames] -> audio features [B, T_frames//2, D].

    Runs the plain ("xla") encoder attention on every device: the JAX
    package's "auto" resolves to it off the TPU.
    """
    enc = params["encoder"]
    x = mel.to(enc["conv1_w"].dtype)
    x = F.gelu(_conv1d(x, enc["conv1_w"], enc["conv1_b"], 1), approximate="none")
    x = F.gelu(_conv1d(x, enc["conv2_w"], enc["conv2_b"], 2), approximate="none")
    x = x.transpose(1, 2)  # [B, T, D]
    x = x + enc["pos"][: x.shape[1]].to(x.dtype)
    layers = enc["layers"]
    for i in range(cfg.encoder_layers):
        x = encoder_layer(layers.layer(i), x, cfg.encoder_attention_heads)
    return layer_norm(x, enc["ln_g"], enc["ln_b"])


# --------------------------------------------------------------------------
# Decoder
# --------------------------------------------------------------------------


def logits_head(dec: Params, x: torch.Tensor) -> torch.Tensor:
    """Tied-embedding logits head: [..., D] -> [..., V] f32 (bf16 params
    round the logits to bf16 before the f32 cast)."""
    return torch.matmul(x, dec["tok_emb"].t()).float()


@torch.no_grad()
def cross_kv(
    params: Params, cfg: WhisperConfig, xa: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cross-attention K/V for all decoder layers in one batched matmul over
    the stacked [L, D, D] weights: xa [B, Ta, D] -> (xk, xv) [L, B, Ta, D]."""
    layers = params["decoder"]["layers"]
    xk = torch.matmul(xa[None], layers["xk_w"][:, None])
    xv = torch.matmul(xa[None], layers["xv_w"][:, None]) + layers["xv_b"][:, None, None, :]
    return xk, xv


def _decoder_layer_cross_mlp(lp, x, lxk, lxv, n_heads, n_rungs):
    """The cross-attention + MLP tail of one decoder layer."""
    h = layer_norm(x, lp["xattn_ln_g"], lp["xattn_ln_b"])
    xq = dense(h, lp["xq_w"], lp["xq_b"])
    if n_rungs == 1:
        a = attention(xq, lxk, lxv, n_heads)
    else:
        a = attention_grouped(xq, lxk, lxv, n_heads, n_rungs)
    x = x + dense(a, lp["xo_w"], lp["xo_b"])
    h = layer_norm(x, lp["mlp_ln_g"], lp["mlp_ln_b"])
    return x + _mlp(lp, h)


@torch.no_grad()
def decoder_prefill(
    params: Params,
    cfg: WhisperConfig,
    tokens: torch.Tensor,  # [B, P] int
    xk: torch.Tensor,
    xv: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Process a prompt prefix; fill the self-attn cache.

    Returns (logits [B, P, V] f32, cache_k, cache_v [L, B, Tmax, D]) where
    rows [0, P) of the caches are populated and the rest are zeros.
    """
    dec = params["decoder"]
    B, P = tokens.shape
    L, D = cfg.decoder_layers, cfg.d_model
    n_heads = cfg.decoder_attention_heads
    dtype = dec["tok_emb"].dtype
    dev = tokens.device

    x = dec["tok_emb"][tokens.long()] + dec["pos_emb"][:P]
    causal = torch.triu(
        torch.full((P, P), float("-inf"), device=dev), diagonal=1
    )
    cache_k = torch.zeros((L, B, cfg.max_target_positions, D), dtype=dtype, device=dev)
    cache_v = torch.zeros_like(cache_k)
    layers = dec["layers"]
    for i in range(L):
        lp = layers.layer(i)
        h = layer_norm(x, lp["attn_ln_g"], lp["attn_ln_b"])
        q, k, v = qkv_proj(lp, h)
        x = x + dense(attention(q, k, v, n_heads, causal), lp["o_w"], lp["o_b"])
        cache_k[i, :, :P] = k
        cache_v[i, :, :P] = v
        x = _decoder_layer_cross_mlp(lp, x, xk[i], xv[i], n_heads, 1)
    x = layer_norm(x, dec["ln_g"], dec["ln_b"])
    return logits_head(dec, x), cache_k, cache_v


@torch.no_grad()
def decoder_step(
    params: Params,
    cfg: WhisperConfig,
    tok: torch.Tensor,  # [B] int — token at position ``pos``
    pos: int,
    cache_k: torch.Tensor,  # [L, B, T, D] (T may be a bucket crop)
    cache_v: torch.Tensor,
    xk: torch.Tensor,  # [L, B', Ta, D] with B' = B // n_rungs
    xv: torch.Tensor,
    n_rungs: int = 1,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One incremental decode step.  Returns (logits [B, V] f32, cache_k,
    cache_v), the caches being the SAME tensors with row ``pos`` of every
    layer written in place.

    The key mask ``idx <= pos`` is taken from the cache's own length, so a
    cropped cache (``cache[:, :, :S]``, the bucketed decode chain) works.
    ``n_rungs > 1`` (speculative temperature ladder): rows are laid out
    ``r*B' + b`` and share stream ``b``'s cross-K/V.
    ``cfg.self_kv_impl`` selects the self-attention: "xla" writes the row
    and runs the plain masked :func:`attention`; "kernel" runs
    :func:`~norma_tpu_torch.ops.self_decode.self_attention_decode`.
    """
    dec = params["decoder"]
    n_heads = cfg.decoder_attention_heads
    T = cache_k.shape[2]
    if not 0 <= pos < T:
        raise ValueError(f"position {pos} outside the cache's {T} rows")
    if cfg.self_kv_impl not in ("xla", "kernel"):
        raise ValueError(f"unknown self_kv_impl {cfg.self_kv_impl!r}")
    use_kernel = cfg.self_kv_impl == "kernel"

    x = (dec["tok_emb"][tok.long()] + dec["pos_emb"][pos])[:, None, :]
    key_mask = None
    if not use_kernel:
        idx = torch.arange(T, device=tok.device)
        key_mask = torch.where(idx <= pos, 0.0, float("-inf"))

    layers = dec["layers"]
    for li in range(cfg.decoder_layers):
        lp = layers.layer(li)
        h = layer_norm(x, lp["attn_ln_g"], lp["attn_ln_b"])
        q, k, v = qkv_proj(lp, h)
        if use_kernel:
            a, _, _ = self_attention_decode(q, k, v, cache_k, cache_v, li, pos, n_heads)
        else:
            cache_k[li, :, pos] = k[:, 0]
            cache_v[li, :, pos] = v[:, 0]
            a = attention(q, cache_k[li], cache_v[li], n_heads, key_mask)
        x = x + dense(a, lp["o_w"], lp["o_b"])
        x = _decoder_layer_cross_mlp(lp, x, xk[li], xv[li], n_heads, n_rungs)

    x = layer_norm(x, dec["ln_g"], dec["ln_b"])
    return logits_head(dec, x[:, 0, :]), cache_k, cache_v


@torch.no_grad()
def decoder_full(
    params: Params, cfg: WhisperConfig, tokens: torch.Tensor, xa: torch.Tensor
) -> torch.Tensor:
    """Non-incremental full forward (the semantics oracle for tests).

    tokens: [B, T]; xa: [B, Ta, D].  Returns logits [B, T, V] f32.
    """
    xk, xv = cross_kv(params, cfg, xa)
    logits, _, _ = decoder_prefill(params, cfg, tokens, xk, xv)
    return logits
