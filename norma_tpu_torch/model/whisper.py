"""Whisper encoder/decoder in PyTorch (``norma_tpu/model/whisper.py``).

Functions take a :class:`~norma_tpu_torch.model.load.Params` tree and keep
the JAX package's layouts at their boundaries: mel [B, n_mels, T], audio
features [B, Ta, D], cross-K/V and self-attention caches stacked as
[L, B, T, D].  Inference only (no autograd).

Every product accumulates in f32 and is rounded once to the activation
dtype, after the bias add (the JAX package's ``preferred_element_type``):
bf16 weights never round a product twice, and the logits head returns
unrounded f32 logits (:func:`~norma_tpu_torch.ops.quant_matmul.mm_f32`).

Quantized trees (``model/quant.py``) dispatch per key: ``name_q`` /
``name_s`` int8 weights run dequantize-then-matmul (w8a16, :func:`ldense`)
in the decoder and, under ``encoder_q8_mode="w8a16"``, in the encoder;
"w8a8" / "w8a8_pallas" run the encoder's six projections through the int8
GEMM (:func:`~norma_tpu_torch.ops.quant_matmul.q8a8_dense`).  The token
loop's cross-attention runs over int8 / int4 codes when the engine
quantizes the cross-K/V: the stacked kernel layout
(``ops/paged_cross.py``) or the plain per-channel dict
(:func:`attention_cross_q8`).

Differences from the JAX form, all outcome-neutral:
  - the layer scans are Python loops over per-layer views;
  - :func:`decoder_step` writes the step's K/V row into the caches IN PLACE
    and returns the same tensors (JAX returns updated copies).
"""

from __future__ import annotations

import functools
import math
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..ops.flash_encoder import flash_self_attention
from ..ops.paged_cross import cross_attention_q8_kernel, cross_attention_q8_kernel_stacked
from ..ops.quant_matmul import mm_f32, q8a8_dense, q8a8_qkv, quantize_activations, w8_matmul
from ..ops.self_decode import self_attention_decode
from .config import WhisperConfig
from .load import Params, sinusoids  # noqa: F401  (sinusoids re-exported)

Layer = Dict[str, torch.Tensor]
XKV = Dict[str, torch.Tensor]

LN_EPS = 1e-5

# encoder_attn_impl values: the flash kernel, or the plain attention (on
# Hopper "auto" and the TPU's query-chunked "chunked" are the same math as
# "xla").
_FLASH_IMPLS = ("flash", "jax_flash")
_PLAIN_IMPLS = ("xla", "auto", "chunked")
_Q8_MODES = ("w8a8", "w8a16", "w8a8_pallas")
_CROSS_IMPLS = ("einsum", "kernel", "chunked", "a8")


def layer_norm(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """LayerNorm over the last axis, computed in f32, eps 1e-5."""
    y = F.layer_norm(x.float(), (x.shape[-1],), g.float(), b.float(), LN_EPS)
    return y.to(x.dtype)


@functools.lru_cache(maxsize=None)
def _scalar(v: float, dtype: torch.dtype) -> float:
    """``v`` rounded to ``dtype``: the JAX package multiplies an activation
    by a Python float in the activation's dtype (weak typing), so in bf16
    the factor itself is rounded first."""
    return float(torch.tensor(v, dtype=torch.float64).to(dtype))


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU with the JAX package's rounding points: in f32 the
    fused form; in a narrower dtype ``jax.nn.gelu``'s op-by-op form,
    0.5 * x * erfc(-x * sqrt(1/2)), each op rounded to the dtype."""
    if x.dtype == torch.float32:
        return F.gelu(x, approximate="none")
    return (0.5 * x) * torch.special.erfc(-x * _scalar(math.sqrt(0.5), x.dtype))


def _finish(y: torch.Tensor, bias: Optional[torch.Tensor], dtype: torch.dtype) -> torch.Tensor:
    """f32 product (+ f32 bias), rounded once to ``dtype``."""
    if bias is not None:
        y = y + bias.float()
    return y.to(dtype)


def dense(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x [..., in] @ w [in, out] (+ b), f32 accumulation, one rounding."""
    return _finish(mm_f32(x, w.to(x.dtype)), b, x.dtype)


def ldense(lp: Layer, name: str, x: torch.Tensor, bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Layer dense with int8 dispatch: ``name_q`` int8 codes and ``name_s``
    f32 per-out-channel scales (``quantize_decoder``) are widened to x's
    dtype (exact) and the f32 product is scaled; otherwise the
    full-precision ``name`` weight."""
    qk = name + "_q"
    if qk in lp:
        y = mm_f32(x, lp[qk].to(x.dtype)) * lp[name + "_s"].float()
        return _finish(y, bias, x.dtype)
    return dense(x, lp[name], bias)


def qkv_proj(lp: Layer, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Self-attention Q/K/V projection: one product over a fused ``qkv_w``
    [D, 3, D] (int8 ``qkv_w_q`` + ``qkv_w_s`` [3, D], or full precision;
    :func:`~norma_tpu_torch.model.load.fuse_qkv`), else three."""
    if "qkv_w_q" in lp or "qkv_w" in lp:
        q8 = "qkv_w_q" in lp
        w = lp["qkv_w_q"] if q8 else lp["qkv_w"]
        d_in = w.shape[0]
        y = mm_f32(x, w.reshape(d_in, -1).to(x.dtype)).unflatten(-1, (3, -1))
        if q8:
            y = y * lp["qkv_w_s"].float()
        y = _finish(y, lp["qkv_b"], x.dtype)
        return y[..., 0, :], y[..., 1, :], y[..., 2, :]
    q = ldense(lp, "q_w", x, lp["q_b"])
    k = ldense(lp, "k_w", x)  # whisper k_proj has no bias
    v = ldense(lp, "v_w", x, lp["v_b"])
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

    Whisper scales q and k each by (D/H)**-0.25 (in the activation dtype)
    before the dot product; logits accumulate in f32, the softmax is f32
    and its weights are rounded to the activation dtype for the PV product,
    which accumulates in f32.  Plain matmuls (not SDPA): the reference
    form the kernels are held against.
    """
    dh = q.shape[-1] // n_heads
    scale = _scalar(dh**-0.25, q.dtype)
    qh = (_split_heads(q, n_heads) * scale).float()
    kh = (_split_heads(k, n_heads) * scale).float()
    vh = _split_heads(v, n_heads).float()
    logits = torch.matmul(qh, kh.transpose(-1, -2))  # [B, H, Tq, Tk]
    if mask is not None:
        logits = logits + mask
    w = torch.softmax(logits, dim=-1).to(q.dtype)
    return _merge_heads(torch.matmul(w.float(), vh).to(q.dtype))


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
    scale = _scalar(dh**-0.25, q.dtype)
    qh = (q.reshape(g, b, tq, n_heads, dh).permute(0, 1, 3, 2, 4) * scale).float()
    kh = (_split_heads(k, n_heads)[None] * scale).float()  # [1, B, H, Tk, dh]
    vh = _split_heads(v, n_heads)[None].float()
    logits = torch.matmul(qh, kh.transpose(-1, -2))  # [G, B, H, Tq, Tk]
    w = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.matmul(w.float(), vh).to(q.dtype)  # [G, B, H, Tq, dh]
    return out.permute(0, 1, 3, 2, 4).reshape(gb, tq, d)


def _mlp(lp: Layer, x: torch.Tensor) -> torch.Tensor:
    h = gelu(ldense(lp, "fc1_w", x, lp["fc1_b"]))
    return ldense(lp, "fc2_w", h, lp["fc2_b"])


# --------------------------------------------------------------------------
# Encoder
# --------------------------------------------------------------------------


def _conv1d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, stride: int) -> torch.Tensor:
    """x: [B, Cin, T]; w: [W, Cin, Cout] (the JAX layout; torch wants
    [Cout, Cin, W]); 'same' padding for W=3.  Accumulates in f32 (operands
    widened exactly), bias added in f32, one rounding.  Returns
    [B, Cout, T']."""
    y = F.conv1d(x.float(), w.float().permute(2, 1, 0), b.float(), stride=stride, padding=1)
    return y.to(x.dtype)


def _q8_dense(lp: Layer, name: str, x: torch.Tensor, bias=None) -> torch.Tensor:
    """w8a8 dense (``quantize_encoder``): per-row dynamic int8 activations
    x stored int8 weights through the int8 GEMM."""
    xq, xs = quantize_activations(x)
    return q8a8_dense(xq, xs, lp[name + "_q"], lp[name + "_s"], bias).to(x.dtype)


def _qkv_proj_q8(lp: Layer, x: torch.Tensor):
    """Q/K/V on the w8a8 path: the activation row is quantized ONCE and
    shared by the three projections; a fused [in, 3, out] weight runs as
    one [in, 3*out] product (:func:`~norma_tpu_torch.ops.quant_matmul.
    q8a8_qkv`, ``norma_tpu/model/whisper.py:281-290``)."""
    xq, xs = quantize_activations(x)
    if "qkv_w_q" in lp:
        y = q8a8_qkv(xq, xs, lp["qkv_w_q"], lp["qkv_w_s"], lp["qkv_b"])
    else:
        y = (
            q8a8_dense(xq, xs, lp["q_w_q"], lp["q_w_s"], lp["q_b"]),
            q8a8_dense(xq, xs, lp["k_w_q"], lp["k_w_s"], None),
            q8a8_dense(xq, xs, lp["v_w_q"], lp["v_w_s"], lp["v_b"]),
        )
    return tuple(t.to(x.dtype) for t in y)


def _mlp_q8(lp: Layer, x: torch.Tensor) -> torch.Tensor:
    xq, xs = quantize_activations(x)
    h = F.gelu(q8a8_dense(xq, xs, lp["fc1_w_q"], lp["fc1_w_s"], lp["fc1_b"]), approximate="none")
    h = h.to(x.dtype)
    hq, hs = quantize_activations(h)
    return q8a8_dense(hq, hs, lp["fc2_w_q"], lp["fc2_w_s"], lp["fc2_b"]).to(x.dtype)


def encoder_layer(
    lp: Layer, x: torch.Tensor, n_heads: int, flash: bool = False, q8_mode: str = "w8a8"
) -> torch.Tensor:
    """One encoder layer.  ``flash`` runs the self-attention through the
    flash kernel; ``quantize_encoder`` weights (``fc1_w_q`` present) run
    the w8a8 int8 GEMM unless ``q8_mode`` is "w8a16" (dequantize, then the
    bf16/f32 product)."""
    w8a8 = "fc1_w_q" in lp and q8_mode in ("w8a8", "w8a8_pallas")
    h = layer_norm(x, lp["attn_ln_g"], lp["attn_ln_b"])
    q, k, v = _qkv_proj_q8(lp, h) if w8a8 else qkv_proj(lp, h)
    if flash:
        a = flash_self_attention(q, k, v, n_heads)
    else:
        a = attention(q, k, v, n_heads)
    x = x + (_q8_dense(lp, "o_w", a, lp["o_b"]) if w8a8 else ldense(lp, "o_w", a, lp["o_b"]))
    h = layer_norm(x, lp["mlp_ln_g"], lp["mlp_ln_b"])
    return x + (_mlp_q8(lp, h) if w8a8 else _mlp(lp, h))


def _encoder_flash(cfg: WhisperConfig) -> bool:
    """Whether ``cfg`` selects the flash-attention kernel for the encoder:
    ``flash_attention=True`` or ``encoder_attn_impl`` "flash"/"jax_flash"."""
    impl = cfg.encoder_attn_impl
    if impl not in _FLASH_IMPLS + _PLAIN_IMPLS:
        raise ValueError(f"unknown encoder_attn_impl {impl!r}")
    return impl in _FLASH_IMPLS or bool(cfg.flash_attention)


@torch.no_grad()
def encode(params: Params, cfg: WhisperConfig, mel: torch.Tensor) -> torch.Tensor:
    """mel: [B, n_mels, T_frames] -> audio features [B, T_frames//2, D]."""
    flash = _encoder_flash(cfg)
    if cfg.encoder_q8_mode not in _Q8_MODES:
        raise ValueError(
            f"encoder_q8_mode={cfg.encoder_q8_mode!r}: expected 'w8a8', 'w8a16' or 'w8a8_pallas'"
        )
    enc = params["encoder"]
    x = mel.to(enc["conv1_w"].dtype)
    x = gelu(_conv1d(x, enc["conv1_w"], enc["conv1_b"], 1))
    x = gelu(_conv1d(x, enc["conv2_w"], enc["conv2_b"], 2))
    x = x.transpose(1, 2)  # [B, T, D]
    x = x + enc["pos"][: x.shape[1]].to(x.dtype)
    layers = enc["layers"]
    for i in range(cfg.encoder_layers):
        x = encoder_layer(
            layers.layer(i), x, cfg.encoder_attention_heads, flash, cfg.encoder_q8_mode
        )
    return layer_norm(x, enc["ln_g"], enc["ln_b"])


# --------------------------------------------------------------------------
# Decoder
# --------------------------------------------------------------------------


def logits_head(dec: Params, x: torch.Tensor) -> torch.Tensor:
    """Tied-embedding logits head: [..., D] -> [..., V] unrounded f32.
    An int8 head (``tok_emb_q8``, :func:`~norma_tpu_torch.model.quant.
    quantize_logits_head`) runs w8a16."""
    if "tok_emb_q8" in dec:
        q8 = dec["tok_emb_q8"]
        lead = x.shape[:-1]
        y = w8_matmul(x.reshape(-1, x.shape[-1]), q8["q"], q8["s"])
        return y.reshape(*lead, y.shape[-1])
    return mm_f32(x, dec["tok_emb"].t())


def _cross_proj(layers: Params, name: str, xa: torch.Tensor, bias) -> torch.Tensor:
    """[B, Ta, D] through every layer's ``name`` weight -> [L, B, Ta, D]."""
    qk = name + "_q"
    out = []
    for li in range(layers[qk if qk in layers else name].shape[0]):
        if qk in layers:
            y = mm_f32(xa, layers[qk][li].to(xa.dtype)) * layers[name + "_s"][li].float()
        else:
            y = mm_f32(xa, layers[name][li].to(xa.dtype))
        out.append(_finish(y, None if bias is None else bias[li], xa.dtype))
    return torch.stack(out)


@torch.no_grad()
def cross_kv(
    params: Params, cfg: WhisperConfig, xa: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cross-attention K/V for all decoder layers: xa [B, Ta, D] ->
    (xk, xv) [L, B, Ta, D] (int8 ``xk_w_q`` weights dequantized per
    layer)."""
    layers = params["decoder"]["layers"]
    return _cross_proj(layers, "xk_w", xa, None), _cross_proj(layers, "xv_w", xa, layers["xv_b"])


def _quantize_xkv(x: torch.Tensor, limit: float) -> XKV:
    xf = x.float()
    amax = xf.abs().amax(dim=2)  # [L, B, D]
    s = torch.clamp(amax, min=1e-8) / limit
    q = torch.clamp(torch.round(xf / s[:, :, None, :]), -limit, limit).to(torch.int8)
    return {"q": q, "s": s}


@torch.no_grad()
def quantize_cross_kv(xk: torch.Tensor, xv: torch.Tensor) -> Tuple[XKV, XKV]:
    """Per-channel int8 cross-K/V: [L, B, Ta, D] -> {"q": int8 same shape,
    "s": [L, B, D] f32} with s = max(amax over Ta, 1e-8) / 127.  The scales
    fold exactly into the attention (K onto q, V onto the output), so the
    only approximation is the int8 rounding of K/V.  Built per window
    after prefill; prefill's own cross-attention stays unquantized."""
    return _quantize_xkv(xk, 127.0), _quantize_xkv(xv, 127.0)


@torch.no_grad()
def quantize_cross_kv4(xk: torch.Tensor, xv: torch.Tensor) -> Tuple[XKV, XKV]:
    """Per-channel int4 cross-K/V: codes in [-7, 7] (stored int8; the
    kernel layout packs two per byte), scale = max(amax, 1e-8) / 7."""
    return _quantize_xkv(xk, 7.0), _quantize_xkv(xv, 7.0)


def attention_cross_q8(
    q: torch.Tensor, kq: XKV, vq: XKV, n_heads: int, n_groups: int = 1
) -> torch.Tensor:
    """Cross-attention over per-channel int8 K/V (the plain form).

    q: [G*B, Tq, D] (row g*B + b reads stream b); kq/vq: {"q": [B, Tk, D]
    int8, "s": [B, D] f32}.  Both whisper dh**-0.25 factors and the K scale
    fold onto q in f32 before the cast to q's dtype; the V scale folds onto
    the output."""
    gb, tq, d = q.shape
    b = kq["q"].shape[0]
    g = n_groups
    dh = d // n_heads
    qf = (q.float().reshape(g, b, tq, d) * kq["s"][None, :, None, :] * float(dh) ** -0.5).to(q.dtype)
    qh = qf.reshape(g, b, tq, n_heads, dh).permute(0, 1, 3, 2, 4).float()  # [G, B, H, Tq, dh]
    kh = _split_heads(kq["q"].to(q.dtype), n_heads)[None].float()  # [1, B, H, Tk, dh]
    vh = _split_heads(vq["q"].to(q.dtype), n_heads)[None].float()
    logits = torch.matmul(qh, kh.transpose(-1, -2))
    w = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.matmul(w.float(), vh)  # [G, B, H, Tq, dh]
    out = out.permute(0, 1, 3, 2, 4).reshape(g, b, tq, d) * vq["s"][None, :, None, :]
    return out.to(q.dtype).reshape(gb, tq, d)


def _cross_impl(cfg: WhisperConfig) -> str:
    if cfg.cross_kv_impl not in _CROSS_IMPLS:
        raise ValueError(
            f"cross_kv_impl must be 'einsum', 'chunked', 'a8' or 'kernel', got {cfg.cross_kv_impl!r}"
        )
    return cfg.cross_kv_impl


def cross_q8_attn(
    cfg: WhisperConfig, q: torch.Tensor, kq: XKV, vq: XKV, n_heads: int, n_groups: int = 1
) -> torch.Tensor:
    """Quantized cross-attention for one layer: the kernel over the kernel
    layout (``codes``/``codes4``, built by the engine under
    ``cross_kv_impl="kernel"``), else the plain :func:`attention_cross_q8`
    (also for "chunked" and "a8", TPU forms recorded as losses)."""
    _cross_impl(cfg)
    if "codes" in kq or "codes4" in kq:
        return cross_attention_q8_kernel(q, kq, vq, n_heads, n_groups)
    return attention_cross_q8(q, kq, vq, n_heads, n_groups)


def _decoder_layer_cross_mlp(lp: Layer, x: torch.Tensor, cross_attn: Callable) -> torch.Tensor:
    """The cross-attention + MLP tail of one decoder layer."""
    h = layer_norm(x, lp["xattn_ln_g"], lp["xattn_ln_b"])
    xq = ldense(lp, "xq_w", h, lp["xq_b"])
    x = x + ldense(lp, "xo_w", cross_attn(xq), lp["xo_b"])
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
    """Process a prompt prefix over the unquantized cross-K/V; fill the
    self-attn cache.

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
        x = x + ldense(lp, "o_w", attention(q, k, v, n_heads, causal), lp["o_b"])
        cache_k[i, :, :P] = k
        cache_v[i, :, :P] = v
        x = _decoder_layer_cross_mlp(
            lp, x, lambda xq, i=i: attention(xq, xk[i], xv[i], n_heads)
        )
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
    xk,  # [L, B', Ta, D] with B' = B // n_rungs, or a quantized dict
    xv,
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
    Cross-K/V: tensors run the plain attention; a quantized dict
    ({"q", "s"} stacked over layers) runs :func:`attention_cross_q8` per
    layer; the kernel layout ({"codes"/"codes4", "s"}) runs the stacked
    kernel, which addresses layer ``li`` by index (never a slice).
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

    if isinstance(xk, dict):
        _cross_impl(cfg)  # validated even on the stacked layout
        stacked = "codes" in xk or "codes4" in xk

        def cross_attn(xq, li):
            if stacked:
                return cross_attention_q8_kernel_stacked(xq, xk, xv, li, n_heads, n_rungs)
            kq = {k: v[li] for k, v in xk.items()}
            vq = {k: v[li] for k, v in xv.items()}
            return cross_q8_attn(cfg, xq, kq, vq, n_heads, n_rungs)
    else:

        def cross_attn(xq, li):
            if n_rungs == 1:
                return attention(xq, xk[li], xv[li], n_heads)
            return attention_grouped(xq, xk[li], xv[li], n_heads, n_rungs)

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
        x = x + ldense(lp, "o_w", a, lp["o_b"])
        x = _decoder_layer_cross_mlp(lp, x, lambda xq, li=li: cross_attn(xq, li))

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
