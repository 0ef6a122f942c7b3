"""Whisper encoder/decoder in PyTorch (``norma_tpu/model/whisper.py``).

Functions take a :class:`~norma_tpu_torch.model.load.Params` tree and keep
the JAX package's layouts at their boundaries: mel [B, n_mels, T], audio
features [B, Ta, D], cross-K/V and self-attention caches stacked as
[L, B, T, D].  :func:`encode`, :func:`cross_kv` and :func:`decoder_prefill`
are differentiable on the plain routes (a config without kernel knobs;
``tools/accuracy_flip_rate.py`` fits through them); the kernel wrappers
refuse a gradient (``ops.inference_only``), the token loop runs without
autograd, and the inference entry points (``DecodeEngine``,
``SpeculativeEngine``, ``WhisperModel``) run under ``torch.no_grad``.

Every product accumulates in f32 and is rounded once to the activation
dtype, after the bias add (the JAX package's ``preferred_element_type``):
bf16 weights never round a product twice, and the logits head returns
unrounded f32 logits (:func:`~norma_tpu_torch.ops.quant_matmul.mm_f32`).

Quantized trees (``model/quant.py``) dispatch per key: ``name_q`` /
``name_s`` int8 weights run w8a16 (:func:`ldense`, through
:func:`~norma_tpu_torch.ops.quant_matmul.w8_dense`: the w8 kernel on the
card, which reads the int8 bytes without a widened copy) in the decoder
and, under ``encoder_q8_mode="w8a16"``, in the encoder; "w8a8" /
"w8a8_pallas" run the encoder's six projections through the int8 GEMM
(:func:`~norma_tpu_torch.ops.quant_matmul.q8a8_dense`); an int4 head
(``tok_emb_q4``) runs :func:`~norma_tpu_torch.ops.quant_matmul.w4_matmul`.
The token loop's cross-attention runs over int8 / int4 codes when the
engine quantizes the cross-K/V: the stacked kernel layout
(``ops/paged_cross.py``) or the plain per-channel dict
(:func:`attention_cross_q8`; under ``cross_kv_impl="a8"``
:func:`attention_cross_q8_a8`, int8 q and softmax weights); its self-attention over an int8 cache with
per-row scales (:func:`attention_self_q8`) when the engine quantizes the
self-K/V.

Tensor parallelism (the JAX package's params under GSPMD, Megatron
layout: ``parallel/sharding.py``).  The layer code is written once, for
one rank: :func:`_encode`, :func:`_decoder_prefill`, :func:`_decoder_step`,
:func:`_decoder_chunk` (the speculative verify and draft passes) and
:func:`_logits_head` are generators that take the rank's shard and a
``tp`` rank (``.index`` on the tp axis, ``.size``; None for no tp) and
yield ``(op, tensor, kwargs)`` where the ranks must meet: "sum" (f32) of
the row-parallel partial products of ``o_w``, ``xo_w`` and ``fc2_w`` and of
the D-sharded tied head, before the bias and the one rounding, as
``jnp.dot(..., preferred_element_type=f32)`` under GSPMD reduces them;
"max" of the row amax where a row is split (the w8a8 activations of
``o_w`` and ``fc2_w``, the int8 self-KV rows, q's rows under "a8"); "gather" of the D-sharded
token embedding and of the int8 head's vocabulary shards.
``parallel/collectives.py::lockstep`` drives every rank of a process
through them; the public functions here run one unsharded rank
(:func:`_solo`: no request is ever made).  Each rank runs ``n_heads /
tp`` heads on its columns, and its caches hold its D / tp columns.

Differences from the JAX form, all outcome-neutral:
  - the layer scans are Python loops over per-layer views;
  - :func:`decoder_step` and :func:`decoder_chunk` (the speculative verify
    pass) write their K/V rows into the caches IN PLACE and return the same
    tensors (JAX returns updated copies).
"""

from __future__ import annotations

import functools
import math
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..ops.flash_encoder import flash_self_attention
from ..ops.paged_cross import cross_attention_q8_kernel, cross_attention_q8_kernel_stacked
from ..ops.quant_matmul import (
    mm_f32,
    q8a8_dense,
    q8a8_qkv,
    quantize_activations,
    w4_matmul,
    w8_dense,
    w8_matmul,
)
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


def _meet(tp, op: str, t: torch.Tensor, **kw):
    """``t`` combined over the tp ranks (a generator: the request is
    yielded to :func:`~norma_tpu_torch.parallel.collectives.lockstep`,
    which sends back this rank's result); ``t`` itself without tensor
    parallelism."""
    if tp is None:
        return t
    return (yield (op, t, kw))


def _solo(gen):
    """The value of a layer generator run without tensor parallelism."""
    try:
        req = next(gen)
    except StopIteration as stop:
        return stop.value
    raise RuntimeError(f"a collective ({req[0]}) outside a tensor-parallel group")


def _heads(n_heads: int, tp) -> int:
    """The heads a rank runs: ``n_heads / tp``."""
    return n_heads if tp is None else n_heads // tp.size


def dense(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x [..., in] @ w [in, out] (+ b), f32 accumulation, one rounding."""
    return _finish(mm_f32(x, w.to(x.dtype)), b, x.dtype)


def ldense(lp: Layer, name: str, x: torch.Tensor, bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Layer dense with int8 dispatch: ``name_q`` int8 codes and ``name_s``
    f32 per-out-channel scales (``quantize_decoder``) run the w8a16
    product (x . codes in f32, times the scale); otherwise the
    full-precision ``name`` weight."""
    qk = name + "_q"
    if qk in lp:
        return _finish(w8_dense(x, lp[qk], lp[name + "_s"]), bias, x.dtype)
    return dense(x, lp[name], bias)


def _row_dense(lp: Layer, name: str, x: torch.Tensor, bias: Optional[torch.Tensor], tp):
    """A row-parallel product (``o_w``, ``xo_w``, ``fc2_w``): x's columns
    times the rank's rows of ``name`` (int8 or full precision, as
    :func:`ldense`), the f32 partials summed over the ranks, then the bias
    and one rounding."""
    qk = name + "_q"
    if qk in lp:
        y = w8_dense(x, lp[qk], lp[name + "_s"])
    else:
        y = mm_f32(x, lp[name].to(x.dtype))
    y = yield from _meet(tp, "sum", y)
    return _finish(y, bias, x.dtype)


def qkv_proj(lp: Layer, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Self-attention Q/K/V projection: one product over a fused ``qkv_w``
    [D, 3, D] (int8 ``qkv_w_q`` + ``qkv_w_s`` [3, D], or full precision;
    :func:`~norma_tpu_torch.model.load.fuse_qkv`), else three."""
    if "qkv_w_q" in lp or "qkv_w" in lp:
        if "qkv_w_q" in lp:  # one w8a16 product over [D, 3*D] codes, [3*D] scales
            wq = lp["qkv_w_q"]
            y = w8_dense(x, wq.reshape(wq.shape[0], -1), lp["qkv_w_s"].reshape(-1))
        else:
            w = lp["qkv_w"]
            y = mm_f32(x, w.reshape(w.shape[0], -1).to(x.dtype))
        y = _finish(y.unflatten(-1, (3, -1)), lp["qkv_b"], x.dtype)
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


def _mlp(lp: Layer, x: torch.Tensor, tp=None):
    h = gelu(ldense(lp, "fc1_w", x, lp["fc1_b"]))
    return (yield from _row_dense(lp, "fc2_w", h, lp["fc2_b"], tp))


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


def _q8_row(lp: Layer, name: str, x: torch.Tensor, bias, tp):
    """Row-parallel w8a8 dense (``o_w``, ``fc2_w`` under
    ``quantize_encoder``): per-row dynamic int8 activations x stored int8
    weights through the int8 GEMM.  Under tp, x is a shard of its row: the
    row's amax is the max over the ranks (GSPMD's grid), each rank's GEMM
    runs with unit scales, so its f32 result is the exact integer partial
    (|partial| < 2**24 for any realistic row), the partials are summed
    over the ranks, and ``acc * xs * ws (+ b)`` follows in f32, in the
    kernel epilogue's order, as GSPMD's int32 psum does."""
    amax = None  # one rank: quantize_activations takes it from x
    if tp is not None:
        amax = yield from _meet(tp, "max", x.float().abs().amax(dim=-1, keepdim=True))
    xq, xs = quantize_activations(x, amax)
    wq, ws = lp[name + "_q"], lp[name + "_s"]
    if tp is None:
        return q8a8_dense(xq, xs, wq, ws, bias, out_dtype=x.dtype)
    acc = q8a8_dense(xq, torch.ones_like(xs), wq, torch.ones_like(ws))
    acc = yield from _meet(tp, "sum", acc)
    return _finish(acc * xs * ws.float(), bias, x.dtype)


def _qkv_proj_q8(lp: Layer, x: torch.Tensor):
    """Q/K/V on the w8a8 path: the activation row is quantized ONCE and
    shared by the three projections; a fused [in, 3, out] weight runs as
    one [in, 3*out] product (:func:`~norma_tpu_torch.ops.quant_matmul.
    q8a8_qkv`, ``norma_tpu/model/whisper.py:281-290``).  Each result is
    rounded once from f32 to the activation dtype, in the GEMM's epilogue."""
    xq, xs = quantize_activations(x)
    if "qkv_w_q" in lp:
        return q8a8_qkv(xq, xs, lp["qkv_w_q"], lp["qkv_w_s"], lp["qkv_b"], out_dtype=x.dtype)
    return (
        q8a8_dense(xq, xs, lp["q_w_q"], lp["q_w_s"], lp["q_b"], out_dtype=x.dtype),
        q8a8_dense(xq, xs, lp["k_w_q"], lp["k_w_s"], None, out_dtype=x.dtype),
        q8a8_dense(xq, xs, lp["v_w_q"], lp["v_w_s"], lp["v_b"], out_dtype=x.dtype),
    )


def _mlp_q8(lp: Layer, x: torch.Tensor, tp=None):
    xq, xs = quantize_activations(x)  # x is whole on every rank
    # Rounded at once: the f32 GELU output is not kept alive through fc2.
    h = F.gelu(q8a8_dense(xq, xs, lp["fc1_w_q"], lp["fc1_w_s"], lp["fc1_b"]), approximate="none").to(x.dtype)
    return (yield from _q8_row(lp, "fc2_w", h, lp["fc2_b"], tp))


def _encoder_layer(lp: Layer, x: torch.Tensor, n_heads: int, flash: bool, q8_mode: str, tp):
    w8a8 = "fc1_w_q" in lp and q8_mode in ("w8a8", "w8a8_pallas")
    n_heads = _heads(n_heads, tp)
    h = layer_norm(x, lp["attn_ln_g"], lp["attn_ln_b"])
    q, k, v = _qkv_proj_q8(lp, h) if w8a8 else qkv_proj(lp, h)
    if flash:
        a = flash_self_attention(q, k, v, n_heads)
    else:
        a = attention(q, k, v, n_heads)
    if w8a8:
        x = x + (yield from _q8_row(lp, "o_w", a, lp["o_b"], tp))
    else:
        x = x + (yield from _row_dense(lp, "o_w", a, lp["o_b"], tp))
    h = layer_norm(x, lp["mlp_ln_g"], lp["mlp_ln_b"])
    return x + (yield from (_mlp_q8(lp, h, tp) if w8a8 else _mlp(lp, h, tp)))


def encoder_layer(
    lp: Layer, x: torch.Tensor, n_heads: int, flash: bool = False, q8_mode: str = "w8a8"
) -> torch.Tensor:
    """One encoder layer.  ``flash`` runs the self-attention through the
    flash kernel; ``quantize_encoder`` weights (``fc1_w_q`` present) run
    the w8a8 int8 GEMM unless ``q8_mode`` is "w8a16", which runs
    :func:`ldense` (:func:`~norma_tpu_torch.ops.quant_matmul.w8_dense`, the
    w8 kernel on the card) over the int8 codes."""
    return _solo(_encoder_layer(lp, x, n_heads, flash, q8_mode, None))


def _encoder_flash(cfg: WhisperConfig) -> bool:
    """Whether ``cfg`` selects the flash-attention kernel for the encoder:
    ``flash_attention=True`` or ``encoder_attn_impl`` "flash"/"jax_flash"."""
    impl = cfg.encoder_attn_impl
    if impl not in _FLASH_IMPLS + _PLAIN_IMPLS:
        raise ValueError(f"unknown encoder_attn_impl {impl!r}")
    return impl in _FLASH_IMPLS or bool(cfg.flash_attention)


def encode(params: Params, cfg: WhisperConfig, mel: torch.Tensor) -> torch.Tensor:
    """mel: [B, n_mels, T_frames] -> audio features [B, T_frames//2, D]."""
    return _solo(_encode(params, cfg, mel))


def _encode(params: Params, cfg: WhisperConfig, mel: torch.Tensor, tp=None):
    """:func:`encode` on a rank's shard (module docstring); the features
    come back whole on every rank."""
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
        x = yield from _encoder_layer(
            layers.layer(i), x, cfg.encoder_attention_heads, flash, cfg.encoder_q8_mode, tp
        )
    return layer_norm(x, enc["ln_g"], enc["ln_b"])


# --------------------------------------------------------------------------
# Decoder
# --------------------------------------------------------------------------


def logits_head(dec: Params, x: torch.Tensor) -> torch.Tensor:
    """Tied-embedding logits head: [..., D] -> [..., V] unrounded f32.
    An int4 head (``tok_emb_q4``, :func:`~norma_tpu_torch.model.quant.
    quantize_logits_head_int4`) runs w4a16 and takes precedence; an int8
    head (``tok_emb_q8``) runs w8a16 on x cast to bf16."""
    return _solo(_logits_head(dec, x))


def _logits_head(dec: Params, x: torch.Tensor, tp=None):
    """:func:`logits_head` on a rank's shard, x whole: the int4 head is
    replicated; the int8 head's vocabulary shards are gathered (ragged where
    tp does not divide V); the bf16 head's D shard takes x's columns and
    the [..., V] partials are summed."""
    if "tok_emb_q4" in dec:
        q4 = dec["tok_emb_q4"]
        return w4_matmul(x, q4["q"], q4["s"])
    if "tok_emb_q8" in dec:
        q8 = dec["tok_emb_q8"]
        y = w8_matmul(x, q8["q"], q8["s"])
        if tp is None:  # a head-only tree has no tok_emb
            return y
        return (yield from _meet(tp, "gather", y, dim=-1, total=dec["tok_emb"].shape[0]))
    w = dec["tok_emb"]
    if tp is None:
        return mm_f32(x, w.t())
    d = w.shape[1]
    y = mm_f32(x[..., tp.index * d:(tp.index + 1) * d], w.t())
    return (yield from _meet(tp, "sum", y))


def _embed(dec: Params, tokens: torch.Tensor, tp):
    """The token embedding rows of ``tokens``, whole: under tp each rank
    holds D / tp columns of every row and the rows are gathered."""
    e = dec["tok_emb"][tokens.long()]
    return (yield from _meet(tp, "gather", e, dim=-1, total=e.shape[-1] * (1 if tp is None else tp.size)))


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


# Exact integer products of int8 codes through f32: a code in [-127, 127]
# is exact in f32 (and in TF32, should cuBLAS use it), each product is an
# integer below 2**14, and a sum of at most this many products stays below
# 2**24 (1040 * 127**2 = 16,774,160), so every partial sum of the f32
# accumulation is exact in any order.  Longer contractions add such chunks
# in int32, as the JAX package's ``preferred_element_type=int32`` sums.
EXACT_F32_TERMS = 1040


def int8_products(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a [..., M, K] @ b [..., K, N]`` over integer codes in [-127, 127]
    (any dtype), exact, as int32: f32 products of K-chunks of at most
    :data:`EXACT_F32_TERMS`, added in int32."""
    K = a.shape[-1]
    out = None
    for k0 in range(0, K, EXACT_F32_TERMS):
        part = torch.matmul(a[..., k0:k0 + EXACT_F32_TERMS].float(),
                            b[..., k0:k0 + EXACT_F32_TERMS, :].float()).to(torch.int32)
        out = part if out is None else out + part
    return out


def _codes(x: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """clip(round(x / s), -127, 127), kept in f32 (the values of int8 codes;
    ``torch.round`` rounds half to even, as ``jnp.round`` does)."""
    return torch.clamp(torch.round(x / s), -127, 127)


def attention_cross_q8_a8(
    q: torch.Tensor, kq: XKV, vq: XKV, n_heads: int, n_groups: int = 1
) -> torch.Tensor:
    """Fully-int8 cross-attention (``cross_kv_impl="a8"``): int8 x int8 ->
    int32 QK and PV products over the per-channel K/V codes.

    q (times the K scale and dh**-0.5, in f32) is quantized per row over
    all of D with sq = max(amax, 1e-8) / 127; the f32 softmax weights per
    (head, query row) with sw = max(max_k w, 1e-8) / 127.  The products are
    exact (:func:`int8_products`: QK sums at most dh * 127**2, PV sums split
    into key chunks of at most 1040), then scaled by sq, and by sw and the
    V scale.  Shapes as :func:`attention_cross_q8`."""
    return _solo(_attention_cross_q8_a8(q, kq, vq, n_heads, n_groups))


def _attention_cross_q8_a8(q, kq: XKV, vq: XKV, n_heads: int, n_groups: int = 1, tp=None):
    """:func:`attention_cross_q8_a8` on a rank's heads: the row scale sq is
    taken over the whole row, the max over the ranks' columns."""
    gb, tq, d = q.shape
    b = kq["q"].shape[0]
    g = n_groups
    dh = d // n_heads
    qf = q.float().reshape(g, b, tq, d) * kq["s"][None, :, None, :] * float(dh) ** -0.5
    amax = yield from _meet(tp, "max", qf.abs().amax(dim=-1, keepdim=True))
    sq = torch.clamp(amax, min=1e-8) / 127.0  # [G, B, Tq, 1]
    qi = _codes(qf, sq).reshape(g, b, tq, n_heads, dh).permute(0, 1, 3, 2, 4)  # [G, B, H, Tq, dh]
    ki = _split_heads(kq["q"], n_heads)[None]  # [1, B, H, Tk, dh]
    vi = _split_heads(vq["q"], n_heads)[None]
    logits = int8_products(qi, ki.transpose(-1, -2)).float() * sq.transpose(2, 3)[:, :, :, :, None]
    w = torch.softmax(logits, dim=-1)  # f32 [G, B, H, Tq, Tk]
    sw = torch.clamp(w.amax(dim=-1, keepdim=True), min=1e-8) / 127.0
    out = int8_products(_codes(w, sw), vi).float() * sw  # [G, B, H, Tq, dh]
    out = out.permute(0, 1, 3, 2, 4).reshape(g, b, tq, d) * vq["s"][None, :, None, :]
    return out.to(q.dtype).reshape(gb, tq, d)


def a8_code_step(q: torch.Tensor, kq: XKV, vq: XKV, n_heads: int, n_groups: int = 1) -> torch.Tensor:
    """What one softmax weight code moves :func:`attention_cross_q8_a8`'s
    output by, per element [G*B, Tq, D], on the host in f64: sw * max_k
    |v codes| * vq.s.  Two implementations whose softmaxes differ in the
    last bits (two devices, two libraries) may round a weight that lies at
    a half to neighbouring codes; their outputs then differ by up to this
    where that happened, and agree to rounding elsewhere."""
    q = q.detach().cpu().double()
    kq = {k: v.detach().cpu().double() for k, v in kq.items()}
    vq = {k: v.detach().cpu().double() for k, v in vq.items()}
    gb, tq, d = q.shape
    b, ta = kq["q"].shape[:2]
    g, dh = n_groups, d // n_heads
    qf = q.reshape(g, b, tq, d) * kq["s"][None, :, None, :] * dh**-0.5
    sq = torch.clamp(qf.abs().amax(dim=-1, keepdim=True), min=1e-8) / 127.0
    qi = _codes(qf, sq).reshape(g, b, tq, n_heads, dh).permute(0, 1, 3, 2, 4)
    ki = _split_heads(kq["q"], n_heads).transpose(-1, -2)[None]  # [1, B, H, dh, Tk]
    logits = torch.matmul(qi, ki) * sq.transpose(2, 3)[..., None]
    sw = torch.clamp(torch.softmax(logits, dim=-1).amax(dim=-1), min=1e-8) / 127.0  # [G, B, H, Tq]
    vmax = (vq["q"].abs().amax(dim=1) * vq["s"]).reshape(b, n_heads, dh)
    return (sw[..., None] * vmax[None, :, :, None, :]).permute(0, 1, 3, 2, 4).reshape(gb, tq, d)


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
    ``cross_kv_impl="kernel"``); else :func:`attention_cross_q8_a8` under
    "a8", and the plain :func:`attention_cross_q8` under "einsum" and
    "chunked" (the TPU's key-chunked form of the same function: only the
    softmax sum's order differs)."""
    return _solo(_cross_q8_attn(cfg, q, kq, vq, n_heads, n_groups))


def _cross_q8_attn(cfg: WhisperConfig, q, kq: XKV, vq: XKV, n_heads: int, n_groups: int = 1, tp=None):
    """:func:`cross_q8_attn` on a rank's heads ("a8" meets the ranks once)."""
    impl = _cross_impl(cfg)
    if "codes" in kq or "codes4" in kq:
        return cross_attention_q8_kernel(q, kq, vq, n_heads, n_groups)
    if impl == "a8":
        return (yield from _attention_cross_q8_a8(q, kq, vq, n_heads, n_groups, tp))
    return attention_cross_q8(q, kq, vq, n_heads, n_groups)


def quantize_kv_row(x: torch.Tensor, amax: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """K or V rows [..., D] -> (int8 [..., D], f32 scale [..., 1]) with
    scale = max(amax over D, 1e-8) / 127 (the JAX package's grid).
    ``amax`` [..., 1] is the whole row's when ``x`` holds a rank's columns."""
    xf = x.float()
    if amax is None:
        amax = xf.abs().amax(dim=-1, keepdim=True)
    s = torch.clamp(amax, min=1e-8) / 127.0
    return torch.clamp(torch.round(xf / s), -127, 127).to(torch.int8), s


def _quantize_kv_rows(x: torch.Tensor, tp):
    """:func:`quantize_kv_row` with the amax over the whole row: under tp
    the max over the ranks' columns, as GSPMD computes it."""
    amax = None
    if tp is not None:
        amax = yield from _meet(tp, "max", x.float().abs().amax(dim=-1, keepdim=True))
    return quantize_kv_row(x, amax)


@torch.no_grad()
def quantize_self_kv_cache(cache: torch.Tensor) -> XKV:
    """Per-row int8 self-attention cache: [L, B, T, D] -> {"q": int8 same
    shape, "s": [L, B, T, 1] f32}, on the grid the token loop's row writes
    use (:func:`quantize_kv_row`), so prefix rows and loop rows quantize
    alike.  Unwritten rows quantize to zeros; the position mask hides them."""
    return _solo(_quantize_self_kv_cache(cache))


def _quantize_self_kv_cache(cache: torch.Tensor, tp=None):
    """:func:`quantize_self_kv_cache` of a rank's columns (whole-row scales)."""
    q, s = yield from _quantize_kv_rows(cache, tp)
    return {"q": q, "s": s}


def attention_self_q8(
    q: torch.Tensor, ckq: XKV, cvq: XKV, n_heads: int, mask: torch.Tensor
) -> torch.Tensor:
    """Self-attention over one layer's int8 cache with per-row scales.

    q: [B, 1, D]; ckq/cvq: {"q": [B, T, D] int8, "s": [B, T, 1] f32}; mask:
    additive, broadcastable to [B, H, 1, T].  Both whisper dh**-0.25
    factors fold onto q; the K scale multiplies the f32 logits of its key,
    the V scale the softmax weight of its row (both exact foldings), and the
    weights are rounded to q's dtype for the PV product."""
    dh = q.shape[-1] // n_heads
    qh = (_split_heads(q, n_heads) * _scalar(dh**-0.5, q.dtype)).float()
    kh = _split_heads(ckq["q"].to(q.dtype), n_heads).float()
    vh = _split_heads(cvq["q"].to(q.dtype), n_heads).float()
    logits = torch.matmul(qh, kh.transpose(-1, -2))  # [B, H, 1, T]
    logits = logits * ckq["s"][:, None, None, :, 0] + mask
    w = torch.softmax(logits, dim=-1) * cvq["s"][:, None, None, :, 0]
    return _merge_heads(torch.matmul(w.to(q.dtype).float(), vh).to(q.dtype))


def _ready(value):
    """A layer generator that meets no rank and returns ``value``."""
    return value
    yield  # never reached: it makes this function a generator


def _decoder_layer_cross_mlp(lp: Layer, x: torch.Tensor, cross_attn: Callable, tp=None):
    """The cross-attention + MLP tail of one decoder layer; ``cross_attn(xq)``
    is a layer generator (the "a8" form meets the ranks)."""
    h = layer_norm(x, lp["xattn_ln_g"], lp["xattn_ln_b"])
    xq = ldense(lp, "xq_w", h, lp["xq_b"])
    a = yield from cross_attn(xq)
    x = x + (yield from _row_dense(lp, "xo_w", a, lp["xo_b"], tp))
    h = layer_norm(x, lp["mlp_ln_g"], lp["mlp_ln_b"])
    return x + (yield from _mlp(lp, h, tp))


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
    return _solo(_decoder_prefill(params, cfg, tokens, xk, xv))


def _decoder_prefill(params: Params, cfg: WhisperConfig, tokens, xk, xv, tp=None):
    """:func:`decoder_prefill` on a rank's shard: xk/xv and the caches hold
    the rank's D / tp columns; the logits come back whole."""
    dec = params["decoder"]
    B, P = tokens.shape
    L, D = cfg.decoder_layers, cfg.d_model // (1 if tp is None else tp.size)
    n_heads = _heads(cfg.decoder_attention_heads, tp)
    dtype = dec["tok_emb"].dtype
    dev = tokens.device

    x = (yield from _embed(dec, tokens, tp)) + dec["pos_emb"][:P]
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
        x = x + (yield from _row_dense(lp, "o_w", attention(q, k, v, n_heads, causal), lp["o_b"], tp))
        cache_k[i, :, :P] = k
        cache_v[i, :, :P] = v
        x = yield from _decoder_layer_cross_mlp(
            lp, x, lambda xq, i=i: _ready(attention(xq, xk[i], xv[i], n_heads)), tp
        )
    x = layer_norm(x, dec["ln_g"], dec["ln_b"])
    return (yield from _logits_head(dec, x, tp)), cache_k, cache_v


@torch.no_grad()
def decoder_step(
    params: Params,
    cfg: WhisperConfig,
    tok: torch.Tensor,  # [B] int — token at position ``pos``
    pos: "int | torch.Tensor",  # or one int64 on the device
    cache_k: torch.Tensor,  # [L, B, T, D] (T may be a bucket crop)
    cache_v: torch.Tensor,
    xk,  # [L, B', Ta, D] with B' = B // n_rungs, or a quantized dict
    xv,
    n_rungs: int = 1,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One incremental decode step.  Returns (logits [B, V] f32, cache_k,
    cache_v), the caches being the SAME tensors with row ``pos`` of every
    layer written in place.

    ``pos`` may be an ``int`` or a one-element int64 tensor on the
    device: the position embedding, the key mask and the row writes all
    read it as a tensor (a gather, a compare, ``index_copy_``), so a
    captured CUDA graph replays one step at successive positions.  An
    ``int`` is checked against the cache here; a device position is the
    caller's to keep inside it (the self-decode kernel traps outside).
    The key mask ``idx <= pos`` is taken from the cache's own length, so a
    cropped cache (``cache[:, :, :S]``, the bucketed decode chain) works.
    ``n_rungs > 1`` (speculative temperature ladder): rows are laid out
    ``r*B' + b`` and share stream ``b``'s cross-K/V.
    ``cfg.self_kv_impl`` selects the self-attention: "xla" writes the row
    and runs the plain masked :func:`attention`; "kernel" runs
    :func:`~norma_tpu_torch.ops.self_decode.self_attention_decode`.  An
    int8 cache ({"q", "s"} dicts, :func:`quantize_self_kv_cache`) writes
    the row quantized and runs :func:`attention_self_q8`, under either
    setting: the kernel reads bf16/f32 caches only, as in the JAX package.
    Cross-K/V: tensors run the plain attention; a quantized dict
    ({"q", "s"} stacked over layers) runs :func:`attention_cross_q8` per
    layer; the kernel layout ({"codes"/"codes4", "s"}) runs the stacked
    kernel, which addresses layer ``li`` by index (never a slice).
    """
    return _solo(_decoder_step(params, cfg, tok, pos, cache_k, cache_v, xk, xv, n_rungs))


def _decoder_step(params: Params, cfg: WhisperConfig, tok, pos, cache_k, cache_v, xk, xv, n_rungs=1, tp=None):
    """:func:`decoder_step` on a rank's shard: caches and cross-K/V hold the
    rank's D / tp columns; the logits come back whole."""
    dec = params["decoder"]
    n_heads = _heads(cfg.decoder_attention_heads, tp)
    q8_cache = isinstance(cache_k, dict)
    T = (cache_k["q"] if q8_cache else cache_k).shape[2]
    dev = tok.device
    if isinstance(pos, torch.Tensor):
        if pos.dtype != torch.int64 or pos.numel() != 1 or pos.device != dev:
            raise ValueError(f"a device position must be one int64 on {dev}")
        pos_t = pos.reshape(1)
    else:
        if not 0 <= pos < T:
            raise ValueError(f"position {pos} outside the cache's {T} rows")
        pos_t = torch.full((1,), int(pos), dtype=torch.int64, device=dev)
    if cfg.self_kv_impl not in ("xla", "kernel"):
        raise ValueError(f"unknown self_kv_impl {cfg.self_kv_impl!r}")
    use_kernel = cfg.self_kv_impl == "kernel" and not q8_cache

    x = ((yield from _embed(dec, tok, tp)) + dec["pos_emb"].index_select(0, pos_t))[:, None, :]
    key_mask = None
    if not use_kernel:
        idx = torch.arange(T, device=dev)
        key_mask = torch.where(idx <= pos_t, 0.0, float("-inf"))

    if isinstance(xk, dict):
        _cross_impl(cfg)  # validated even on the stacked layout
        stacked = "codes" in xk or "codes4" in xk

        def cross_attn(xq, li):
            if stacked:
                return cross_attention_q8_kernel_stacked(xq, xk, xv, li, n_heads, n_rungs)
            kq = {k: v[li] for k, v in xk.items()}
            vq = {k: v[li] for k, v in xv.items()}
            return (yield from _cross_q8_attn(cfg, xq, kq, vq, n_heads, n_rungs, tp))
    else:

        def cross_attn(xq, li):
            if n_rungs == 1:
                return _ready(attention(xq, xk[li], xv[li], n_heads))
            return _ready(attention_grouped(xq, xk[li], xv[li], n_heads, n_rungs))

    layers = dec["layers"]
    for li in range(cfg.decoder_layers):
        lp = layers.layer(li)
        h = layer_norm(x, lp["attn_ln_g"], lp["attn_ln_b"])
        q, k, v = qkv_proj(lp, h)
        if use_kernel:
            a, _, _ = self_attention_decode(q, k, v, cache_k, cache_v, li, pos, n_heads)
        elif q8_cache:
            for c, row in ((cache_k, k), (cache_v, v)):
                rq, rs = yield from _quantize_kv_rows(row, tp)  # [B, 1, D], [B, 1, 1]
                c["q"][li].index_copy_(1, pos_t, rq)
                c["s"][li].index_copy_(1, pos_t, rs)
            a = attention_self_q8(
                q, {n: t[li] for n, t in cache_k.items()}, {n: t[li] for n, t in cache_v.items()},
                n_heads, key_mask,
            )
        else:
            cache_k[li].index_copy_(1, pos_t, k)
            cache_v[li].index_copy_(1, pos_t, v)
            a = attention(q, cache_k[li], cache_v[li], n_heads, key_mask)
        x = x + (yield from _row_dense(lp, "o_w", a, lp["o_b"], tp))
        x = yield from _decoder_layer_cross_mlp(lp, x, lambda xq, li=li: cross_attn(xq, li), tp)

    x = layer_norm(x, dec["ln_g"], dec["ln_b"])
    return (yield from _logits_head(dec, x[:, 0, :], tp)), cache_k, cache_v


@torch.no_grad()
def decoder_chunk(
    params: Params,
    cfg: WhisperConfig,
    toks: torch.Tensor,  # [B, C] int — tokens at positions pos[b] .. pos[b]+C-1
    pos: torch.Tensor,  # [B] int per-row start positions, on the device
    cache_k: torch.Tensor,  # [L, B, T, D]
    cache_v: torch.Tensor,
    xk,  # [L, B, Ta, D], or an int8 {"q", "s"} dict stacked over layers
    xv,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Multi-token incremental decode with PER-ROW positions: the
    speculative verify pass (``decode/speculative.py``) scores row b's C
    tokens in one forward.  Causal within the chunk; cache rows beyond each
    query's position are masked out.  Returns (logits [B, C, V] f32 —
    logits[:, j] predicts position pos+j+1 — and the SAME caches with rows
    [pos[b], pos[b]+C) of every layer written in place).

    The positions stay on the device (the row writes are a ``scatter_``,
    the mask a compare), so a captured CUDA graph replays a chunk at any
    positions.  The caches may be longer than ``cfg.max_target_positions``
    (the speculative loop pads them by the chunk width); the embedding
    gather alone is clamped at ``max_target_positions - 1``: positions past
    it occur only on rows whose results a round discards.  Every write
    must fall inside the cache (the caller's slack keeps it there).

    Self-attention is the plain masked :func:`attention` (the self-decode
    kernel is single-query); an int8 cross-K/V dict runs the plain
    :func:`cross_q8_attn` per layer (the stacked kernel layout is
    single-query and refused); an int8 self-KV cache raises, as in the JAX
    package.  Logits go through :func:`logits_head` (the w8 / w4 kernels
    on the card for quantized heads).
    """
    return _solo(_decoder_chunk(params, cfg, toks, pos, cache_k, cache_v, xk, xv))


def _decoder_chunk(params: Params, cfg: WhisperConfig, toks, pos, cache_k, cache_v, xk, xv, tp=None):
    """:func:`decoder_chunk` on a rank's shard: caches and cross-K/V hold the
    rank's D / tp columns and heads; the logits come back whole."""
    dec = params["decoder"]
    n_heads = _heads(cfg.decoder_attention_heads, tp)
    if isinstance(cache_k, dict):
        raise NotImplementedError(
            "decoder_chunk does not support the int8 self-KV cache "
            "(quantize_self_kv): the chunked verify path keeps bf16/f32 caches"
        )
    if isinstance(xk, dict) and ("codes" in xk or "codes4" in xk):
        raise ValueError("decoder_chunk: the cross kernel layout is single-query; pass plain int8 dicts")
    B, C = toks.shape
    T, D = cache_k.shape[2], cache_k.shape[3]  # D: the rank's columns
    dev = toks.device
    pos_idx = pos.long()[:, None] + torch.arange(C, device=dev)[None, :]  # [B, C]
    emb_idx = pos_idx.clamp(max=cfg.max_target_positions - 1)
    x = (yield from _embed(dec, toks, tp)) + dec["pos_emb"][emb_idx]
    # Query at chunk offset c (global pos + c) sees cache keys <= pos + c.
    key_idx = torch.arange(T, device=dev)
    key_mask = torch.where(
        key_idx[None, None, None, :] <= pos_idx[:, None, :, None], 0.0, float("-inf")
    )  # [B, 1, C, T]
    rows = pos_idx[:, :, None].expand(B, C, D)

    if isinstance(xk, dict):
        _cross_impl(cfg)

        def cross_attn(xq, li):
            kq = {k: v[li] for k, v in xk.items()}
            vq = {k: v[li] for k, v in xv.items()}
            return (yield from _cross_q8_attn(cfg, xq, kq, vq, n_heads, 1, tp))
    else:

        def cross_attn(xq, li):
            return _ready(attention(xq, xk[li], xv[li], n_heads))

    layers = dec["layers"]
    for li in range(cfg.decoder_layers):
        lp = layers.layer(li)
        h = layer_norm(x, lp["attn_ln_g"], lp["attn_ln_b"])
        q, k, v = qkv_proj(lp, h)
        cache_k[li].scatter_(1, rows, k.to(cache_k.dtype))
        cache_v[li].scatter_(1, rows, v.to(cache_v.dtype))
        a = attention(q, cache_k[li], cache_v[li], n_heads, key_mask)
        x = x + (yield from _row_dense(lp, "o_w", a, lp["o_b"], tp))
        x = yield from _decoder_layer_cross_mlp(lp, x, lambda xq, li=li: cross_attn(xq, li), tp)

    x = layer_norm(x, dec["ln_g"], dec["ln_b"])
    return (yield from _logits_head(dec, x, tp)), cache_k, cache_v


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
