"""Quantization of model params (``norma_tpu/model/quant.py``).

  - :func:`quantize_logits_head` — an int8 tied-embedding head
    (``tok_emb_q8``: codes [D, V] int8 whose rows start 16-byte aligned,
    :func:`~norma_tpu_torch.ops.quant_matmul.pitched_codes`; scales [V]
    f32) beside ``tok_emb``,
    which the token embedding keeps using;
  - :func:`quantize_logits_head_int4` — a blockwise-int4 head
    (``tok_emb_q4``: nibble-packed codes [D/2, V] int8, scales [D/64, V]
    bf16), half the int8 head's bytes.  Each head tier drops the other, so
    the one asked for last is the one ``logits_head`` runs;
  - :func:`quantize_decoder` — every decoder-layer matmul weight as
    per-(layer, out-channel) int8 (``name_q`` + ``name_s``), plus the int8
    or int4 head.  The decoder computes w8a16 (``model/whisper.py::ldense``,
    the w8 kernel on the card): the decode step is weight-bandwidth-bound,
    so only the stored bytes matter;
  - :func:`quantize_encoder` — the encoder-layer weights in the same
    storage; the encoder computes w8a8 through the int8 GEMM
    (``encoder_q8_mode``), changing numerics by the activation grid;
  - :func:`prep_encoder_q8_kernel` — params whose encoder codes are
    K-major copies (the same [in, ...out] values over [...out, in]
    storage) for the int8 GEMM kernel; ``DecodeEngine`` builds them on the
    card and leaves the caller's params as they are.

Codes and scales are bit-equal to the JAX package's (f32 arithmetic,
round half to even).
"""

from __future__ import annotations

from typing import Any, Dict

from ..ops.quant_matmul import (
    kmajor_codes,
    pitched_codes,
    quantize_axis,
    quantize_blockwise_int4,
    quantize_per_channel,
)
from .load import Params

# Decoder-layer weight matrices eligible for int8 (stacked [L, in, ...out]).
# ``qkv_w`` is the fused [L, in, 3, out] form (load.fuse_qkv); unfused
# params carry the separate q_w/k_w/v_w instead.
DECODER_W8_KEYS = (
    "qkv_w", "q_w", "k_w", "v_w", "o_w",
    "xq_w", "xk_w", "xv_w", "xo_w",
    "fc1_w", "fc2_w",
)

# Encoder layers have no cross-attention; everything else matches.
ENCODER_W8_KEYS = (
    "qkv_w", "q_w", "k_w", "v_w", "o_w", "fc1_w", "fc2_w",
)


def _tree(p: Params) -> Dict[str, Any]:
    return {k: _tree(v) if isinstance(v, Params) else v for k, v in p.items()}


def _quantize_layer_stack(layers: Dict[str, Any], keys) -> Dict[str, Any]:
    """Per-(layer, out-channel) symmetric int8 over a stacked layer tree:
    each ``name`` [L, in, *out] in ``keys`` becomes ``name_q`` (int8; axis
    1 is the contraction) + ``name_s`` (f32 [L, *out])."""
    layers = dict(layers)
    for name in keys:
        if name not in layers:
            continue
        q, s = quantize_axis(layers.pop(name), axis=1)
        layers[name + "_q"] = q
        layers[name + "_s"] = s
    return layers


def quantize_logits_head(params: Params) -> Params:
    """Return params with an int8 tied-embedding head added (and any int4
    head dropped: ``logits_head`` takes ``tok_emb_q4`` first, so a leftover
    one would override this request)."""
    tree = _tree(params)
    q, s = quantize_per_channel(tree["decoder"]["tok_emb"].t())  # [D, V]
    # Rows padded to 16 bytes (the same [D, V] values): the w8 kernel's copies.
    tree["decoder"]["tok_emb_q8"] = {"q": pitched_codes(q), "s": s}
    tree["decoder"].pop("tok_emb_q4", None)
    return Params(tree)


def quantize_logits_head_int4(params: Params, block: int = 64) -> Params:
    """Return params with a blockwise-int4 tied-embedding head added (and
    any int8 head dropped)."""
    tree = _tree(params)
    q, s = quantize_blockwise_int4(tree["decoder"]["tok_emb"].t(), block)  # [D/2, V], [D/block, V]
    tree["decoder"]["tok_emb_q4"] = {"q": q, "s": s}
    tree["decoder"].pop("tok_emb_q8", None)
    return Params(tree)


def quantize_decoder(params: Params, logits: str = "int8") -> Params:
    """Return params with all decoder-layer matmul weights as int8 and the
    logits head as int8 (``logits`` True or "int8") or blockwise int4
    ("int4").  Works on fused (``qkv_w`` [L, in, 3, out]) and unfused
    stacks."""
    if logits == "int4":
        tree = _tree(quantize_logits_head_int4(params))
    elif logits in (True, "int8"):
        tree = _tree(quantize_logits_head(params))
    else:
        raise ValueError(f"logits={logits!r}: expected 'int8' or 'int4'")
    tree["decoder"]["layers"] = _quantize_layer_stack(tree["decoder"]["layers"], DECODER_W8_KEYS)
    return Params(tree)


def quantize_encoder(params: Params) -> Params:
    """Return params with encoder-layer matmul weights as int8 (w8a8 in
    the encoder forward; conv stem, LayerNorms and positions stay full
    precision)."""
    tree = _tree(params)
    tree["encoder"]["layers"] = _quantize_layer_stack(tree["encoder"]["layers"], ENCODER_W8_KEYS)
    return Params(tree)


def prep_encoder_q8_kernel(params: Params) -> Params:
    """Return params whose encoder ``name_q`` code stacks lie K-major: each
    [L, in, *out] stack keeps its shape and values but lies as [L, *out,
    in] (:func:`~norma_tpu_torch.ops.quant_matmul.kmajor_codes`), so each
    layer's [in, out] weight -- and the fused [in, 3, out] one reshaped to
    [in, 3*out] -- is a view with strides (1, in), the layout the int8 GEMM
    kernel reads.

    The caller's params are not touched (JAX's params are immutable): the
    result shares every tensor but the encoder's codes, which are new
    tensors; stacks already K-major are shared as they are.  While the
    caller still holds the originals, the encoder's codes exist twice
    (~630 MB more at distil-large-v3 width)."""
    tree = _tree(params)
    layers = tree["encoder"]["layers"]
    for name in ENCODER_W8_KEYS:
        key = name + "_q"
        if key in layers and layers[key].stride(1) != 1:
            layers[key] = kmajor_codes(layers[key], axis=1)
    return Params(tree)
