"""Quantization of model params (``norma_tpu/model/quant.py``).

  - :func:`quantize_logits_head` — an int8 tied-embedding head
    (``tok_emb_q8``: codes [D, V] int8, scales [V] f32) beside ``tok_emb``,
    which the token embedding keeps using;
  - :func:`quantize_decoder` — every decoder-layer matmul weight as
    per-(layer, out-channel) int8 (``name_q`` + ``name_s``), plus the int8
    head.  The decoder computes w8a16 (``model/whisper.py::ldense``): the
    decode step is weight-bandwidth-bound, so only the stored bytes matter;
  - :func:`quantize_encoder` — the encoder-layer weights in the same
    storage; the encoder computes w8a8 through the int8 GEMM
    (``encoder_q8_mode``), changing numerics by the activation grid.

Codes and scales are bit-equal to the JAX package's (f32 arithmetic,
round half to even).  The blockwise-int4 head waits for ROADMAP queue 2 #7.
"""

from __future__ import annotations

from typing import Any, Dict

from ..ops.quant_matmul import quantize_axis, quantize_per_channel
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
    """Return params with an int8 tied-embedding head added."""
    tree = _tree(params)
    q, s = quantize_per_channel(tree["decoder"]["tok_emb"].t())  # [D, V]
    tree["decoder"]["tok_emb_q8"] = {"q": q, "s": s}
    return Params(tree)


def quantize_decoder(params: Params, logits: str = "int8") -> Params:
    """Return params with all decoder-layer matmul weights and the logits
    head as int8.  Works on fused (``qkv_w`` [L, in, 3, out]) and unfused
    stacks.  ``logits="int4"`` (the blockwise-int4 head) is not ported
    yet."""
    if logits == "int4":
        raise NotImplementedError(
            "the int4 logits head is not ported yet (ROADMAP queue 2 #7, w4_matmul_pallas)"
        )
    if logits not in (True, "int8"):
        raise ValueError(f"logits={logits!r}: expected 'int8' or 'int4'")
    tree = _tree(quantize_logits_head(params))
    tree["decoder"]["layers"] = _quantize_layer_stack(tree["decoder"]["layers"], DECODER_W8_KEYS)
    return Params(tree)


def quantize_encoder(params: Params) -> Params:
    """Return params with encoder-layer matmul weights as int8 (w8a8 in
    the encoder forward; conv stem, LayerNorms and positions stay full
    precision)."""
    tree = _tree(params)
    tree["encoder"]["layers"] = _quantize_layer_stack(tree["encoder"]["layers"], ENCODER_W8_KEYS)
    return Params(tree)
