"""Operations, bytes and bounds of the served Whisper window, from the
configuration's published widths.

A product's bound is the least time the card could take for it: the
larger of its operations over the dense peak of their type and its bytes
over the memory bandwidth, each input byte counted once and each output
byte once, whatever the kernel reads again.  ``model_flops`` counts the
work the model needs for a window, whatever implements it.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

from .peaks import H100

Shape = Tuple[int, int, int]  # (M rows, K contraction, N columns)


def w8_bound_s(m: int, k: int, n: int, peak=H100) -> float:
    """w8a16 product (``csrc/w8_matmul.cu``): int8 codes [K, N] read once,
    f32 scales [N], bf16 x [M, K], f32 out [M, N]; 2MKN operations at the
    bf16 peak."""
    nbytes = k * n + 4 * n + 2 * m * k + 4 * m * n
    return max(nbytes / peak["bytes_per_s"], 2.0 * m * k * n / peak["bf16_flops"])


def q8a8_bound_s(m: int, k: int, n: int, out_bytes: int, peak=H100) -> float:
    """w8a8 product (``csrc/q8a8.cu``): int8 activations [M, K] and their
    f32 row scales, int8 codes [K, N], f32 scales and bf16 bias [N], the
    output [M, N] of ``out_bytes`` each; 2MKN int8 operations."""
    nbytes = m * k + 4 * m + k * n + 6 * n + out_bytes * m * n
    return max(nbytes / peak["bytes_per_s"], 2.0 * m * k * n / peak["int8_ops"])


def decoder_products(d: int, ffn: int) -> List[Tuple[int, int]]:
    """(K, N) of one decoder layer's int8 products, in launch order: fused
    QKV, self out, cross query, cross out, fc1, fc2."""
    return [(d, 3 * d), (d, d), (d, d), (d, d), (d, ffn), (ffn, d)]


def w8_launches(cfg: Dict, rows: int, steps: int) -> List[Shape]:
    """Every w8 launch of one window of ``rows`` rows and ``steps`` decode
    steps: the prefill's (3 positions a row) and each step's, every
    decoder layer's six products and the int8 head."""
    d, ffn, layers, vocab = cfg["d_model"], cfg["decoder_ffn_dim"], cfg["decoder_layers"], cfg["vocab_size"]
    per_pass = [kn for _ in range(layers) for kn in decoder_products(d, ffn)] + [(d, vocab)]
    out = [(3 * rows, k, n) for k, n in per_pass]
    for _ in range(steps):
        out += [(rows, k, n) for k, n in per_pass]
    return out


def q8a8_launches(cfg: Dict, rows: int) -> List[Tuple[int, int, int, int]]:
    """Every q8a8 launch of one window: each encoder layer's fused QKV
    (bf16 out), out projection (bf16), fc1 (f32) and fc2 (bf16), over
    ``rows`` x 1500 positions.  (M, K, N, output bytes)."""
    d, ffn, t = cfg["d_model"], cfg["encoder_ffn_dim"], cfg["max_source_positions"]
    m = rows * t
    layer = [(m, d, 3 * d, 2), (m, d, d, 2), (m, d, ffn, 4), (m, ffn, d, 2)]
    return layer * cfg["encoder_layers"]


def model_flops(cfg: Dict, rows: int, steps: int, prefix: int = 3) -> float:
    """The model's FLOPs for one window of ``rows`` rows, each decoding
    ``steps`` tokens after a ``prefix``-token prefill: the conv stem and
    the encoder at 1500 positions, every decoder layer's cross-K/V, the
    prefill, and every step with its head.  Attention counts QK^T and PV."""
    d, t, v = cfg["d_model"], cfg["max_source_positions"], cfg["vocab_size"]
    ef, df = cfg["encoder_ffn_dim"], cfg["decoder_ffn_dim"]
    el, dl, mels = cfg["encoder_layers"], cfg["decoder_layers"], cfg["num_mel_bins"]
    frames = 2 * t
    stem = 2 * frames * 3 * mels * d + 2 * t * 3 * d * d
    enc_layer = 2 * t * (4 * d * d + 2 * d * ef) + 4 * t * t * d
    cross_kv = dl * 2 * t * 2 * d * d
    dec_proj = 2 * (4 * d * d + 2 * d * d + 2 * d * df)  # self QKV+O, cross Q+O, MLP, per token and layer

    def token(pos_keys: int) -> float:  # one token through the decoder and the head
        return dl * (dec_proj + 4 * pos_keys * d + 4 * t * d) + 2 * d * v

    prefill = sum(token(p + 1) for p in range(prefix))
    loop = sum(token(prefix + s + 1) for s in range(steps))
    return float(rows * (stem + el * enc_layer + cross_kv + prefill + loop))
