"""Whisper model configuration (copy of ``norma_tpu/model/config.py``).

The field set is the JAX package's, so a config converts between the two
with ``WhisperConfig(**dataclasses.asdict(other))``.  The knobs this
package reads:

  - ``flash_attention`` / ``encoder_attn_impl``: ``flash_attention=True``
    or "flash" / "jax_flash" run the encoder's self-attention through the
    flash kernel (``ops/flash_encoder.py``); "xla", "auto" and "chunked"
    run the plain attention (the same math on this hardware);
  - ``encoder_q8_mode`` (with ``quantize_encoder`` params): "w8a8" and
    "w8a8_pallas" run the int8 GEMM (``ops/quant_matmul.py``), "w8a16"
    dequantizes and runs the bf16/f32 product;
  - ``cross_kv_impl`` (with an engine's ``quantize_cross_kv``): "kernel"
    lays the codes out for the cross-decode kernel
    (``ops/paged_cross.py``); "einsum", "chunked" and "a8" run the plain
    ``attention_cross_q8`` (the last two are TPU forms recorded as losses);
  - ``self_kv_impl``: "xla" = plain write-row + attention, "kernel" = the
    self-decode kernel (``ops/self_decode.py``);
  - ``decode_buckets``.

The TPU tile / unroll knobs are accepted and ignored: ``encoder_attn_chunk``,
``encoder_unroll``, ``flash_block_q/k``, ``encoder_scores_bf16`` (a
negative result), ``cross_kv_chunk``, ``cross_kv_kernel_hpc``,
``self_kv_kernel_hpc`` and ``decoder_scan_unroll``.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field, replace
from typing import Tuple


# The default suppress list shipped in OpenAI whisper configs (multilingual
# V1 vocab).  Real loads always take the list from the checkpoint's
# config.json; this is only the offline default for presets.
_DEFAULT_SUPPRESS_V1: Tuple[int, ...] = (
    1, 2, 7, 8, 9, 10, 14, 25, 26, 27, 28, 29, 31, 58, 59, 60, 61, 62, 63,
    90, 91, 92, 93, 359, 503, 522, 542, 873, 893, 902, 918, 922, 931, 1350,
    1853, 1982, 2460, 2627, 3246, 3253, 3268, 3536, 3846, 3961, 4183, 4667,
    6585, 6647, 7273, 9061, 9383, 10428, 10929, 11938, 12033, 12331, 12562,
    13793, 14157, 14635, 15265, 15618, 16553, 16604, 18362, 18956, 20075,
    21675, 22520, 26130, 26161, 26435, 28279, 29464, 31650, 32302, 32470,
    36865, 42863, 47425, 49870, 50254, 50258, 50358, 50359, 50360, 50361,
    50362,
)


@dataclass(frozen=True)
class WhisperConfig:
    num_mel_bins: int = 80
    vocab_size: int = 51865
    d_model: int = 384
    encoder_layers: int = 4
    encoder_attention_heads: int = 6
    decoder_layers: int = 4
    decoder_attention_heads: int = 6
    max_source_positions: int = 1500
    max_target_positions: int = 448
    suppress_tokens: Tuple[int, ...] = field(default=_DEFAULT_SUPPRESS_V1)
    # Encoder attention, int8 encoder mode and the quantized cross-K/V
    # layout (see the module docstring); the tile / unroll knobs among
    # these fields are accepted and ignored.
    flash_attention: bool = False
    encoder_attn_impl: str = "auto"
    encoder_attn_chunk: int = 250
    encoder_unroll: int = 1
    flash_block_q: int = 1536
    flash_block_k: int = 1536
    encoder_scores_bf16: bool = False
    encoder_q8_mode: str = "w8a8"
    cross_kv_impl: str = "einsum"
    cross_kv_chunk: int = 500
    cross_kv_kernel_hpc: int = 0
    # Self-attention of the single-token decode step: "xla" writes the new
    # row into the stacked [L, B, T, D] cache and runs the plain masked
    # attention; "kernel" runs the self-decode kernel (ops/self_decode.py),
    # which reads only the rows below the position and writes the new row
    # in place.
    self_kv_impl: str = "xla"
    self_kv_kernel_hpc: int = 0
    decoder_scan_unroll: int = 0
    # Ascending cache-length buckets strictly below max_target_positions,
    # e.g. (128, 256) at mtp=448: the token loop runs tokens at fill < S
    # against a cache cropped to S rows (decode/engine.py).  () = off.
    decode_buckets: Tuple[int, ...] = ()

    @property
    def head_dim(self) -> int:
        return self.d_model // self.encoder_attention_heads

    @classmethod
    def from_hf_dict(cls, d: dict) -> "WhisperConfig":
        return cls(
            num_mel_bins=d["num_mel_bins"],
            vocab_size=d["vocab_size"],
            d_model=d["d_model"],
            encoder_layers=d["encoder_layers"],
            encoder_attention_heads=d["encoder_attention_heads"],
            decoder_layers=d["decoder_layers"],
            decoder_attention_heads=d["decoder_attention_heads"],
            max_source_positions=d.get("max_source_positions", 1500),
            max_target_positions=d.get("max_target_positions", 448),
            suppress_tokens=tuple(d.get("suppress_tokens") or ()),
        )

    @classmethod
    def from_json(cls, path: str) -> "WhisperConfig":
        with open(path, "r") as f:
            return cls.from_hf_dict(json.load(f))

    def with_(self, **kw) -> "WhisperConfig":
        return replace(self, **kw)


def _preset(d_model, heads, enc, dec, *, mels=80, vocab=51865) -> WhisperConfig:
    return WhisperConfig(
        num_mel_bins=mels,
        vocab_size=vocab,
        d_model=d_model,
        encoder_layers=enc,
        encoder_attention_heads=heads,
        decoder_layers=dec,
        decoder_attention_heads=heads,
    )


# Known checkpoint dimensions; the English ("EnV1") vocab has 51864 entries,
# multilingual V1 51865 and V2 (large-v3 era, 128 mels) 51866.
PRESETS = {
    "tiny": _preset(384, 6, 4, 4),
    "tiny.en": _preset(384, 6, 4, 4, vocab=51864),
    "base": _preset(512, 8, 6, 6),
    "base.en": _preset(512, 8, 6, 6, vocab=51864),
    "small": _preset(768, 12, 12, 12),
    "small.en": _preset(768, 12, 12, 12, vocab=51864),
    "medium": _preset(1024, 16, 24, 24),
    "medium.en": _preset(1024, 16, 24, 24, vocab=51864),
    "large": _preset(1280, 20, 32, 32),
    "large-v2": _preset(1280, 20, 32, 32),
    "large-v3": _preset(1280, 20, 32, 32, mels=128, vocab=51866),
    "large-v3-turbo": _preset(1280, 20, 32, 4, mels=128, vocab=51866),
    "distil-medium.en": _preset(1024, 16, 24, 2),
    "distil-large-v2": _preset(1280, 20, 32, 2),
    "distil-large-v3": _preset(1280, 20, 32, 2, mels=128, vocab=51866),
}
