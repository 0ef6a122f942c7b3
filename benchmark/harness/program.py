"""The system under test, built from a configuration file: the port's
``DecodeEngine`` on weights the benchmark drew, with the configuration's
serving stack.  This module and the drivers are the only places that
import the program."""

from __future__ import annotations

from typing import Dict

import torch

from .weights import make_weights


class IdsTokenizer:
    """Text as the token ids: the benchmark reads ids, not words."""

    def decode(self, ids, skip_special_tokens=True):
        return " ".join(str(int(i)) for i in ids)


def whisper_config(cfg: Dict):
    """The program's ``WhisperConfig`` of a configuration file."""
    from norma_tpu_torch.model import WhisperConfig

    s = cfg["serving"]
    return WhisperConfig(
        num_mel_bins=cfg["num_mel_bins"], vocab_size=cfg["vocab_size"], d_model=cfg["d_model"],
        encoder_layers=cfg["encoder_layers"], encoder_attention_heads=cfg["encoder_attention_heads"],
        decoder_layers=cfg["decoder_layers"], decoder_attention_heads=cfg["decoder_attention_heads"],
        max_source_positions=cfg["max_source_positions"], max_target_positions=cfg["max_target_positions"],
        suppress_tokens=tuple(cfg["assumed"]["suppress_tokens"]),
        encoder_attn_impl=s["encoder_attn_impl"], encoder_q8_mode=s["encoder_q8_mode"],
        cross_kv_impl=s["cross_kv_impl"], self_kv_impl=s["self_kv_impl"],
        decode_buckets=tuple(s["decode_buckets"]),
    )


def language_ids(cfg: Dict):
    lo, hi = cfg["assumed"]["language_token_ids"]
    return list(range(lo, hi + 1))


def build_engine(cfg: Dict, seed: int, device):
    """The engine on the configuration's serving stack, its weights drawn
    from ``seed`` on ``device`` (the draws are dropped once quantized)."""
    from norma_tpu_torch.decode import DecodeEngine, SpecialTokens
    from norma_tpu_torch.model import fuse_qkv
    from norma_tpu_torch.model.load import Params
    from norma_tpu_torch.model.quant import quantize_decoder, quantize_encoder

    s = cfg["serving"]
    if s["dtype"] != "bfloat16":
        raise ValueError(f"serving dtype {s['dtype']!r}: the weights are drawn in bfloat16")
    params = Params(make_weights(cfg, seed, device))
    if s["fuse_qkv"]:
        params = fuse_qkv(params)
    if s["quantize_decoder"]:
        params = quantize_decoder(params, logits=s["quantize_decoder"])
    if s["quantize_encoder"]:
        params = quantize_encoder(params)
    special = {k: cfg["assumed"]["special_tokens"][k]
               for k in ("sot", "eot", "task", "no_speech", "no_timestamps", "zero_sec", "one_sec")}
    return DecodeEngine(params, whisper_config(cfg), SpecialTokens(**special),
                        language_token_ids=language_ids(cfg), quantize_cross_kv=s["quantize_cross_kv"])


def build_model(engine, cfg: Dict):
    """The public model around ``engine``, its language fixed."""
    from norma_tpu_torch.decode import LanguageState
    from norma_tpu_torch.models.whisper import WhisperModel

    lang = cfg["assumed"]["language"]
    return WhisperModel(engine, IdsTokenizer(), LanguageState(const=lang), language_tokens=language_ids(cfg))


def window_samples(cfg: Dict) -> int:
    """Padded PCM samples of a whole window: its frames' extent (the last
    frame starts at (frames - 1) * 160 and reads 400)."""
    return (2 * cfg["max_source_positions"] - 1) * 160 + 400


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def peak(device) -> int:
    """Bytes the card's allocator has held at most since its last reset
    (0 without a card)."""
    return torch.cuda.max_memory_allocated(device) if torch.device(device).type == "cuda" else 0


def reset_peak(device) -> int:
    """The peak so far, then a reset: the next :func:`peak` is the
    serving window's own."""
    p = peak(device)
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    return p
