"""Shared checkpoint loader for the whisper Definitions
(``norma_tpu/models/whisper/loader.py``; reference ``monolingual.rs:186-451``).

Resolve config/tokenizer/weights (a local directory, or the HF hub at a
pinned revision), parse the config, load the weights onto the selected
device (an HF safetensors checkpoint, a GGUF q8_0 one, or a pre-quantized
params file), apply the quantization tiers, resolve the special tokens and
build the decode engine (which builds the suppression masks from the
config's suppress list, as ``monolingual.rs:252-296`` does): a
:class:`~norma_tpu_torch.decode.DecodeEngine`, or with a draft checkpoint a
:class:`~norma_tpu_torch.decode.SpeculativeEngine`.
"""

from __future__ import annotations

import dataclasses
import logging
import os
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from ...constants import TRANSCRIBE_TOKEN
from ...decode import DecodeEngine, LanguageState, SpecialTokens, SpeculativeEngine
from ...errors import MelBinsError, WhisperError
from ...model.config import WhisperConfig
from ...model.gguf import load_gguf_q8
from ...model.load import fuse_qkv, load_safetensors
from ...model.serialize import load_params_file, peek_format
from ...model.quant import (
    quantize_decoder as _quantize_decoder,
    quantize_encoder as _quantize_encoder,
    quantize_logits_head,
    quantize_logits_head_int4,
)
from ...tracing import instrument
from .. import SelectedDevice
from . import token_id
from .languages import ALL_LANGUAGES
from .model import WhisperModel
from .tokenizer import WhisperTokenizer

logger = logging.getLogger("norma_tpu_torch.loader")

# The JAX package's dtype names, so a Definition's to_dict() loads in either.
_DTYPE_NAMES = {torch.float32: "f32", torch.bfloat16: "bf16", torch.float16: "f16"}
_DTYPE_FROM_NAME = {v: k for k, v in _DTYPE_NAMES.items()}

def definition_ext_to_dict(defn) -> dict:
    """Serialize the extension fields both Definitions share (the JAX
    package's payload, so its Definitions and these load each other's)."""
    d = {
        "dtype": _DTYPE_NAMES.get(defn.dtype, "f32"),
        "quantize_logits": defn.quantize_logits,
        "quantize_decoder": defn.quantize_decoder,
        "quantize_encoder": defn.quantize_encoder,
        "quantize_cross_kv": defn.quantize_cross_kv,
        "quantize_self_kv": defn.quantize_self_kv,
        "mel_center": defn.mel_center,
        "timestamps": defn.timestamps,
        "spec_k": defn.spec_k,
    }
    if defn.config_overrides:
        d["config_overrides"] = dict(defn.config_overrides)
    # Optional fields only when set (keeps old payloads readable).
    if defn.local_dir:
        d["local_dir"] = defn.local_dir
    if defn.draft:
        d["draft"] = defn.draft
    if defn.draft_local_dir:
        d["draft_local_dir"] = defn.draft_local_dir
    return d


def apply_definition_ext(defn, d: dict) -> None:
    """Restore the fields written by :func:`definition_ext_to_dict`
    (payloads from before a field existed get its default)."""
    defn.dtype = _DTYPE_FROM_NAME.get(d.get("dtype", "f32"), torch.float32)
    defn.quantize_logits = d.get("quantize_logits", False)
    defn.quantize_decoder = d.get("quantize_decoder", False)
    defn.quantize_encoder = d.get("quantize_encoder", False)
    defn.quantize_cross_kv = d.get("quantize_cross_kv", False)
    defn.quantize_self_kv = d.get("quantize_self_kv", False)
    defn.mel_center = d.get("mel_center", False)
    defn.timestamps = d.get("timestamps", False)
    defn.spec_k = d.get("spec_k", 4)
    defn.local_dir = d.get("local_dir")
    defn.draft = d.get("draft")
    defn.draft_local_dir = d.get("draft_local_dir")
    defn.config_overrides = d.get("config_overrides")


@dataclass(frozen=True)
class CheckpointFiles:
    config: str
    tokenizer: str
    weights: str


def _file_names(quantized_ext: Optional[str]) -> Tuple[str, str, str]:
    """monolingual.rs:189-211: quantized checkpoints use ``config-{ext}.json``
    / ``tokenizer-{ext}.json`` / ``model-{ext}-q80.gguf``, the others
    ``config.json`` / ``tokenizer.json`` / ``model.safetensors``."""
    if quantized_ext is not None:
        return (
            f"config-{quantized_ext}.json",
            f"tokenizer-{quantized_ext}.json",
            f"model-{quantized_ext}-q80.gguf",
        )
    return ("config.json", "tokenizer.json", "model.safetensors")


def _local_files(local_dir: str, names) -> CheckpointFiles:
    paths = tuple(os.path.join(local_dir, n) for n in names)
    for p in paths:
        if not os.path.exists(p):
            raise WhisperError(f"checkpoint file not found: {p}")
    return CheckpointFiles(*paths)


def _hub_download(repo_id: str, filename: str, revision: str) -> str:
    """One hub fetch (cache-aware); the one place ``huggingface_hub`` is
    imported."""
    try:
        from huggingface_hub import hf_hub_download
    except ImportError as e:
        raise WhisperError("huggingface_hub unavailable and no local_dir given") from e
    return hf_hub_download(repo_id=repo_id, filename=filename, revision=revision)


def resolve_files(
    repo_id: str,
    revision: str,
    quantized_ext: Optional[str],
    local_dir: Optional[str] = None,
) -> CheckpointFiles:
    """Find config/tokenizer/weights locally or on the HF hub (blocking)."""
    names = _file_names(quantized_ext)
    if local_dir is not None:
        return _local_files(local_dir, names)
    return CheckpointFiles(*(_hub_download(repo_id, n, revision) for n in names))


async def resolve_files_async(
    repo_id: str,
    revision: str,
    quantized_ext: Optional[str],
    local_dir: Optional[str] = None,
) -> CheckpointFiles:
    """:func:`resolve_files` with the three hub fetches running concurrently
    (each in a thread), so several loads awaited together overlap."""
    import asyncio

    names = _file_names(quantized_ext)
    if local_dir is not None:
        return _local_files(local_dir, names)
    paths = await asyncio.gather(
        *(asyncio.to_thread(_hub_download, repo_id, n, revision) for n in names)
    )
    return CheckpointFiles(*paths)


_SELF_KV_WITH_DRAFT = (
    "quantize_self_kv is not supported with speculative decoding (the "
    "draft/verify cache paths keep bf16/f32 self-KV); checked before any file is read"
)


def _warn_prequantized(meta: dict, dtype, quantize_logits, quantize_decoder, quantize_encoder) -> None:
    """A params file fixes its dtype and quant tiers at conversion time;
    the Definition's dtype= and quantize_* flags are not applied to it.
    Warn where they ask for something the file does not have."""
    file_dt = meta.get("dtype")
    want_dt = _DTYPE_NAMES.get(dtype, str(dtype))
    if file_dt and file_dt != want_dt:
        logger.warning(
            "pre-quantized params file was converted at dtype=%s; the requested "
            "dtype=%s is ignored (re-run python -m norma_tpu_torch.tools.quantize_checkpoint --dtype to change it)",
            file_dt, want_dt,
        )
    want_tiers = set()
    if quantize_decoder:
        want_tiers.add("decoder-w8")
        if quantize_logits == "int4":
            want_tiers.add("logits-int4")
    elif quantize_logits:
        want_tiers.add("logits-int4" if quantize_logits == "int4" else "logits-w8")
    if quantize_encoder:
        want_tiers.add("encoder-w8a8")
    file_tiers = {t for t in (meta.get("quant") or "").split("+") if t and t != "none"}
    if want_tiers - file_tiers:
        logger.warning(
            "pre-quantized params file has quant tiers %s; the requested %s are "
            "ignored (re-run python -m norma_tpu_torch.tools.quantize_checkpoint with the matching flags)",
            sorted(file_tiers) or "none", sorted(want_tiers - file_tiers),
        )


@instrument(
    fields={"repo_id": lambda a: a.get("repo_id"), "revision": lambda a: a.get("revision")}
)  # reference #[instrument], monolingual.rs:185,319
def build_model(
    *,
    repo_id: str,
    revision: str,
    quantized_ext: Optional[str],
    device: SelectedDevice,
    task_token_str: str = TRANSCRIBE_TOKEN,
    const_language_token_str: Optional[str] = None,
    local_dir: Optional[str] = None,
    dtype: torch.dtype = torch.float32,
    seed: int = 0,
    quantize_logits: "bool | str" = False,
    quantize_decoder: bool = False,
    quantize_encoder: bool = False,
    quantize_cross_kv: "bool | str" = False,
    quantize_self_kv: bool = False,
    mel_center: bool = False,
    timestamps: bool = False,
    config_overrides: Optional[dict] = None,
    files: Optional[CheckpointFiles] = None,
    draft_repo_id: Optional[str] = None,
    draft_revision: str = "main",
    draft_local_dir: Optional[str] = None,
    draft_files: Optional[CheckpointFiles] = None,
    spec_k: "int | str" = 4,
) -> WhisperModel:
    """Build a WhisperModel from a checkpoint.

    ``const_language_token_str`` set => monolingual (ConstLang); otherwise
    the model detects the language per utterance (Detect).  ``files``
    short-circuits resolution.  The quantization tiers apply in the JAX
    package's order: fused QKV, then the decoder (its int8 or int4 head)
    or the head alone, then the encoder; a params file is loaded as it was
    converted.  ``draft_repo_id`` / ``draft_local_dir`` / ``draft_files``
    select a draft checkpoint (an HF safetensors or a params file) and the
    speculative engine, proposing ``spec_k`` tokens per round.
    """
    # True/"int8" -> per-channel int8 head; "int4" -> blockwise int4.
    # Validated before anything is read.
    if quantize_logits not in (None, False, True, "int8", "int4"):
        raise ValueError(
            f"quantize_logits={quantize_logits!r}: expected True, False, 'int8' or 'int4'"
        )
    draft = draft_repo_id is not None or draft_files is not None or draft_local_dir is not None
    if draft and quantize_self_kv:
        raise ValueError(_SELF_KV_WITH_DRAFT)
    if files is None:
        files = resolve_files(repo_id, revision, quantized_ext, local_dir)
    cfg = WhisperConfig.from_json(files.config)
    if cfg.num_mel_bins not in (80, 128):
        # The reference's check (monolingual.rs:355-358); the JAX loader
        # imports the error but never raises it.
        raise MelBinsError(cfg.num_mel_bins)
    if config_overrides:
        # Serving knobs a checkpoint's config.json cannot carry
        # (encoder_attn_impl, cross_kv_impl, max_target_positions, ...).
        valid = {f.name for f in dataclasses.fields(WhisperConfig)}
        unknown = set(config_overrides) - valid
        if unknown:
            raise ValueError(
                f"unknown WhisperConfig field(s) in config_overrides: "
                f"{sorted(unknown)}; valid fields: {sorted(valid)}"
            )
        cfg = cfg.with_(**config_overrides)
    if cfg.max_target_positions >= 448 and not cfg.decode_buckets and not (
        config_overrides and "decode_buckets" in config_overrides
    ):
        # Bucketed decode by default at production decode lengths (the
        # JAX package's default; bitwise-identical output).  Disable with
        # config_overrides={"decode_buckets": ()}.
        cfg = cfg.with_(decode_buckets=(128, 256))
    tokenizer = WhisperTokenizer.from_file(files.tokenizer)

    dev = device.to_torch_device()
    meta = None if quantized_ext is not None else peek_format(files.weights)
    if meta is not None:
        # A params file (norma_tpu_torch.tools.quantize_checkpoint): loaded as stored,
        # with no HF-name mapping, QKV fusion or re-quantization.
        params, meta = load_params_file(files.weights, dev)
        _warn_prequantized(meta, dtype, quantize_logits, quantize_decoder, quantize_encoder)
    else:
        if quantized_ext is not None:  # GGUF q8_0, dequantized to dtype
            params = load_gguf_q8(files.weights, cfg, dtype, dev)
        else:
            params = load_safetensors(files.weights, cfg, dtype, dev)
        params = fuse_qkv(params)
        if quantize_decoder:
            # An int4 head request composes with the int8 layers.
            params = _quantize_decoder(params, logits="int4" if quantize_logits == "int4" else "int8")
        elif quantize_logits == "int4":
            params = quantize_logits_head_int4(params)
        elif quantize_logits:
            params = quantize_logits_head(params)
        if quantize_encoder:
            params = _quantize_encoder(params)

    st = SpecialTokens.from_tokenizer(tokenizer, task_token_str)
    lang_token_ids = [token_id(tokenizer, lang.token()) for lang in ALL_LANGUAGES]
    if const_language_token_str is not None:
        lang_state = LanguageState(const=token_id(tokenizer, const_language_token_str))
    else:
        lang_state = LanguageState()
    if draft:
        # A shallow same-vocab draft: speculative greedy decoding, token for
        # token the target's own.  config_overrides apply to the target only.
        if draft_files is None:
            draft_files = resolve_files(draft_repo_id, draft_revision, None, draft_local_dir)
        draft_cfg = WhisperConfig.from_json(draft_files.config)
        if peek_format(draft_files.weights):
            draft_params, _ = load_params_file(draft_files.weights, dev)
        else:
            draft_params = fuse_qkv(load_safetensors(draft_files.weights, draft_cfg, dtype, dev))
        engine = SpeculativeEngine(
            params, cfg, draft_params, draft_cfg, st,
            language_token_ids=lang_token_ids,
            mel_center=mel_center,
            quantize_cross_kv=quantize_cross_kv,
            spec_k=spec_k,
        )
    else:
        engine = DecodeEngine(
            params, cfg, st,
            language_token_ids=lang_token_ids,
            mel_center=mel_center,
            quantize_cross_kv=quantize_cross_kv,
            quantize_self_kv=quantize_self_kv,
        )
    return WhisperModel(
        engine,
        tokenizer,
        lang_state,
        language_tokens=lang_token_ids,
        seed=seed,
        timestamps=timestamps,
    )


async def build_model_async(**kwargs) -> WhisperModel:
    """:func:`build_model` with the checkpoint files resolved concurrently
    (a speculative build's draft files alongside the target's), then the
    build in a thread off the event loop."""
    import asyncio

    draft_wanted = (
        kwargs.get("draft_repo_id") is not None or kwargs.get("draft_local_dir") is not None
    ) and kwargs.get("draft_files") is None
    # Before any coroutine exists: a raise after would leak one never awaited.
    if draft_wanted and kwargs.get("quantize_self_kv"):
        raise ValueError(_SELF_KV_WITH_DRAFT)
    target = resolve_files_async(
        kwargs["repo_id"], kwargs["revision"], kwargs["quantized_ext"], kwargs.get("local_dir")
    )
    if draft_wanted:
        files, draft_files = await asyncio.gather(
            target,
            resolve_files_async(
                kwargs.get("draft_repo_id"), kwargs.get("draft_revision", "main"), None,
                kwargs.get("draft_local_dir"),
            ),
        )
        kwargs["draft_files"] = draft_files
    else:
        files = await target
    return await asyncio.to_thread(build_model, files=files, **kwargs)
