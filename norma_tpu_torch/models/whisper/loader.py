"""Shared checkpoint loader for the whisper Definitions
(``norma_tpu/models/whisper/loader.py``; reference ``monolingual.rs:186-451``).

Resolve config/tokenizer/weights (a local directory, or the HF hub at a
pinned revision), parse the config, load the weights onto the selected
device, apply the quantization tiers, resolve the special tokens and build
the decode engine (which builds the suppression masks from the config's
suppress list, as ``monolingual.rs:252-296`` does).

Not ported yet (each raises ``NotImplementedError`` naming ROADMAP queue 1):
GGUF q8_0 checkpoints (``quantized_ext``, the JAX package's
``model/gguf.py``), pre-quantized params files (``model/serialize.py``) and
speculative draft checkpoints (``decode/speculative.py``).
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import struct
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from ...constants import TRANSCRIBE_TOKEN
from ...decode import DecodeEngine, LanguageState, SpecialTokens
from ...errors import MelBinsError, WhisperError
from ...model.config import WhisperConfig
from ...model.load import fuse_qkv, load_safetensors
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

# The key a pre-quantized params file carries in its safetensors metadata
# (the JAX package's model/serialize.py FORMAT_KEY).
_PARAMS_FORMAT_KEY = "norma_tpu_format"


def _not_ported(what: str, module: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to norma_tpu_torch yet (ROADMAP queue 1: the JAX package's {module})"
    )


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


def _is_params_file(path: str) -> bool:
    """Whether a .safetensors file is a pre-quantized params file (its
    metadata carries the params-file format key); reads the header only."""
    with open(path, "rb") as f:
        head = f.read(8)
        if len(head) < 8:
            return False
        (n,) = struct.unpack("<Q", head)
        try:
            header = json.loads(f.read(n).decode("utf-8"))
        except (UnicodeDecodeError, json.JSONDecodeError):
            return False
    meta = header.get("__metadata__") if isinstance(header, dict) else None
    return bool(isinstance(meta, dict) and meta.get(_PARAMS_FORMAT_KEY))


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
    or the head alone, then the encoder.
    """
    # True/"int8" -> per-channel int8 head; "int4" -> blockwise int4.
    # Validated before anything is read.
    if quantize_logits not in (None, False, True, "int8", "int4"):
        raise ValueError(
            f"quantize_logits={quantize_logits!r}: expected True, False, 'int8' or 'int4'"
        )
    if draft_repo_id is not None or draft_files is not None or draft_local_dir is not None:
        raise _not_ported("speculative decoding with a draft checkpoint", "decode/speculative.py")
    if quantized_ext is not None:
        raise _not_ported(f"the GGUF q8_0 checkpoint ({quantized_ext!r})", "model/gguf.py")
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
    if _is_params_file(files.weights):
        raise _not_ported("a pre-quantized params file", "model/serialize.py")
    params = fuse_qkv(load_safetensors(files.weights, cfg, dtype, dev))
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
