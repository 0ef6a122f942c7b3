from .config import PRESETS, WhisperConfig
from .load import (
    Params,
    fuse_qkv,
    init_params,
    load_safetensors,
    param_count,
    params_from_hf_tensors,
    params_from_numpy,
    params_to_numpy,
    read_safetensors,
)
from .whisper import (
    cross_kv,
    decoder_chunk,
    decoder_full,
    decoder_prefill,
    decoder_step,
    encode,
    sinusoids,
)

__all__ = [
    "PRESETS",
    "Params",
    "WhisperConfig",
    "fuse_qkv",
    "init_params",
    "load_safetensors",
    "param_count",
    "params_from_hf_tensors",
    "params_from_numpy",
    "params_to_numpy",
    "read_safetensors",
    "cross_kv",
    "decoder_chunk",
    "decoder_full",
    "decoder_prefill",
    "decoder_step",
    "encode",
    "sinusoids",
]
