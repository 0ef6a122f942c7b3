"""Pre-quantized params files (``norma_tpu/model/serialize.py``): the
in-memory tree that ``fuse_qkv`` and ``model/quant.py`` produce, flattened
to a safetensors file and loaded back structurally (no HF-name mapping, no
re-quantization).

Format: standard safetensors; tensor names are ``/``-joined tree paths
(``decoder/layers/fc1_w_q``) in the tree's key order, and ``__metadata__``
carries ``{"norma_tpu_format": "params-v1", ...}``, the marker the loader
detects.  ``norma_tpu_torch.tools.quantize_checkpoint`` writes such files
through this module, byte-equal to the JAX package's
``tools/quantize_checkpoint.py``; it reads either.

Codes are stored in their logical layout ([in, out], C order): a head's
pitched rows (``ops/quant_matmul.py::pitched_codes``) and the engine's
K-major encoder codes are views of the same values, written contiguous.
"""

from __future__ import annotations

import json
import os
import struct
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..utils import default_device
from .load import Params, _tensor, read_safetensors

FORMAT_KEY = "norma_tpu_format"
FORMAT_V1 = "params-v1"

_TORCH_TO_ST = {
    torch.float64: "F64",
    torch.float32: "F32",
    torch.float16: "F16",
    torch.bfloat16: "BF16",
    torch.int64: "I64",
    torch.int32: "I32",
    torch.int16: "I16",
    torch.int8: "I8",
    torch.uint8: "U8",
    torch.bool: "BOOL",
}


def _as_tensor(arr) -> torch.Tensor:
    """A CPU tensor in C order from a tensor (any device or layout) or a
    numpy array."""
    if isinstance(arr, torch.Tensor):
        return arr.detach().to("cpu").contiguous()
    return _tensor(np.ascontiguousarray(arr))


def _st_dtype(t: torch.Tensor) -> str:
    try:
        return _TORCH_TO_ST[t.dtype]
    except KeyError:
        raise ValueError(f"unsupported dtype for safetensors: {t.dtype}")


def write_safetensors(
    path: str,
    tensors: Dict[str, Any],
    metadata: Optional[Dict[str, str]] = None,
) -> None:
    """Write a safetensors file (LE u64 header length + JSON + raw bytes) of
    tensors or numpy arrays, in the dict's order; bf16 is stored as BF16."""
    header: Dict[str, Any] = {}
    if metadata:
        header["__metadata__"] = {k: str(v) for k, v in metadata.items()}
    offset = 0
    for name, arr in tensors.items():
        t = arr if isinstance(arr, torch.Tensor) else _as_tensor(arr)
        size = t.numel() * t.element_size()
        header[name] = {
            "dtype": _st_dtype(t),
            "shape": list(t.shape),
            "data_offsets": [offset, offset + size],
        }
        offset += size
    hj = json.dumps(header, separators=(",", ":")).encode("utf-8")
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(hj)))
        f.write(hj)
        for arr in tensors.values():  # one tensor's bytes at a time
            f.write(_as_tensor(arr).reshape(-1).view(torch.uint8).numpy().tobytes())


def flatten_params(params) -> Dict[str, torch.Tensor]:
    """A :class:`~norma_tpu_torch.model.load.Params` tree (or nested dicts)
    -> flat {"a/b/c": CPU tensor in C order}, in the tree's key order."""
    out: Dict[str, torch.Tensor] = {}

    def walk(prefix: str, node: Any) -> None:
        if isinstance(node, (dict, Params)):
            for k, v in node.items():
                if "/" in k:
                    raise ValueError(f"param key {k!r} contains the path separator '/'")
                walk(f"{prefix}/{k}" if prefix else k, v)
        else:
            out[prefix] = _as_tensor(node)

    walk("", params)
    return out


def unflatten_params(flat: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """Inverse of :func:`flatten_params`, as nested dicts."""
    root: Dict[str, Any] = {}
    for name, t in flat.items():
        parts = name.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = t
    return root


def save_params(path: str, params, metadata: Optional[Dict[str, str]] = None) -> None:
    meta = {FORMAT_KEY: FORMAT_V1}
    if metadata:
        meta.update({k: str(v) for k, v in metadata.items()})
    write_safetensors(path, flatten_params(params), meta)


def _read_header(path: str) -> Tuple[int, Dict[str, Any]]:
    size = os.path.getsize(path)
    with open(path, "rb") as f:
        raw = f.read(8)
        if len(raw) < 8:
            raise ValueError(f"{path}: too short to be a safetensors file")
        (header_len,) = struct.unpack("<Q", raw)
        # Checked before reading: the u64 of a non-safetensors file (a GGUF
        # magic and version decode to ~14 GB) would drive a giant read.
        if header_len > size - 8:
            raise ValueError(
                f"{path}: not a safetensors file (header length "
                f"{header_len} exceeds file size {size})"
            )
        try:
            return header_len, json.loads(f.read(header_len).decode("utf-8"))
        except (UnicodeDecodeError, json.JSONDecodeError) as e:
            raise ValueError(f"{path}: not a safetensors file ({e})") from e


def peek_format(path: str) -> Optional[Dict[str, str]]:
    """The file's ``__metadata__`` if it is a params file, else None (a
    plain HF checkpoint).  Reads only the JSON header."""
    _, header = _read_header(path)
    meta = header.get("__metadata__") or {}
    return meta if meta.get(FORMAT_KEY) else None


def load_params_file(path: str, device: "torch.device | str | None" = None) -> Tuple[Params, Dict[str, str]]:
    """Load a params-v1 file -> (:class:`Params` on ``device``, metadata);
    None: the card where there is one, else the CPU.
    Every leaf keeps the dtype it was stored in (BF16 included)."""
    _, header = _read_header(path)
    meta = header.get("__metadata__") or {}
    if not meta.get(FORMAT_KEY):
        raise ValueError(f"{path}: not a norma-tpu params file (missing {FORMAT_KEY!r} metadata)")
    if meta[FORMAT_KEY] != FORMAT_V1:
        raise ValueError(f"{path}: unsupported {FORMAT_KEY}={meta[FORMAT_KEY]!r}")
    device = default_device(device)
    flat = {}
    for name, arr in read_safetensors(path).items():
        t = _tensor(arr)
        if header[name]["dtype"] == "BF16":  # read widened to f32: exact
            t = t.to(torch.bfloat16)
        flat[name] = t.to(device)
    return Params(unflatten_params(flat)), meta
