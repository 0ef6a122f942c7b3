"""Dependency-free GGUF reader with q8_0 dequantization
(``norma_tpu/model/gguf.py``, numpy only).

Replaces the reference's quantized path
(``candle_transformers::quantized_var_builder::VarBuilder::from_gguf``,
monolingual.rs:231-235).  The quantized checkpoints the reference pins
(``lmz/candle-whisper`` ``model-*-q80.gguf``) store q8_0 blocks: 32 weights
as int8 with one f16 scale (34 bytes/block).

Loading dequantizes to the requested compute dtype.  The q8_0 per-32-block
scale layout is NOT shape-compatible with the serving int8 path's
per-out-channel scales (``quant.py``), so a direct int8->int8 reuse is
deliberately absent: re-quantizing from the dequantized floats
(``quantize_decoder``) is the supported route.
"""

from __future__ import annotations

import mmap
import struct
from typing import Any, Dict, Tuple

import numpy as np

GGUF_MAGIC = 0x46554747  # 'GGUF' little-endian

# ggml tensor types we support
GGML_F32 = 0
GGML_F16 = 1
GGML_Q8_0 = 8

_VALUE_FMT = {
    0: ("<B", 1),  # u8
    1: ("<b", 1),  # i8
    2: ("<H", 2),  # u16
    3: ("<h", 2),  # i16
    4: ("<I", 4),  # u32
    5: ("<i", 4),  # i32
    6: ("<f", 4),  # f32
    7: ("<?", 1),  # bool
    10: ("<Q", 8),  # u64
    11: ("<q", 8),  # i64
    12: ("<d", 8),  # f64
}


class _Reader:
    def __init__(self, buf) -> None:
        self.buf = buf
        self.pos = 0

    def read(self, n: int) -> bytes:
        out = self.buf[self.pos : self.pos + n]
        self.pos += n
        return out

    def scalar(self, fmt: str, size: int):
        (v,) = struct.unpack(fmt, self.read(size))
        return v

    def u32(self) -> int:
        return self.scalar("<I", 4)

    def u64(self) -> int:
        return self.scalar("<Q", 8)

    def string(self) -> str:
        n = self.u64()
        return self.read(n).decode("utf-8")

    def value(self, vtype: int):
        if vtype == 8:
            return self.string()
        if vtype == 9:  # array
            etype = self.u32()
            count = self.u64()
            return [self.value(etype) for _ in range(count)]
        fmt, size = _VALUE_FMT[vtype]
        return self.scalar(fmt, size)


def dequant_q8_0(raw: bytes, n_elems: int) -> np.ndarray:
    """q8_0: blocks of (f16 scale, 32 x i8) -> f32 array of n_elems."""
    n_blocks = n_elems // 32
    rec = np.frombuffer(raw, dtype=np.uint8).reshape(n_blocks, 34)
    scales = rec[:, :2].copy().view(np.float16).astype(np.float32)  # [nb,1]
    qs = rec[:, 2:].copy().view(np.int8).astype(np.float32)  # [nb,32]
    return (qs * scales).reshape(n_elems)


def read_gguf(path: str) -> Tuple[Dict[str, Any], Dict[str, np.ndarray]]:
    """Read a GGUF file -> (metadata dict, {name: np.ndarray f32}).

    Tensor dims in GGUF are in ggml order (fastest-varying first); returned
    arrays use numpy convention (reversed), matching the HF layout candle
    sees after its own load.
    """
    with open(path, "rb") as f:
        mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
    r = _Reader(mm)
    magic = r.u32()
    if magic != GGUF_MAGIC:
        raise ValueError(f"not a GGUF file: magic={magic:#x}")
    version = r.u32()
    if version < 2:
        raise ValueError(f"unsupported GGUF version {version}")
    n_tensors = r.u64()
    n_kv = r.u64()

    meta: Dict[str, Any] = {}
    for _ in range(n_kv):
        key = r.string()
        vtype = r.u32()
        meta[key] = r.value(vtype)

    infos = []
    for _ in range(n_tensors):
        name = r.string()
        n_dims = r.u32()
        dims = [r.u64() for _ in range(n_dims)]
        ttype = r.u32()
        offset = r.u64()
        infos.append((name, dims, ttype, offset))

    alignment = int(meta.get("general.alignment", 32))
    data_start = (r.pos + alignment - 1) // alignment * alignment

    tensors: Dict[str, np.ndarray] = {}
    for name, dims, ttype, offset in infos:
        n_elems = 1
        for d in dims:
            n_elems *= d
        shape = tuple(reversed(dims))
        start = data_start + offset
        if ttype == GGML_F32:
            arr = np.frombuffer(mm, np.float32, n_elems, start).reshape(shape)
        elif ttype == GGML_F16:
            arr = (
                np.frombuffer(mm, np.float16, n_elems, start)
                .astype(np.float32)
                .reshape(shape)
            )
        elif ttype == GGML_Q8_0:
            nbytes = (n_elems // 32) * 34
            arr = dequant_q8_0(mm[start : start + nbytes], n_elems).reshape(shape)
        else:
            raise ValueError(f"unsupported ggml tensor type {ttype} for {name}")
        tensors[name] = arr
    return meta, tensors


def load_gguf_q8(path: str, cfg, dtype, device=None):
    """GGUF checkpoint -> :class:`~norma_tpu_torch.model.load.Params` on
    ``device`` (dequantized to ``dtype``; None: the card where there is
    one, else the CPU)."""
    from .load import params_from_hf_tensors

    _, tensors = read_gguf(path)
    return params_from_hf_tensors(tensors, cfg, dtype, device)
