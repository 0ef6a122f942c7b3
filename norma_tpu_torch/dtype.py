"""Sample-format / model-dtype bridge.

A copy of ``norma_tpu/dtype.py``: the reference's sealed ``DType`` trait
(``src/dtype.rs``).  Models consume one of the VALID dtypes (u8, u32, f32,
f64 — the formats candle tensors accept); any capture format
(i8/i16/i32/i64/u16/u64 included) is converted on the capture thread.
"""

from __future__ import annotations

import numpy as np

# Valid model data dtypes (dtype.rs:38-42).
VALID_MODEL_DTYPES = (np.uint8, np.uint32, np.float32, np.float64)

# All capture formats that can be converted into a model dtype (dtype.rs:44).
CONVERTIBLE_FORMATS = (
    np.int8, np.int16, np.int32, np.int64,
    np.uint8, np.uint16, np.uint32, np.uint64,
    np.float32, np.float64,
)

_FORMAT_NAMES = {
    np.dtype(np.int8): "i8", np.dtype(np.int16): "i16",
    np.dtype(np.int32): "i32", np.dtype(np.int64): "i64",
    np.dtype(np.uint8): "u8", np.dtype(np.uint16): "u16",
    np.dtype(np.uint32): "u32", np.dtype(np.uint64): "u64",
    np.dtype(np.float32): "f32", np.dtype(np.float64): "f64",
}


def is_valid_model_dtype(dtype) -> bool:
    return np.dtype(dtype) in {np.dtype(d) for d in VALID_MODEL_DTYPES}


def sample_format_name(dtype) -> str:
    """cpal-style sample-format name for a numpy dtype (dtype.rs to_sample_fromat)."""
    return _FORMAT_NAMES[np.dtype(dtype)]
