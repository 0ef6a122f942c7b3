"""Input-device enumeration and config ranking.

A copy of ``norma_tpu/audio/device.py``: the reference's device selection
+ ``cmp_mic_config`` (``src/lib.rs:502-600``).  Honor
``Settings.selected_device`` with the OnError fallback policy, then rank
the device's supported configs:

  1. configs that support the model sample rate beat those that don't;
     among supporters, a sample format matching the model's data type wins
  2. among non-supporters: f64 beats other formats, then any float beats
     integer formats
  3. mono beats multi-channel

The actual hardware enumeration comes from the C++ ALSA extension
(audio/native); this module holds the pure ranking/selection logic so it is
testable without hardware.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np

from ..dtype import is_valid_model_dtype, sample_format_name
from ..errors import DeviceError, NoConfigFound, SelectedDeviceNotFound
from ..input import OnError, Settings


@dataclass(frozen=True)
class SupportedConfig:
    """One supported stream config range (cpal SupportedStreamConfigRange)."""

    min_sample_rate: int
    max_sample_rate: int
    sample_format: str  # "i8","i16","i32","i64","u8","u16","u32","u64","f32","f64"
    channels: int

    @property
    def is_float(self) -> bool:
        return self.sample_format.startswith("f")

    def supports_rate(self, rate: int) -> bool:
        return self.min_sample_rate <= rate <= self.max_sample_rate

    def pick_rate(self, target: int) -> int:
        """Prefer the model rate, else the max rate (lib.rs:538-541)."""
        return target if self.supports_rate(target) else self.max_sample_rate

    def numpy_dtype(self):
        return np.dtype(
            {
                "i8": np.int8, "i16": np.int16, "i32": np.int32, "i64": np.int64,
                "u8": np.uint8, "u16": np.uint16, "u32": np.uint32, "u64": np.uint64,
                "f32": np.float32, "f64": np.float64,
            }[self.sample_format]
        )


def _dtype_format(dtype) -> str:
    """Model data dtype -> matching sample-format string.

    Enforces the reference's sealed-DType invariant (dtype.rs:38-42): a
    Model's PCM dtype must be one of u8/u32/f32/f64.  Rust makes this a
    compile-time bound; here an invalid dtype errors at stream build
    instead of silently ranking configs as if the model wanted f32.
    """
    if not is_valid_model_dtype(dtype):
        raise ValueError(
            f"model dtype {np.dtype(dtype)} is not a valid PCM data type "
            "(expected one of u8/u32/f32/f64, dtype.py VALID_MODEL_DTYPES)"
        )
    return sample_format_name(dtype)


def cmp_mic_config(lhs: SupportedConfig, rhs: SupportedConfig, model_rate: int, model_format: str) -> int:
    """Reference ordering (lib.rs:559-600); returns <0, 0, >0 like C cmp."""

    def b(x: bool) -> int:
        return 1 if x else 0

    lhs_rate = lhs.supports_rate(model_rate)
    rhs_rate = rhs.supports_rate(model_rate)

    if lhs_rate and rhs_rate:
        c = b(lhs.sample_format == model_format) - b(rhs.sample_format == model_format)
        if c != 0:
            return c
    else:
        c = b(lhs_rate) - b(rhs_rate)
        if c != 0:
            return c
        c = b(lhs.sample_format == "f64") - b(rhs.sample_format == "f64")
        if c != 0:
            return c
        c = b(lhs.is_float) - b(rhs.is_float)
        if c != 0:
            return c

    return b(lhs.channels == 1) - b(rhs.channels == 1)


def rank_configs(
    configs: Sequence[SupportedConfig], model_rate: int, model_dtype
) -> List[SupportedConfig]:
    """Sort ascending by preference; BEST LAST (the reference pops from the
    sorted vec's tail, lib.rs:530-533)."""
    fmt = _dtype_format(model_dtype)
    return sorted(
        configs,
        key=functools.cmp_to_key(
            lambda a, c: cmp_mic_config(a, c, model_rate, fmt)
        ),
    )


def select_device(
    devices: Sequence[str], settings: Settings, default: Optional[str]
) -> str:
    """Pick a device name per Settings (reference: lib.rs:508-525)."""
    if settings.selected_device is not None:
        if settings.selected_device in devices:
            return settings.selected_device
        if settings.on_error is OnError.ERROR:
            raise SelectedDeviceNotFound()
        # fall through to default
    if default is None:
        raise DeviceError()
    return default
