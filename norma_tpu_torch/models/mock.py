"""Mock model for testing (``norma_tpu/models/mock.py``; reference
``src/models/mock.rs``).

Deliberately uses f64 samples at 44.1 kHz (not a typical model rate) so the
capture path exercises sample-format conversion and resampling.
"""

from __future__ import annotations

import numpy as np

from . import CommonModelParams, Model, ModelDefinition

SAMPLE_RATE = 44_100
MSG = "Mock Model"
FINAL_MSG = "Mock Model Out"


class Mock(Model):
    SAMPLE_RATE = SAMPLE_RATE
    dtype = np.float64

    def transcribe(self, data: np.ndarray, final_chunk: bool) -> str:
        return FINAL_MSG if final_chunk else MSG


class MockDef(ModelDefinition):
    def common_params(self) -> CommonModelParams:
        # The reference builds the struct directly (mock.rs:19-24): chunk of
        # one second, raw buffer sizes without the +2 constructor slack.
        p = CommonModelParams(SAMPLE_RATE, 3, 3)
        p.data_buffer_size = 3
        p.string_buffer_size = 3
        return p

    def blocking_try_to_model(self) -> Mock:
        return Mock()
