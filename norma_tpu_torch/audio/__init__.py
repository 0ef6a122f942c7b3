"""Audio capture sources and the capture-side pipeline (copies of
``norma_tpu/audio/{sources,pipeline,resample}.py``; the microphone device
selection and the native ring are not ported)."""

from .pipeline import Packer, StreamPipeline, to_float
from .resample import StreamingResampler
from .sources import AudioSource, FileSource, SyntheticSource

__all__ = [
    "AudioSource",
    "FileSource",
    "Packer",
    "StreamPipeline",
    "StreamingResampler",
    "SyntheticSource",
    "to_float",
]
