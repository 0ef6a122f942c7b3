"""Audio capture: the microphone's device ranking and selection
(``device.py``), the native ALSA runtime (``native/``), and the injected
sources with their capture-side pipeline (copies of
``norma_tpu/audio/{device,sources,pipeline,resample}.py`` and
``norma_tpu/audio/native``)."""

from .device import SupportedConfig, cmp_mic_config, rank_configs, select_device
from .pipeline import Packer, StreamPipeline, to_float
from .resample import StreamingResampler
from .sources import AudioSource, FileSource, SyntheticSource

__all__ = [
    "AudioSource",
    "FileSource",
    "Packer",
    "StreamPipeline",
    "StreamingResampler",
    "SupportedConfig",
    "SyntheticSource",
    "cmp_mic_config",
    "rank_configs",
    "select_device",
    "to_float",
]
