"""norma-tpu's Whisper streaming path in PyTorch, with hand-written Hopper kernels.

A port of the JAX package ``norma_tpu`` (which stays the reference).  Module
paths and function names mirror ``norma_tpu``'s, so each counterpart is easy
to find:

  - ``frontend.mel``        log-mel spectrogram (``torch.fft``)
  - ``model.whisper``       encoder / decoder (f32 or bf16, int8 dispatch)
  - ``model.load``          ``init_params``, safetensors, ``params_from_numpy``
  - ``model.serialize``     pre-quantized params files (``save_params``,
                            ``load_params_file``), byte-equal to the JAX
                            package's
  - ``model.gguf``          the GGUF q8_0 checkpoint reader
  - ``model.quant``         ``quantize_decoder`` / ``quantize_encoder``
  - ``ops.sample_step``     fused grammar + sampling step (CUDA kernel)
  - ``ops.self_decode``     single-query self-attention decode (CUDA kernel)
  - ``ops.paged_cross``     cross-attention over int8/int4 codes (CUDA kernel)
  - ``ops.flash_encoder``   encoder flash attention (CUDA kernel)
  - ``ops.quant_matmul``    int8 GEMM, w8a16 and w4a16 products (CUDA kernels)
  - ``decode.engine``       ``DecodeEngine`` (temperature ladders, buckets,
                            quantized cross-K/V, the token loop as CUDA graphs)
  - ``decode.speculative``  ``SpeculativeEngine`` (a draft decoder proposes,
                            the target verifies in one chunked forward)
  - ``decode.longform``     ``LongFormDecoder`` (streaming buffer/drain)
  - ``models.whisper``      ``monolingual`` / ``multilingual.Definition``,
                            their checkpoint loader (HF safetensors, GGUF,
                            params files, draft checkpoints) and tokenizer,
                            and ``WhisperModel``
  - ``runtime.transcriber`` ``Transcriber`` (the public entry point)
  - ``runtime.batching``    ``BatchedTranscriber`` (multi-stream serving)
  - ``ops.mel_pallas``      the fused log-mel frontend (CUDA kernel)
  - ``parallel``            device meshes, the params' layout over them
                            (``make_mesh``, ``shard_params``) and data
                            parallelism: ``DecodeEngine`` on dp-sharded
                            params runs one replica per dp position
  - ``tracing``             spans, window regions and the store of the
                            program's records (``span``, ``region``,
                            ``snapshot``), and the device report over
                            ``torch.profiler`` (``profile``,
                            ``device_time_report``, ``profiled_device_ms``)
  - ``tools``               ``quantize_checkpoint`` (the offline
                            quantizer), WER, flip rates, the serving soak
  - ``examples``            the six examples, run as
                            ``python -m norma_tpu_torch.examples.<name>``
  - ``audio``, ``runtime.channels``, ``errors``, ``input``  copies of the
                            JAX package's numpy-only modules

The package imports ``torch`` and ``numpy`` only; it never imports ``jax``
or ``norma_tpu`` (``norma_tpu/__init__.py`` imports jax).  CUDA kernels are
compiled with ``nvcc`` at first use into ``build/norma_tpu_torch/``
(``ops/_build.py``); on CPU tensors each kernel wrapper runs its plain
PyTorch version instead.
"""

from . import audio, eval, input, models, parallel, tracing
from .errors import (
    NormaError,
    NoStreamRunning,
    StartError,
    StopError,
    TranscriberDown,
    TranscriberRunning,
)
from .runtime import JoinHandle, StringReceiver, Transcriber, TranscriberHandle
from .runtime.batching import BatchedTranscriber

__version__ = "0.1.0"

__all__ = [
    "audio",
    "eval",
    "input",
    "models",
    "parallel",
    "tracing",
    "BatchedTranscriber",
    "Transcriber",
    "TranscriberHandle",
    "JoinHandle",
    "StringReceiver",
    "NormaError",
    "StartError",
    "StopError",
    "TranscriberDown",
    "TranscriberRunning",
    "NoStreamRunning",
    "__version__",
]
