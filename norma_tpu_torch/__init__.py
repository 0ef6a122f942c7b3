"""norma-tpu's Whisper streaming path in PyTorch, with hand-written Hopper kernels.

A port of the JAX package ``norma_tpu`` (which stays the reference).  Module
paths and function names mirror ``norma_tpu``'s, so each counterpart is easy
to find:

  - ``frontend.mel``        log-mel spectrogram (``torch.fft``)
  - ``model.whisper``       encoder / decoder (f32 or bf16, int8 dispatch)
  - ``model.load``          ``init_params``, safetensors, ``params_from_numpy``
  - ``model.quant``         ``quantize_decoder`` / ``quantize_encoder``
  - ``ops.sample_step``     fused grammar + sampling step (CUDA kernel)
  - ``ops.self_decode``     single-query self-attention decode (CUDA kernel)
  - ``ops.paged_cross``     cross-attention over int8/int4 codes (CUDA kernel)
  - ``ops.flash_encoder``   encoder flash attention (CUDA kernel)
  - ``ops.quant_matmul``    int8 GEMM (CUDA kernel) and the w8a16 product
  - ``decode.engine``       ``DecodeEngine`` (temperature ladders, buckets,
                            quantized cross-K/V)
  - ``decode.longform``     ``LongFormDecoder`` (streaming buffer/drain)
  - ``models.whisper``      ``WhisperModel`` (the user-facing entry point)
  - ``runtime.batching``    ``BatchedTranscriber`` (multi-stream serving)
  - ``audio``, ``runtime.channels``, ``errors``, ``input``  copies of the
                            JAX package's numpy-only modules

The package imports ``torch`` and ``numpy`` only; it never imports ``jax``
or ``norma_tpu`` (``norma_tpu/__init__.py`` imports jax).  CUDA kernels are
compiled with ``nvcc`` at first use into ``build/norma_tpu_torch/``
(``ops/_build.py``); on CPU tensors each kernel wrapper runs its plain
PyTorch version instead.
"""

__version__ = "0.1.0"
