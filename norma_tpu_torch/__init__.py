"""norma-tpu's Whisper streaming path in PyTorch, with hand-written Hopper kernels.

A port of the JAX package ``norma_tpu`` (which stays the reference).  Module
paths and function names mirror ``norma_tpu``'s, so each counterpart is easy
to find:

  - ``frontend.mel``        log-mel spectrogram (``torch.fft``)
  - ``model.whisper``       encoder / decoder (exact f32 or bf16 path)
  - ``model.load``          ``init_params``, safetensors, ``params_from_numpy``
  - ``ops.sample_step``     fused grammar + sampling step (CUDA kernel)
  - ``ops.self_decode``     single-query self-attention decode (CUDA kernel)
  - ``decode.engine``       ``DecodeEngine`` (temperature ladders, buckets)
  - ``decode.longform``     ``LongFormDecoder`` (streaming buffer/drain)
  - ``models.whisper``      ``WhisperModel`` (the user-facing entry point)

The package imports ``torch`` and ``numpy`` only; it never imports ``jax``
or ``norma_tpu`` (``norma_tpu/__init__.py`` imports jax).  CUDA kernels are
compiled with ``nvcc`` at first use into ``build/norma_tpu_torch/``
(``ops/_build.py``); on CPU tensors each kernel wrapper runs its plain
PyTorch version instead.
"""

__version__ = "0.1.0"
