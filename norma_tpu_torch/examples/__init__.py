"""Runnable examples of the port's public entry points, each the
counterpart of the file of the same name under ``examples/``:

  - ``file_transcribe``     a WAV file, streamed partial output
  - ``async_transcribe``    the asyncio API (``Transcriber.spawn``)
  - ``whisper_mic``         the default microphone for 10 s
  - ``multi_stream``        many WAV files served together (``BatchedTranscriber``)
  - ``speculative_serving`` large-v3 with a distil draft (speculative decoding)
  - ``eval_wer``            corpus WER of a checkpoint over a WAV manifest

Each runs on the card (``SelectedDevice.auto()``: the first CUDA device,
the CPU only where there is none), from the repository root:
``python -m norma_tpu_torch.examples.file_transcribe audio.wav CKPT_DIR``.
"""
