"""The port's accuracy and serving tools, each run as
``python -m norma_tpu_torch.tools.<name>``:

  - ``eval_wer``: corpus WER over a manifest or a LibriSpeech directory;
  - ``accuracy_flip_rate``: greedy-token flip rates of the quant tiers
    against the bf16 engine, on seeded and on fitted weights;
  - ``soak_serving``: minutes of real-time streams through
    ``BatchedTranscriber`` with liveness, loss, memory and latency checks;
  - ``quantize_checkpoint``: an HF or GGUF checkpoint -> a pre-quantized
    params file, byte-equal to the JAX package's tool (host only);
  - ``make_golden``: golden tokens and text from a real checkpoint;
  - ``coverage_gate``: line coverage of ``norma_tpu_torch/`` over a pytest
    run, failing below a bar;

and ``first_network_run.sh`` (run as a script; ``--dry-run`` offline):
the runbook for a machine with egress -- downloads, goldens, the
quantizer and WER.
"""
