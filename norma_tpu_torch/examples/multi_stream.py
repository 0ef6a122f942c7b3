"""Serve many WAV files concurrently on one card (continuous batching).

Usage: python -m norma_tpu_torch.examples.multi_stream a.wav b.wav ... [--ckpt DIR]

Each file becomes one stream; the BatchedTranscriber pads the ready set
into one batched window per decode round, so 8 streams cost little more
than one.
"""

import sys
import threading

from norma_tpu_torch import BatchedTranscriber
from norma_tpu_torch.audio.sources import FileSource
from norma_tpu_torch.input import Settings
from norma_tpu_torch.models import SelectedDevice
from norma_tpu_torch.models.whisper import monolingual


def main() -> None:
    args = sys.argv[1:]
    local_dir = None
    if "--ckpt" in args:
        i = args.index("--ckpt")
        local_dir = args[i + 1]
        del args[i : i + 2]

    definition = monolingual.Definition(
        monolingual.ModelType.DISTIL_LARGE_EN_V3,
        SelectedDevice.auto(),
        local_dir=local_dir,
        timestamps=True,
        # Throughput-first serving knobs (all opt-in; each trades a small
        # accuracy delta, which tools/accuracy_flip_rate measures):
        #   quantize_decoder=True   (int8 decoder weights and head: the w8 kernel)
        #   quantize_encoder=True   (int8 encoder projections: the int8 GEMM kernel)
        #   quantize_cross_kv=True  (int8 cross-K/V: the cross-decode kernel)
        #   quantize_self_kv=True   (int8 self-KV cache; long-mtp knob)
        #   config_overrides={"encoder_attn_impl": "jax_flash"}
        #                           (the flash encoder kernel; the hook for
        #                           every WhisperConfig-level knob)
    )
    model = definition.blocking_try_to_model()

    bt = BatchedTranscriber(
        model,
        max_streams=max(len(args), 1),
        # Latency posture: rounds size themselves so the predicted queue
        # wait meets the SLA (metrics()["sla"] shows the live cap), and each
        # stream's first window decodes ~0.4 s after admission instead of
        # after a full chunk period.
        target_p99_ms=800.0,
        first_partial_seconds=0.4,
    )
    # Capture every batch bucket's CUDA graphs the scheduler can dispatch
    # up front, so no live round pays a capture mid-stream.
    bt.warmup()
    handles = [
        (path, bt.blocking_start(Settings(source=FileSource(path))))
        for path in args
    ]

    def reader(path, handle):
        for seg in handle.receiver:
            print(f"{path}: {seg}", flush=True)

    threads = [
        threading.Thread(target=reader, args=(p, h), daemon=True)
        for p, h in handles
    ]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    bt.close()


if __name__ == "__main__":
    main()
