"""Transcribe a WAV file with streamed partial output.

Usage: python -m norma_tpu_torch.examples.file_transcribe audio.wav [checkpoint_dir]

``checkpoint_dir`` holds config.json / tokenizer.json / model.safetensors
(an offline HF checkpoint, or a params file written by
``python -m norma_tpu_torch.tools.quantize_checkpoint``); without it the
example downloads distil-large-v3 from the HF hub.
"""

import sys

from norma_tpu_torch import Transcriber
from norma_tpu_torch.audio.sources import FileSource
from norma_tpu_torch.input import Settings
from norma_tpu_torch.models import SelectedDevice
from norma_tpu_torch.models.whisper import monolingual


def main() -> None:
    path = sys.argv[1]
    local_dir = sys.argv[2] if len(sys.argv) > 2 else None

    definition = monolingual.Definition(
        monolingual.ModelType.DISTIL_LARGE_EN_V3,
        SelectedDevice.auto(),
        local_dir=local_dir,
    )
    definition.set_responsiveness(10.0)  # decode every 10 s of audio

    jh, th = Transcriber.blocking_spawn(definition)
    stream = th.blocking_start(Settings(source=FileSource(path)))

    for seg in stream:
        print(seg, flush=True)

    th.close()
    jh.join()


if __name__ == "__main__":
    main()
