"""Microphone -> DistilMediumEn streaming transcription for 10 seconds.

Mirror of the reference example (``examples/whisper-mic.rs`` there).

Usage: python -m norma_tpu_torch.examples.whisper_mic
"""

import threading
import time

from norma_tpu_torch import NoStreamRunning, Transcriber
from norma_tpu_torch.input import Settings
from norma_tpu_torch.models import SelectedDevice
from norma_tpu_torch.models.whisper import monolingual


def main() -> None:
    definition = monolingual.Definition(
        monolingual.ModelType.DISTIL_MEDIUM_EN,
        SelectedDevice.auto(),  # the first CUDA device if present, else the CPU
    )

    jh, th = Transcriber.blocking_spawn(definition)

    stream = th.blocking_start(Settings())

    def printer() -> None:
        for seg in stream:
            print(seg, flush=True)

    threading.Thread(target=printer, daemon=True).start()

    time.sleep(10.0)
    try:
        th.stop()
    except NoStreamRunning:
        pass  # the stream already ended on its own (mic failure/EOF)
    th.close()

    jh.join()


if __name__ == "__main__":
    main()
