"""Quality-first serving: large-v3 with speculative decoding.

``draft="auto"`` pairs the official distil-large-v3 checkpoint as a draft:
the 2-layer draft proposes ``spec_k`` tokens per round and the 32-layer
target verifies them in ONE chunked forward, committing up to ``spec_k+1``
tokens per pass over the target's weights, with output token-identical to
plain large-v3 greedy decoding.

The engine's ``last_tokens_per_round`` telemetry is the live acceptance
signal: near 1.0 means the draft rarely agrees with the target (lower
``spec_k``); near ``spec_k + 1`` means you can raise it.  Passing
``spec_k="auto"`` instead closes that loop in the engine: K walks a
2/4/8/12 ladder from the EMA-smoothed acceptance ratio.

Usage: python -m norma_tpu_torch.examples.speculative_serving
"""

import threading
import time

import torch

from norma_tpu_torch import NoStreamRunning, Transcriber
from norma_tpu_torch.input import Settings
from norma_tpu_torch.models import SelectedDevice
from norma_tpu_torch.models.whisper import multilingual


def main() -> None:
    definition = multilingual.Definition(
        multilingual.ModelType.LARGE_V3,
        SelectedDevice.auto(),
        dtype=torch.bfloat16,
        draft="auto",  # distil-whisper/distil-large-v3 proposes
        spec_k="auto",  # tunes K from the acceptance telemetry
    )

    jh, th = Transcriber.blocking_spawn(definition)
    stream = th.blocking_start(Settings())  # default microphone

    threading.Thread(
        target=lambda: [print(seg, flush=True) for seg in stream],
        daemon=True,
    ).start()

    time.sleep(15)
    try:
        th.stop()
    except NoStreamRunning:
        pass  # the stream already ended on its own (mic failure/EOF)
    th.close()
    jh.join()


if __name__ == "__main__":
    main()
