"""Async variant of the streaming example (the reference's tokio-style API:
Transcriber::spawn / handle.start / receiver.recv).

Usage: python -m norma_tpu_torch.examples.async_transcribe
"""

import asyncio

from norma_tpu_torch import NoStreamRunning, Transcriber
from norma_tpu_torch.input import Settings
from norma_tpu_torch.models import SelectedDevice
from norma_tpu_torch.models.whisper import monolingual


async def main() -> None:
    definition = monolingual.Definition(
        monolingual.ModelType.DISTIL_LARGE_EN_V3, SelectedDevice.auto()
    )

    jh, th = await Transcriber.spawn(definition)
    stream = await th.start(Settings())

    async def printer() -> None:
        while (seg := await stream.recv()) is not None:
            print(seg, flush=True)

    task = asyncio.create_task(printer())
    await asyncio.sleep(10)
    try:
        th.stop()
    except NoStreamRunning:
        pass  # the stream already ended on its own (mic failure/EOF)
    th.close()
    await task
    jh.join()


if __name__ == "__main__":
    asyncio.run(main())
